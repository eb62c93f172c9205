"""Model-FLOP and roofline accounting of the port's headline programs
(the counterpart of the JAX package's ``scripts/mfu.py``):

    python -m stmask_torch.scripts.mfu [--repeats 5] [--skip_train]
        [--skip_eval] [--train_precision both|fp32|bf16] [--batch_size 4]
        [--device cuda|cpu]

Programs:

* the eval chunk as the eval CLI runs it: 8 lockstep streams x 4-frame
  chunks, bf16 weights (``build_video_step_batched``);
* the training step at ``--batch_size`` clips (the batch of the JAX
  package's ``scripts/bench_train.py``), fp32 and bf16.

FLOPs come from shapes (``utils/flops.py``: ATen's convolutions and matrix
products, and each hand-written kernel's op by its own formula), so the
count is the same whether the card's kernels or their plain versions run.
Bytes are the counted ops' inputs read once and outputs written once: a
floor on the traffic of the counted work, not of the whole program.  The
time is the median of ``--repeats`` calls, each between CUDA events after
a warm-up.  Shares are against the published H100 SXM peaks at 700 W, the
peak of the program's arithmetic: bf16 989 TFLOP/s, fp32 67 TFLOP/s (the
fp32 programs run with TF32 off), HBM 3.35 TB/s; ``nvidia-smi``'s name and
power limit are printed beside them.  On the CPU the rows carry the counts
and host times only.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import torch

EVAL_LANES, EVAL_CHUNK = 8, 4


def report(name: str, count, ms: float, precision: str, device,
           frames_per_call: Optional[int] = None) -> Dict:
    """One program's row: the count, the time and, on a CUDA device, the
    shares of the peaks of ``precision`` ('bf16' or 'fp32')."""
    from ..utils.flops import PEAK_BYTES_PER_S, PEAK_FLOPS
    peak = PEAK_FLOPS[precision]
    ai = count.flops / max(count.bytes, 1)
    ridge = peak / PEAK_BYTES_PER_S
    row = {'program': name, 'ms_per_call': ms,
           'gflops_per_call': count.flops / 1e9,
           'bytes_per_call_mb': count.bytes / 1e6,
           'bytes_are': 'counted ops: inputs read once, outputs written once',
           'arith_intensity': ai, 'ridge_flop_per_byte': ridge,
           'bound': 'compute' if ai >= ridge else 'memory',
           'peak_tflops': peak / 1e12}
    if frames_per_call:
        row['gflops_per_frame'] = count.flops / frames_per_call / 1e9
    on_card = torch.device(device).type == 'cuda'
    sec = ms / 1e3
    row.update(
        achieved_tflops=count.flops / sec / 1e12 if on_card else None,
        mfu_pct=100 * count.flops / sec / peak if on_card else None,
        achieved_gbs=count.bytes / sec / 1e9 if on_card else None,
        hbm_pct=(100 * count.bytes / sec / PEAK_BYTES_PER_S if on_card
                 else None))
    return row


def measure(name: str, call, device, repeats: int, precision: str,
            frames: Optional[int] = None) -> Dict:
    from ..utils import flops
    from ..utils.profiling import median_ms
    _, count = flops.count(call)
    ms = median_ms(call, repeats, device)
    row = report(name, count, ms, precision, device, frames)
    row['gflops_by_op'] = {k: v / 1e9 for k, v in count.flops_by_op.items()}
    return row


def run(cfg, device, repeats: int = 5, skip_eval: bool = False,
        skip_train: bool = False, train_precision: str = 'both',
        batch_size: int = 4, lanes: int = EVAL_LANES,
        chunk: int = EVAL_CHUNK):
    """The rows of the programs asked for, each printed as a JSON line, then
    the table."""
    from ..utils.device import resolve_device
    from ..utils.flops import PEAK_BYTES_PER_S, PEAK_FLOPS
    from ..utils.profiling import nvidia_smi
    from ._common import chunk_call, train_call
    dev = resolve_device(device)
    card = nvidia_smi() if dev.type == 'cuda' else 'none (device cpu)'
    print(f'device: {dev} ({card}); peaks used (H100 SXM, published, '
          f'700 W): {PEAK_FLOPS["bf16"] / 1e12:g} bf16 / '
          f'{PEAK_FLOPS["fp32"] / 1e12:g} fp32 TFLOP/s, '
          f'{PEAK_BYTES_PER_S / 1e9:g} GB/s HBM', flush=True)
    rows = []
    if not skip_eval:
        call, frames = chunk_call(cfg, dev, lanes, chunk)
        rows.append(measure(f'eval chunk ({lanes} streams x {chunk} frames, '
                            'bf16)', call, dev, repeats, 'bf16', frames))
        print(json.dumps(rows[-1]), flush=True)
    if not skip_train:
        for bf16 in (False, True):
            if train_precision != 'both' and \
                    bf16 != (train_precision == 'bf16'):
                continue
            prec = 'bf16' if bf16 else 'fp32'
            rows.append(measure(
                f'train step (batch={batch_size}, {prec})',
                train_call(cfg, dev, batch_size, bf16), dev, repeats, prec,
                2 * batch_size))
            print(json.dumps(rows[-1]), flush=True)

    def f(v, d=2):
        return 'n/a' if v is None else f'{v:.{d}f}'
    print('\nprogram | ms/call | GFLOP/call | GFLOP/frame | TFLOP/s | MFU% | '
          'GB/s | HBM% | FLOP/B | ridge | bound')
    for r in rows:
        print(f"{r['program']} | {f(r['ms_per_call'])} | "
              f"{f(r['gflops_per_call'], 1)} | "
              f"{f(r.get('gflops_per_frame'), 1)} | "
              f"{f(r['achieved_tflops'])} | {f(r['mfu_pct'])} | "
              f"{f(r['achieved_gbs'], 1)} | {f(r['hbm_pct'])} | "
              f"{f(r['arith_intensity'], 1)} | "
              f"{f(r['ridge_flop_per_byte'], 1)} | {r['bound']}")
    return rows


def main(argv=None) -> int:
    from ..config import get_config
    from ._common import add_device
    p = argparse.ArgumentParser()
    p.add_argument('--repeats', type=int, default=5)
    p.add_argument('--skip_train', action='store_true')
    p.add_argument('--skip_eval', action='store_true')
    p.add_argument('--train_precision', default='both',
                   choices=['both', 'fp32', 'bf16'])
    p.add_argument('--batch_size', type=int, default=4,
                   help='training-step clips (the bench_train.py batch)')
    add_device(p)
    args = p.parse_args(argv)
    run(get_config('STMask_plus_resnet50'), args.device, args.repeats,
        args.skip_eval, args.skip_train, args.train_precision,
        args.batch_size)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
