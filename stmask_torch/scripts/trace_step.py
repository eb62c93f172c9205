"""Profile the video step and print its top device kernels (the
counterpart of the JAX package's ``scripts/trace_step.py``):

    python -m stmask_torch.scripts.trace_step [--chunked --streams 8
        --chunk 10] [--config STMask_plus_resnet50] [--device cuda|cpu]

By default it profiles 10 steady frames of ``build_video_step``; with
``--chunked`` 4 chunks of ``build_video_step_batched`` (``--streams``
lockstep streams, ``--chunk`` frames a call), the program the eval CLI
runs.  Both run bf16 weights, as the JAX script does.  It prints the total
device-kernel time a frame, the top 40 kernels by time (share, cumulative
share, count, ms a frame) and the idle shares of the profiled window: the
host's (its busiest thread in no op) and the device's (no kernel running),
both from ``torch.profiler``'s own events.  On the CPU the host ops' self
times stand in for the kernels.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch


def run(cfg, device, chunked: bool = False, streams: int = 8,
        chunk: int = 10, top: int = 40) -> Dict:
    """Profile and print; returns {'rows': [(name, count, us)],
    'n_frames', 'ms_per_frame', 'idle': {...}}."""
    from ..utils.device import resolve_device
    from ..utils.profiling import (idle_shares, kernel_rows, print_top,
                                   profile, sync)
    from ._common import chunk_call, frame_call
    dev = resolve_device(device)
    if chunked:
        call, per_call = chunk_call(cfg, dev, streams, chunk)
        call()
        n_calls = 4
    else:
        call, per_call = frame_call(cfg, dev, torch.bfloat16), 1
        call()
        n_calls = 10
    n_frames = n_calls * per_call

    def run_window():
        for _ in range(n_calls):
            call()
    sync(dev)
    prof = profile(run_window, 1, dev, warmup=False)
    rows = kernel_rows(prof, dev)
    print(f'({n_frames} frames profiled; per-kernel totals below)')
    total = print_top(rows, n_frames, 'frame', top)
    idle = idle_shares(prof, dev)
    print('idle shares of the profiled window ({:.3f} ms): host {:.4f}'
          .format(idle['window_ms'], idle['host_idle'])
          + (f', device {idle["device_idle"]:.4f}' if 'device_idle' in idle
             else ''))
    return {'rows': rows, 'n_frames': n_frames,
            'ms_per_frame': total / n_frames, 'idle': idle}


def main(argv=None) -> int:
    from ..config import get_config
    from ._common import add_device
    ap = argparse.ArgumentParser()
    ap.add_argument('--chunked', action='store_true',
                    help='profile the batched chunk program (what the eval '
                         'CLI runs) instead of the single-frame step')
    ap.add_argument('--streams', type=int, default=8)
    ap.add_argument('--chunk', type=int, default=10)
    ap.add_argument('--config', default='STMask_plus_resnet50',
                    help='preset to profile (e.g. STMask_plus_resnet50_ada '
                         'to see the FCB deformable-alignment cost)')
    add_device(ap)
    args = ap.parse_args(argv)
    run(get_config(args.config), args.device, args.chunked, args.streams,
        args.chunk)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
