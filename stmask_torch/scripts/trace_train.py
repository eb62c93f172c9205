"""Per-kernel profile of the training step (the counterpart of the JAX
package's ``scripts/trace_train.py``):

    python -m stmask_torch.scripts.trace_train [--batch_size 4] [--bf16]
        [--config STMask_plus_resnet50] [--top 40] [--device cuda|cpu]

Builds the batch of ``scripts/bench_train.py`` (``_common.bench_batch``)
and the step from the flax-like seeded init, times 3 steps after a warm-up
step (CUDA events around the 3), then profiles 3 more and prints the top
kernels in ms a step, and the step's host time split by the step's
``record_function`` ranges (``train_step.forward``, ``.losses``,
``.backward``, ``.update``) on the host clock.  ``--bf16`` profiles the bf16 step.  On the CPU the host
ops' self times stand in for the kernels.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

STEPS = 3


def run(cfg, device, batch_size: int = 4, bf16: bool = False,
        top: int = 40) -> Dict:
    """Time, profile and print; returns {'step_ms', 'rows', 'ranges'}."""
    from ..utils.device import resolve_device
    from ..utils.profiling import (kernel_rows, median_ms, print_top,
                                   profile, range_split)
    from ._common import train_call
    dev = resolve_device(device)
    call = train_call(cfg, dev, batch_size, bf16)

    def steps():
        for _ in range(STEPS):
            call()

    step_ms = median_ms(steps, 1, dev, warmup=0) / STEPS
    print(f'step time: {step_ms:.1f} ms (batch={batch_size}, '
          f'{"bf16" if bf16 else "fp32"})')
    prof = profile(steps, 1, dev, warmup=False)
    ranges = range_split(prof, 'train_step.')
    rows = kernel_rows(prof, dev, ranges=tuple(ranges))
    print_top(rows, STEPS, 'step', top)
    print(f'host split of the step by range ({STEPS} profiled steps, host '
          'clock, profiler on):')
    for name, (ms, n) in sorted(ranges.items(), key=lambda r: -r[1][0]):
        print(f'  {ms / STEPS:9.3f} ms/step  x{n / STEPS:.0f}  {name}')
    return {'step_ms': step_ms, 'rows': rows, 'ranges': ranges}


def main(argv=None) -> int:
    from ..config import get_config
    from ._common import add_device
    p = argparse.ArgumentParser()
    p.add_argument('--batch_size', type=int, default=4)
    p.add_argument('--bf16', action='store_true')
    p.add_argument('--config', default='STMask_plus_resnet50')
    p.add_argument('--top', type=int, default=40)
    add_device(p)
    args = p.parse_args(argv)
    run(get_config(args.config), args.device, args.batch_size, args.bf16,
        args.top)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
