"""Time the deformable conv at the flagship's 7 DCN sites (the counterpart
of the JAX package's ``scripts/bench_dcn.py``):

    python -m stmask_torch.scripts.bench_dcn [--dtype bf16|f32]
        [--repeats 30] [--chain 50] [--radius 2] [--device cuda|cpu]

Per backbone DCN site of ``STMask_plus_resnet50`` at 384x640 (one frame,
Cin = Cout, 3x3, a bias, the modulation), three things:

* ``conv``: the dense conv of the same shape (cuDNN on the card), the
  floor the site would cost without the gather;
* ``exact``: ``ops/deform_conv.py::deform_conv2d``, the fused deformable
  conv kernel on the card (its plain version on the CPU);
* ``window``: ``deform_conv_window`` (the offsets clamped to +-radius, then
  the same kernel).

Each is timed over ``--chain`` calls back to back between two CUDA events,
median of ``--repeats``, in ms a call.  The offsets are N(0, 1) clipped to
+-radius, so the two deformable forms sample the same points; the max
|exact - window| is printed beside the times.
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

# (name, h, w, cin, stride) of every DCN conv2 of STMask_plus_resnet50 at
# 384x640 (layers (3, 4, 6, 3), dcn_layers (0, 4, 6, 3), dcn_interval 2)
SITES = [
    ('s2b0', 96, 160, 128, 2),
    ('s2b2', 48, 80, 128, 1),
    ('s3b0', 48, 80, 256, 2),
    ('s3b2', 24, 40, 256, 1),
    ('s3b4', 24, 40, 256, 1),
    ('s4b0', 24, 40, 512, 2),
    ('s4b2', 12, 20, 512, 1),
]


def site_inputs(h: int, w: int, cin: int, stride: int, radius: int,
                dtype: torch.dtype, dev, rng):
    """x, offsets, mask, the HWIO weight and the bias of one site."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=dev, dtype=dtype)
    x = t(rng.randn(1, h, w, cin))
    off = t(np.clip(rng.randn(1, ho, wo, 18), -radius, radius))
    mask = t(rng.rand(1, ho, wo, 9))
    wt = t(rng.randn(3, 3, cin, cin) * 0.05)
    bias = t(rng.randn(cin) * 0.1)
    return x, off, mask, wt, bias


@torch.inference_mode()
def run(device, dtype: str = 'bf16', repeats: int = 30, chain: int = 50,
        radius: int = 2, sites=SITES) -> List[Dict]:
    """Print and return one row a site: {'site', 'conv', 'exact', 'window'
    (ms a call), 'max_diff'}."""
    import torch.nn.functional as F

    from ..ops.deform_conv import deform_conv2d, deform_conv_window
    from ..utils.device import resolve_device
    from ..utils.profiling import median_ms
    dev = resolve_device(device)
    dt = torch.bfloat16 if dtype == 'bf16' else torch.float32
    print(f'device={dev} dtype={dtype}', flush=True)
    rng = np.random.RandomState(0)
    totals = {'conv': 0.0, 'exact': 0.0, 'window': 0.0}
    rows, max_diff = [], 0.0
    for name, h, w, cin, stride in sites:
        x, off, mask, wt, bias = site_inputs(h, w, cin, stride, radius, dt,
                                             dev, rng)
        xc = x.permute(0, 3, 1, 2)                  # channels-last NCHW
        wc = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        w_k = wt.permute(3, 0, 1, 2).contiguous()   # the kernel's layout

        def conv():
            return F.conv2d(xc, wc, bias, stride, 1)

        def exact():
            return deform_conv2d(x, off, wt, mask, bias, stride)

        def window():
            return deform_conv_window(x, off, w_k, mask, bias, stride, 1,
                                      radius)

        row = {'site': name, 'shape': (h, w, cin, stride)}
        for key, fn in (('conv', conv), ('exact', exact),
                        ('window', window)):
            row[key] = median_ms(lambda: [fn() for _ in range(chain)],
                                 repeats, dev) / chain
            totals[key] += row[key]
        row['max_diff'] = float((exact().float() - window().float()).abs()
                                .max())
        max_diff = max(max_diff, row['max_diff'])
        rows.append(row)
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        print(f'{name:5s} [{ho:3d}x{wo:3d}x{cin:3d} s{stride}] '
              + ' '.join(f'{k}={row[k]:7.3f}ms' for k in totals)
              + f' | exact-vs-window maxdiff={row["max_diff"]:.4f}',
              flush=True)
    print('totals: ' + ' '.join(f'{k}={v:7.3f}ms' for k, v in totals.items()))
    print(f'max |exact - window| across sites: {max_diff:.5f}')
    return rows


def main(argv=None) -> int:
    from ._common import add_device
    ap = argparse.ArgumentParser()
    ap.add_argument('--dtype', default='bf16', choices=['bf16', 'f32'])
    ap.add_argument('--repeats', type=int, default=30)
    ap.add_argument('--chain', type=int, default=50,
                    help='calls timed back to back between two events')
    ap.add_argument('--radius', type=int, default=2)
    add_device(ap)
    args = ap.parse_args(argv)
    run(args.device, args.dtype, args.repeats, args.chain, args.radius)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
