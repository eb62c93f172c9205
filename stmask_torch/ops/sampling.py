"""Zero-padded bilinear sampling (port of ``stmask_tpu/ops/sampling.py``).

The plain PyTorch form of the gather inside the deformable conv: the same
result as ``bilinear_sample_block`` (each corner outside the image weighs
zero), written as four corner gathers.  On the card the deformable conv
runs the fused kernel (``kernels/deform_conv.py``) instead.
"""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` [B, H, W, C] at float coords ``ys``, ``xs`` [B, ...];
    returns [B, ..., C]."""
    b, h, w, c = img.shape
    out_shape = ys.shape
    ys = ys.reshape(b, -1)
    xs = xs.reshape(b, -1)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1
    y0i = y0.long()
    x0i = x0.long()
    flat = img.reshape(b, h * w, c)

    def corner(yi, xi, wgt):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals * (wgt * valid)[..., None]

    out = (corner(y0i, x0i, wy0 * wx0)
           + corner(y0i, x0i + 1, wy0 * wx1)
           + corner(y0i + 1, x0i, wy1 * wx0)
           + corner(y0i + 1, x0i + 1, wy1 * wx1))
    return out.reshape(*out_shape, c)
