"""RoIAlign as two separable-weight contractions (port of
``stmask_tpu/ops/roi_align.py``).

mmcv ``aligned=True`` semantics (half-pixel grid) with the JAX package's
fixed ``sampling_ratio`` (default 2).  Each RoI's sample grid is separable,
so the bilinear pool factorizes as ``out[n] = Wy[n] @ F @ Wx[n]^T``; samples
off the image get zero weight.  Plain PyTorch (two einsums); a kernel waits
until the card's profile asks for one (ROADMAP).
"""

from __future__ import annotations

import torch


def _pooled_weights(lo: torch.Tensor, bin_sz: torch.Tensor, pool_size: int,
                    sampling_ratio: int, size: int) -> torch.Tensor:
    """[..., N, P, size] bilinear weights, bin-averaged over the sample
    grid."""
    s = sampling_ratio
    dev = lo.device
    ii = torch.arange(pool_size, dtype=torch.float32, device=dev)
    tt = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    coords = (lo[..., None, None] - 0.5
              + (ii[:, None] + tt[None, :]) * bin_sz[..., None, None])
    grid = torch.arange(size, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(coords[..., None] - grid), min=0.0)
    return w.mean(dim=-2)


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              pool_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """features [..., H, W, C]; boxes [..., N, 4] unnormalized (x1, y1, x2,
    y2) in feature coords -> [..., N, P, P, C] in the features' dtype.  The
    leading dims (e.g. a lane axis) are shared: each lane's boxes pool its
    own map.

    As in the JAX package, the weights are rounded to the features' dtype
    and both contractions accumulate in fp32 (the products of two bf16
    values are exact in fp32)."""
    h, w, _ = features.shape[-3:]
    p = pool_size
    x1, y1, x2, y2 = boxes.unbind(dim=-1)
    dt = features.dtype
    wy = _pooled_weights(y1, (y2 - y1) / p, p, sampling_ratio, h)
    wx = _pooled_weights(x1, (x2 - x1) / p, p, sampling_ratio, w)
    wy, wx = wy.to(dt).float(), wx.to(dt).float()
    t = torch.einsum('...nph,...hwc->...npwc', wy, features.float())
    return torch.einsum('...nqw,...npwc->...npqc', wx, t).to(dt)
