"""Backward of the window-clamped deformable gather (col2im): CUDA kernel
K4 and its plain version.

Replaces the custom VJP of ``stmask_tpu/ops/deform_conv.py::
_make_window_gather`` together with the autodiff of the hat weights and the
modulation in ``deform_conv2d_window`` (``deform_conv.py:152-351``).
``deform_col2im`` dispatches on the device: CPU tensors take
``deform_col2im_reference``, CUDA tensors take the kernel in
``csrc/deform_col2im.cu`` or raise.

The offset gradient follows JAX's subgradients of the hat weight
``max(0, 1 - |d - u|)`` at the corner u: -sign(d - u) inside the hat, -1
where d == u (JAX's d|x|/dx is 1 at 0), -0.5 * sign(d - u) where
|d - u| == 1 (``jnp.maximum`` splits a tie), 0 beyond and for a corner
outside the window [-r, r + 1].  It is not DCNv2's floor-based rule: at an
integer offset the two differ (``csrc/deform_col2im.cu`` has the formulas).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .build import CudaKernel, check_cuda_f32

KERNEL = CudaKernel('deform_col2im', 'stmask_deform_col2im',
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                    + [ctypes.c_void_p])


def _hat(d_off: torch.Tensor, u: torch.Tensor, radius: int):
    """Hat weight and JAX's derivative of it for corner ``u``."""
    d = d_off - u.to(d_off.dtype)
    z = 1.0 - torch.abs(d)
    in_win = ((u >= -radius) & (u <= radius + 1)).to(d_off.dtype)
    fac = torch.where(z > 0, 1.0, torch.where(z == 0, 0.5, 0.0))
    h = torch.clamp(z, min=0.0) * in_win
    dh = torch.where(d >= 0, -fac, fac) * in_win
    return h, dh


def deform_col2im_reference(dcols: torch.Tensor, x: torch.Tensor,
                            offset: torch.Tensor,
                            mask: Optional[torch.Tensor], kh: int, kw: int,
                            stride: int = 1, dilation: int = 1,
                            radius: int = 2
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       Optional[torch.Tensor]]:
    """Plain PyTorch (dx, d_offset, d_mask) from ``dcols``.

    Args:
      dcols: [B*Ho*Wo, K*Cin], the gradient of K2's ``cols`` (taps outer,
        channels inner); x: [B, H, W, Cin]; offset: [B, Ho, Wo, 2K], (dy, dx)
        interleaved and already clamped to [-radius, radius]; mask:
        [B, Ho, Wo, K] or None.
    Returns:
      dx [B, H, W, Cin], d_offset [B, Ho, Wo, 2K] (before the clamp's own
      factor), d_mask [B, Ho, Wo, K] or None.
    """
    b, h, w, cin = x.shape
    _, ho, wo, _ = offset.shape
    k = kh * kw
    n = ho * wo * k
    pad_h = (kh - 1) // 2 * dilation
    pad_w = (kw - 1) // 2 * dilation
    dev = x.device
    oy = torch.arange(ho, device=dev) * stride - pad_h
    ox = torch.arange(wo, device=dev) * stride - pad_w
    ky = torch.arange(kh, device=dev) * dilation
    kx = torch.arange(kw, device=dev) * dilation
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
        ho, wo, kh, kw).reshape(1, n)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
        ho, wo, kh, kw).reshape(1, n)
    off = offset.reshape(b, n, 2)
    dy, dxo = off[..., 0], off[..., 1]
    fy, fx = torch.floor(dy).long(), torch.floor(dxo).long()
    m = mask.reshape(b, n) if mask is not None else torch.ones_like(dy)
    dc = dcols.reshape(b, n, cin)
    flat = x.reshape(b, h * w, cin)
    ys = [_hat(dy, fy - 1 + j, radius) + (base_y + fy - 1 + j,)
          for j in range(3)]
    xs = [_hat(dxo, fx - 1 + i, radius) + (base_x + fx - 1 + i,)
          for i in range(3)]
    dx = torch.zeros(b * h * w, cin, dtype=x.dtype, device=dev)
    s_m = torch.zeros_like(dy)
    s_y = torch.zeros_like(dy)
    s_x = torch.zeros_like(dy)
    img0 = (torch.arange(b, device=dev) * (h * w))[:, None]
    for hy, dhy, row in ys:
        for hx, dhx, col in xs:
            inside = (row >= 0) & (row < h) & (col >= 0) & (col < w)
            idx = row.clamp(0, h - 1) * w + col.clamp(0, w - 1)
            xv = torch.gather(flat, 1, idx[..., None].expand(-1, -1, cin))
            s = (dc * xv).sum(dim=-1) * inside
            wgt = hy * hx
            s_m = s_m + wgt * s
            s_y = s_y + dhy * hx * s
            s_x = s_x + hy * dhx * s
            contrib = dc * (m * wgt * inside)[..., None]
            dx.index_add_(0, (idx + img0).reshape(-1),
                          contrib.reshape(-1, cin))
    d_offset = torch.stack([m * s_y, m * s_x], dim=-1).reshape(b, ho, wo,
                                                               2 * k)
    d_mask = s_m.reshape(b, ho, wo, k) if mask is not None else None
    return dx.reshape(b, h, w, cin), d_offset, d_mask


def deform_col2im_cuda(dcols: torch.Tensor, x: torch.Tensor,
                       offset: torch.Tensor, mask: Optional[torch.Tensor],
                       kh: int, kw: int, stride: int = 1, dilation: int = 1,
                       radius: int = 2
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """Kernel K4 on contiguous fp32 CUDA tensors (shapes as above)."""
    tensors = (dcols, x, offset) + (() if mask is None else (mask,))
    check_cuda_f32('deform_col2im_cuda', *tensors)
    b, h, w, cin = x.shape
    k = kh * kw
    if offset.dim() != 4 or offset.shape[0] != b or offset.shape[3] != 2 * k:
        raise ValueError(f'deform_col2im_cuda: offset {tuple(offset.shape)} '
                         f'is not [{b}, Ho, Wo, {2 * k}]')
    _, ho, wo, _ = offset.shape
    if tuple(dcols.shape) != (b * ho * wo, k * cin):
        raise ValueError(f'deform_col2im_cuda: dcols {tuple(dcols.shape)} is '
                         f'not {(b * ho * wo, k * cin)}')
    if mask is not None and tuple(mask.shape) != (b, ho, wo, k):
        raise ValueError(f'deform_col2im_cuda: mask {tuple(mask.shape)} is '
                         f'not {(b, ho, wo, k)}')
    if radius < 1:
        raise ValueError(f'deform_col2im_cuda: radius {radius} < 1')
    dx = torch.zeros_like(x)
    d_offset = torch.empty_like(offset)
    d_mask = None if mask is None else torch.empty_like(mask)
    KERNEL(dcols.data_ptr(), x.data_ptr(), offset.data_ptr(),
           None if mask is None else mask.data_ptr(), dx.data_ptr(),
           d_offset.data_ptr(), None if d_mask is None else d_mask.data_ptr(),
           b, h, w, cin, ho, wo, kh, kw, stride, dilation, radius,
           torch.cuda.current_stream(x.device).cuda_stream)
    return dx, d_offset, d_mask


def deform_col2im(dcols: torch.Tensor, x: torch.Tensor, offset: torch.Tensor,
                  mask: Optional[torch.Tensor], kh: int, kw: int,
                  stride: int = 1, dilation: int = 1, radius: int = 2
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    if x.device.type == 'cpu':
        return deform_col2im_reference(dcols, x, offset, mask, kh, kw, stride,
                                       dilation, radius)
    return deform_col2im_cuda(dcols, x, offset, mask, kh, kw, stride,
                              dilation, radius)
