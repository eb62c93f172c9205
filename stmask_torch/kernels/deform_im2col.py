"""Modulated deformable gather (im2col): CUDA kernel K2 and its plain
version.

Replaces the gather of ``stmask_tpu/ops/deform_conv.py::deform_conv2d``
(``deform_conv.py:50-84`` with ``ops/sampling.py:48-85``):
``deform_im2col_cuda`` launches the kernel in ``csrc/deform_im2col.cu``,
``deform_im2col_reference`` is its plain version.  The main path runs the
fused ``deform_conv`` instead, and the DCN backward ``deform_wgrad`` (the
gather fused into the weight-gradient product), so K2 launches on no path.
It stays as the yardstick that both fused kernels are timed against
(K2 + matmul is the route each replaced), and its plain version is theirs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ops.sampling import bilinear_sample
from .build import CudaKernel, check_cuda

KERNEL = CudaKernel('deform_im2col', 'stmask_deform_im2col',
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                    + [ctypes.c_void_p])


def deform_im2col_reference(x: torch.Tensor, offset: torch.Tensor,
                            mask: Optional[torch.Tensor], kh: int, kw: int,
                            stride: int = 1, dilation: int = 1
                            ) -> torch.Tensor:
    """Plain PyTorch gather.

    Args:
      x: [B, H, W, Cin]; offset: [B, Ho, Wo, 2K] with (dy, dx) interleaved
        per tap, taps row-major; mask: [B, Ho, Wo, K] (already sigmoid-ed)
        or None.
    Returns:
      cols [B*Ho*Wo, K*Cin] in (tap, channel) order.
    """
    b, _, _, cin = x.shape
    _, ho, wo, _ = offset.shape
    k = kh * kw
    pad_h = (kh - 1) // 2 * dilation
    pad_w = (kw - 1) // 2 * dilation
    f32 = dict(dtype=torch.float32, device=x.device)
    oy = torch.arange(ho, **f32) * stride - pad_h
    ox = torch.arange(wo, **f32) * stride - pad_w
    ky = torch.arange(kh, **f32) * dilation
    kx = torch.arange(kw, **f32) * dilation
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
        ho, wo, kh, kw).reshape(ho, wo, k)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
        ho, wo, kh, kw).reshape(ho, wo, k)
    off = offset.reshape(b, ho, wo, k, 2)
    vals = bilinear_sample(x, base_y + off[..., 0], base_x + off[..., 1])
    if mask is not None:
        vals = vals * mask[..., None]
    return vals.reshape(b * ho * wo, k * cin)


def deform_im2col_cuda(x: torch.Tensor, offset: torch.Tensor,
                       mask: Optional[torch.Tensor], kh: int, kw: int,
                       stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """Kernel K2 on contiguous fp32 CUDA tensors (shapes as above)."""
    tensors = (x, offset) if mask is None else (x, offset, mask)
    check_cuda('deform_im2col_cuda', *tensors)
    b, h, w, cin = x.shape
    k = kh * kw
    if offset.dim() != 4 or offset.shape[0] != b or offset.shape[3] != 2 * k:
        raise ValueError(f'deform_im2col_cuda: offset {tuple(offset.shape)} '
                         f'is not [{b}, Ho, Wo, {2 * k}]')
    _, ho, wo, _ = offset.shape
    if mask is not None and tuple(mask.shape) != (b, ho, wo, k):
        raise ValueError(f'deform_im2col_cuda: mask {tuple(mask.shape)} is '
                         f'not {(b, ho, wo, k)}')
    cols = torch.empty((b * ho * wo, k * cin), dtype=torch.float32,
                       device=x.device)
    KERNEL(x.data_ptr(), offset.data_ptr(),
           None if mask is None else mask.data_ptr(), cols.data_ptr(),
           b, h, w, cin, ho, wo, kh, kw, stride, dilation,
           torch.cuda.current_stream(x.device).cuda_stream)
    return cols

