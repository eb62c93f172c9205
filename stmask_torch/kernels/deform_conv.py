"""Fused modulated deformable conv (gather, GEMM and bias in one kernel) and
its plain version.

Replaces ``stmask_tpu/ops/deform_conv.py::deform_conv2d``
(``deform_conv.py:31-89`` with ``ops/sampling.py:48-85``).  ``deform_conv``
dispatches on the device: CPU tensors take ``deform_conv_reference`` (the
gather of ``deform_im2col_reference`` contracted with one matmul), CUDA
tensors take the kernel in ``csrc/deform_conv.cu`` or raise.  The weight is
given as ``[Cout, kh, kw, Cin]``: a DCN module's OIHW weight in the
channels-last layout, which the kernel reads in place.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import CudaKernel, check_cuda_f32
from .deform_im2col import deform_im2col_reference

KERNEL = CudaKernel('deform_conv', 'stmask_deform_conv',
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13
                    + [ctypes.c_void_p])


def deform_conv_reference(x: torch.Tensor, offset: torch.Tensor,
                          weight: torch.Tensor, mask: Optional[torch.Tensor],
                          bias: Optional[torch.Tensor], stride: int = 1,
                          dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch deformable conv.

    Args:
      x: [B, H, W, Cin]; offset: [B, Ho, Wo, 2K] with (dy, dx) interleaved
        per tap, taps row-major (K = kh*kw); weight: [Cout, kh, kw, Cin];
        mask: [B, Ho, Wo, K] (already sigmoid-ed) or None; bias: [Cout] or
        None.
    Returns:
      [B, Ho, Wo, Cout].
    """
    cout, kh, kw, _ = weight.shape
    b = x.shape[0]
    _, ho, wo, _ = offset.shape
    out = deform_im2col_reference(x, offset, mask, kh, kw, stride,
                                  dilation) @ weight.reshape(cout, -1).t()
    if bias is not None:
        out = out + bias
    return out.reshape(b, ho, wo, cout)


def _site_stride(t: torch.Tensor, ho: int, wo: int, width: int) -> int:
    """Floats between neighbouring sites of ``t`` [B, Ho, Wo, >= width]
    whose sites are evenly spaced with contiguous channels (as a slice of a
    contiguous NHWC tensor is), else -1."""
    s = t.stride(2)
    if t.stride(3) == 1 and s >= width and t.stride() == (ho * wo * s,
                                                          wo * s, s, 1):
        return s
    return -1


def deform_conv_cuda(x: torch.Tensor, offset: torch.Tensor,
                     weight: torch.Tensor, mask: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], stride: int = 1,
                     dilation: int = 1) -> torch.Tensor:
    """The fused kernel on fp32 CUDA tensors (shapes as above).  ``x``,
    ``weight`` and ``bias`` are contiguous (a channels-last OIHW weight
    permuted to [Cout, kh, kw, Cin] is); ``offset`` and ``mask`` may be
    channel slices of a contiguous NHWC tensor."""
    check_cuda_f32('deform_conv_cuda', *(t for t in (x, weight, bias)
                                         if t is not None))
    check_cuda_f32('deform_conv_cuda', x, *(t for t in (offset, mask)
                                            if t is not None),
                   contiguous=False)
    b, h, w, cin = x.shape
    if weight.dim() != 4 or weight.shape[3] != cin:
        raise ValueError(f'deform_conv_cuda: weight {tuple(weight.shape)} '
                         f'is not [Cout, kh, kw, {cin}]')
    cout, kh, kw, _ = weight.shape
    k = kh * kw
    if offset.dim() != 4 or offset.shape[0] != b or offset.shape[3] != 2 * k:
        raise ValueError(f'deform_conv_cuda: offset {tuple(offset.shape)} '
                         f'is not [{b}, Ho, Wo, {2 * k}]')
    _, ho, wo, _ = offset.shape
    if mask is not None and tuple(mask.shape) != (b, ho, wo, k):
        raise ValueError(f'deform_conv_cuda: mask {tuple(mask.shape)} is '
                         f'not {(b, ho, wo, k)}')
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f'deform_conv_cuda: bias {tuple(bias.shape)} is '
                         f'not ({cout},)')
    off_ld = _site_stride(offset, ho, wo, 2 * k)
    if off_ld < 0:
        offset = offset.contiguous()
        off_ld = 2 * k
    mask_ld = 0
    if mask is not None:
        mask_ld = _site_stride(mask, ho, wo, k)
        if mask_ld < 0:
            mask = mask.contiguous()
            mask_ld = k
    out = torch.empty((b, ho, wo, cout), dtype=torch.float32,
                      device=x.device)
    KERNEL(x.data_ptr(), offset.data_ptr(),
           None if mask is None else mask.data_ptr(), weight.data_ptr(),
           None if bias is None else bias.data_ptr(), out.data_ptr(),
           b, h, w, cin, ho, wo, cout, kh, kw, stride, dilation, off_ld,
           mask_ld, torch.cuda.current_stream(x.device).cuda_stream)
    return out


def deform_conv(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                mask: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                stride: int = 1, dilation: int = 1) -> torch.Tensor:
    if x.device.type == 'cpu':
        return deform_conv_reference(x, offset, weight, mask, bias, stride,
                                     dilation)
    return deform_conv_cuda(x, offset, weight, mask, bias, stride, dilation)
