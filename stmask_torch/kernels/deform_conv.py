"""Fused modulated deformable conv (gather, GEMM and bias in one kernel),
fp32 and bf16, and its plain versions.

Replaces ``stmask_tpu/ops/deform_conv.py::deform_conv2d``
(``deform_conv.py:31-89`` with ``ops/sampling.py:48-85``).  ``deform_conv``
calls the custom op ``stmask::deform_conv`` (traced by ``torch.export``),
which dispatches on the device and type: CPU tensors take
``deform_conv_reference`` (fp32: the gather of ``deform_im2col_reference``
contracted with one matmul; bf16: the JAX package's bf16 rounding points),
CUDA tensors take the kernel of their type in ``csrc/deform_conv.cu`` or
raise.  bf16 inputs may come with fp32 offsets (FCB's analytic offsets,
which the JAX package computes in fp32 from bf16 box deltas); they take a
third entry, which samples at the unrounded offsets.  The weight is given
as ``[Cout, kh, kw, Cin]``: a DCN module's OIHW weight in the
channels-last layout, which the kernel reads in place.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import CudaKernel, check_cuda, records_grad
from .deform_im2col import deform_im2col_reference

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
KERNEL = CudaKernel('deform_conv', 'stmask_deform_conv', _ARGTYPES)
KERNEL_BF16 = CudaKernel('deform_conv', 'stmask_deform_conv_bf16', _ARGTYPES)
KERNEL_BF16_F32OFF = CudaKernel('deform_conv',
                                'stmask_deform_conv_bf16_f32off', _ARGTYPES)


def _rb(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (round to nearest even), kept as fp32."""
    return t.to(torch.bfloat16).float()


def deform_cols_bf16(x: torch.Tensor, offset: torch.Tensor,
                     mask: Optional[torch.Tensor], kh: int, kw: int,
                     stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """The bf16 gather as the JAX package computes it in bf16
    (``deform_conv.py:64-81``, ``sampling.py:48-85``), held in fp32:
    coordinates are the fp32 base grid plus the bf16 offset; the block of
    2x2 corners starts at ``clip(floor(p), 0, size - 2)`` with hat weights
    ``clip(1 - |p - corner|, 0, 1)`` (zero for every corner off the image);
    each weight ``wy * wx`` is rounded to bf16, each weight * sample
    product to bf16, the four products are summed in fp32 and rounded, and
    the modulation multiply is rounded.  Returns [B*Ho*Wo, K*Cin] in (tap,
    channel) order."""
    b, h, w, cin = x.shape
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
    off = offset.float().reshape(b, ho, wo, k, 2)
    ys = (base_y + off[..., 0]).reshape(b, -1)
    xs = (base_x + off[..., 1]).reshape(b, -1)
    y0 = torch.clamp(torch.floor(ys), 0, max(h - 2, 0))
    x0 = torch.clamp(torch.floor(xs), 0, max(w - 2, 0))
    flat = x.float().reshape(b, h * w, cin)
    total = 0.0
    for dy in range(min(2, h)):
        wy = torch.clamp(1.0 - torch.abs(ys - (y0 + dy)), 0, 1)
        for dx in range(min(2, w)):
            wx = torch.clamp(1.0 - torch.abs(xs - (x0 + dx)), 0, 1)
            idx = ((y0 + dy) * w + (x0 + dx)).long()
            vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, cin))
            total = total + _rb(vals * _rb(wy * wx)[..., None])
    vals = _rb(total).reshape(b, ho, wo, k, cin)
    if mask is not None:
        vals = _rb(vals * mask.float()[..., None])
    return vals.reshape(b * ho * wo, k * cin)


def deform_conv_reference(x: torch.Tensor, offset: torch.Tensor,
                          weight: torch.Tensor, mask: Optional[torch.Tensor],
                          bias: Optional[torch.Tensor], stride: int = 1,
                          dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch deformable conv.

    Args:
      x: [B, H, W, Cin]; offset: [B, Ho, Wo, 2K] with (dy, dx) interleaved
        per tap, taps row-major (K = kh*kw); weight: [Cout, kh, kw, Cin];
        mask: [B, Ho, Wo, K] (already sigmoid-ed) or None; bias: [Cout] or
        None.  All fp32, or all bf16 (the offset bf16 or fp32).
    Returns:
      [B, Ho, Wo, Cout] in x's type.  In bf16 the product sums in fp32, is
      rounded to bf16 and then the bias is added in bf16
      (``deform_conv.py:84-88``).
    """
    cout, kh, kw, _ = weight.shape
    b = x.shape[0]
    _, ho, wo, _ = offset.shape
    if x.dtype == torch.bfloat16:
        out = (deform_cols_bf16(x, offset, mask, kh, kw, stride, dilation)
               @ weight.float().reshape(cout, -1).t()).to(torch.bfloat16)
    else:
        out = deform_im2col_reference(x, offset, mask, kh, kw, stride,
                                      dilation) @ weight.reshape(cout, -1).t()
    if bias is not None:
        out = out + bias
    return out.reshape(b, ho, wo, cout)


def _site_stride(t: torch.Tensor, ho: int, wo: int, width: int) -> int:
    """Elements between neighbouring sites of ``t`` [B, Ho, Wo, >= width]
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
    """The fused kernel on CUDA tensors (shapes as above), all fp32 or all
    bf16; a bf16 tensor takes the bf16 kernel, and bf16 with an fp32
    ``offset`` the bf16 kernel that reads fp32 offsets.  ``x``, ``weight``
    and ``bias`` are contiguous (a channels-last OIHW weight permuted to [Cout,
    kh, kw, Cin] is); ``offset`` and ``mask`` may be channel slices of a
    contiguous NHWC tensor (the kernel reads them element by element, so a
    bf16 slice of the 27-channel ``conv_offset_mask`` output needs no
    alignment).  Any input that requires a gradient raises while autograd
    records (``check_cuda``): the kernel's output has no gradient, so the
    training path calls ``ops.deform_conv.deform_conv_window``."""
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f'deform_conv_cuda: {dt} is neither float32 nor '
                        'bfloat16')
    off_dt = offset.dtype
    if off_dt != dt and (dt, off_dt) != (torch.bfloat16, torch.float32):
        raise TypeError(f'deform_conv_cuda: {off_dt} offsets with {dt} '
                        'inputs (only bf16 inputs take fp32 offsets)')
    check_cuda('deform_conv_cuda', *(t for t in (x, weight, bias)
                                     if t is not None), dtype=dt)
    check_cuda('deform_conv_cuda', x, *(t for t in (mask,) if t is not None),
               dtype=dt, contiguous=False)
    check_cuda('deform_conv_cuda', offset, dtype=off_dt, contiguous=False)
    if offset.device != x.device:
        raise ValueError(f'deform_conv_cuda: expected CUDA tensors on one '
                         f'device, got {offset.device} and {x.device}')
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
    out = torch.empty((b, ho, wo, cout), dtype=dt, device=x.device)
    kernel = (KERNEL if dt == torch.float32 else
              KERNEL_BF16 if off_dt == dt else KERNEL_BF16_F32OFF)
    kernel(x.data_ptr(), offset.data_ptr(),
           None if mask is None else mask.data_ptr(), weight.data_ptr(),
           None if bias is None else bias.data_ptr(), out.data_ptr(),
           b, h, w, cin, ho, wo, cout, kh, kw, stride, dilation, off_ld,
           mask_ld, torch.cuda.current_stream(x.device).cuda_stream)
    return out


@torch.library.custom_op('stmask::deform_conv', mutates_args=(),
                         device_types='cuda')
def _deform_conv_op(x: torch.Tensor, offset: torch.Tensor,
                    weight: torch.Tensor, mask: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], stride: int,
                    dilation: int) -> torch.Tensor:
    return deform_conv_cuda(x, offset, weight, mask, bias, stride, dilation)


@_deform_conv_op.register_kernel('cpu')
def _(x, offset, weight, mask, bias, stride, dilation):
    return deform_conv_reference(x, offset, weight, mask, bias, stride,
                                 dilation)


@_deform_conv_op.register_fake
def _(x, offset, weight, mask, bias, stride, dilation):
    b, ho, wo, _ = offset.shape
    return x.new_empty((b, ho, wo, weight.shape[0]))


def deform_conv(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                mask: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                stride: int = 1, dilation: int = 1) -> torch.Tensor:
    if records_grad(x, offset, weight, mask, bias):
        if x.device.type == 'cpu':
            return deform_conv_reference(x, offset, weight, mask, bias,
                                         stride, dilation)
        return deform_conv_cuda(x, offset, weight, mask, bias, stride,
                                dilation)
    return torch.ops.stmask.deform_conv(x, offset, weight, mask, bias, stride,
                                        dilation)
