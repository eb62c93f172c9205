"""Backward of the cross-frame correlation: CUDA kernel K3 (fp32 and bf16
entries) and its plain version.

Replaces the XLA transpose of ``stmask_tpu/ops/correlation.py::correlate``
that the JAX package differentiates in training.  ``correlation_bwd``
calls the custom op ``stmask::correlation_bwd``, which dispatches on the
device: CPU tensors take ``correlation_bwd_reference``, CUDA tensors take
the kernel in ``csrc/correlation_bwd.cu`` or raise.  With
``out`` (the forward's output after its leaky ReLU) both apply the
activation's derivative to ``g`` themselves, with JAX's rule: slope 1 where
``out >= 0`` (so at exactly 0), else 0.1.

The bf16 entry takes bf16 x1 and x2 with the fp32 ``g`` and ``out`` of K1's
bf16 entry, whose output is fp32; it sums in fp32 and rounds dx1 and dx2 to
bf16, the type of the JAX package's cotangents of its bf16 features.  Calls
with C a multiple of 8 and x1, x2, dx1 and dx2 16-byte aligned (every
training site) take its fast route (``corr_bwd_fast``: bf16 source rows
staged by ``cp.async``), the others its general route; the two give the
same bits.  The wrapper decides and hands the bf16 entry the route, which
refuses a fast call it cannot take.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .build import CudaKernel, check_cuda, records_grad

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
KERNEL = CudaKernel('correlation_bwd', 'stmask_correlation_bwd', _ARGTYPES)
# the bf16 entry takes the route (1 fast, 0 general) before the stream
KERNEL_BF16 = CudaKernel('correlation_bwd', 'stmask_correlation_bwd_bf16',
                         _ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p])


def corr_bwd_fast(c: int, *ptrs: int) -> bool:
    """Whether a bf16 call takes the fast route: C a multiple of 8 and
    every pointer in ``ptrs`` (x1, x2, dx1 and dx2; byte addresses)
    16-byte aligned."""
    return c % 8 == 0 and all(p % 16 == 0 for p in ptrs)


def correlation_bwd_reference(g: torch.Tensor, x1: torch.Tensor,
                              x2: torch.Tensor, patch_size: int = 11,
                              out: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch gradients (dx1, dx2) [B, H, W, C] of the correlation
    from ``g`` [B, H, W, P^2]: before its activation, or through it when
    ``out`` is given.  bf16 x1 and x2 take the sums in fp32 and round them
    to bf16."""
    if x1.dtype == torch.bfloat16:
        dx1, dx2 = correlation_bwd_reference(
            g.float(), x1.float(), x2.float(), patch_size,
            None if out is None else out.float())
        return dx1.to(x1.dtype), dx2.to(x2.dtype)
    if out is not None:
        g = torch.where(out >= 0, g, g * 0.1)
    b, h, w, c = x1.shape
    r = (patch_size - 1) // 2
    x2p = F.pad(x2, (0, 0, r, r, r, r))
    dx1 = torch.zeros_like(x1)
    dx2p = torch.zeros_like(x2p)
    for dy in range(patch_size):
        for dx in range(patch_size):
            gd = g[..., dy * patch_size + dx, None]
            dx1 = dx1 + gd * x2p[:, dy:dy + h, dx:dx + w, :]
            dx2p[:, dy:dy + h, dx:dx + w, :] += gd * x1
    return dx1 / c, dx2p[:, r:r + h, r:r + w, :] / c


def pixel_stride(t: torch.Tensor) -> Optional[int]:
    """The pixel stride of a [B, H, W, D] tensor whose channels are
    contiguous and whose pixels are evenly spaced (a contiguous tensor, or
    a channel slice of one, as ``torch.cat``'s backward gives), else
    None."""
    _, h, w, d = t.shape
    if t.is_contiguous():
        return d
    s = t.stride(2)
    want = (h * w * s, w * s, s, 1)
    ok = all(st == ws or n == 1
             for st, ws, n in zip(t.stride(), want, t.shape))
    return s if ok and s >= d else None


def correlation_bwd_cuda(g: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                         patch_size: int = 11,
                         out: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3 on CUDA tensors (shapes as above): x1, x2 and ``out``
    contiguous, ``g`` with evenly spaced pixels (``pixel_stride``); x1 and
    x2 fp32 or bf16, ``g`` and ``out`` fp32."""
    dt = x1.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f'correlation_bwd_cuda: {dt} is neither float32 nor '
                        'bfloat16')
    check_cuda('correlation_bwd_cuda', x1, x2, dtype=dt)
    if out is not None:
        check_cuda('correlation_bwd_cuda', out, dtype=torch.float32)
    check_cuda('correlation_bwd_cuda', g, dtype=torch.float32,
               contiguous=False)
    if any(t.device != x1.device for t in (g, out) if t is not None):
        raise ValueError('correlation_bwd_cuda: expected CUDA tensors on one '
                         'device')
    if x1.dim() != 4 or x1.shape != x2.shape:
        raise ValueError(f'correlation_bwd_cuda: x1 {tuple(x1.shape)} and x2 '
                         f'{tuple(x2.shape)} must be equal [B, H, W, C]')
    if patch_size not in range(1, 32, 2):
        raise ValueError(f'correlation_bwd_cuda: patch {patch_size} is not '
                         'odd in 1..31')
    b, h, w, c = x1.shape
    want = (b, h, w, patch_size * patch_size)
    for name, t in (('g', g), ('out', out)):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f'correlation_bwd_cuda: {name} '
                             f'{tuple(t.shape)} is not {list(want)}')
    ldg = pixel_stride(g)
    if ldg is None:
        raise ValueError('correlation_bwd_cuda: g needs contiguous channels '
                         f'and evenly spaced pixels, got strides {g.stride()}')
    dx1 = torch.empty_like(x1)
    dx2 = torch.empty_like(x2)
    ptrs = (x1.data_ptr(), x2.data_ptr(), dx1.data_ptr(), dx2.data_ptr())
    args = (g.data_ptr(), None if out is None else out.data_ptr(), *ptrs,
            ldg, b, h, w, c, patch_size)
    stream = torch.cuda.current_stream(x1.device).cuda_stream
    if dt == torch.bfloat16:
        KERNEL_BF16(*args, int(corr_bwd_fast(c, *ptrs)), stream)
    else:
        KERNEL(*args, stream)
    return dx1, dx2


@torch.library.custom_op('stmask::correlation_bwd', mutates_args=(),
                         device_types='cuda')
def _correlation_bwd_op(g: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                        patch_size: int, out: Optional[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    return correlation_bwd_cuda(g, x1, x2, patch_size, out)


@_correlation_bwd_op.register_kernel('cpu')
def _(g, x1, x2, patch_size, out):
    return correlation_bwd_reference(g, x1, x2, patch_size, out)


@_correlation_bwd_op.register_fake
def _(g, x1, x2, patch_size, out):
    return torch.empty_like(x1), torch.empty_like(x2)


def correlation_bwd(g: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                    patch_size: int = 11, out: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    if records_grad(g, x1, x2, out):
        if x1.device.type == 'cpu':
            return correlation_bwd_reference(g, x1, x2, patch_size, out)
        return correlation_bwd_cuda(g, x1, x2, patch_size, out)
    return torch.ops.stmask.correlation_bwd(g, x1, x2, patch_size, out)
