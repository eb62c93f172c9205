"""Backward of the cross-frame correlation: CUDA kernel K3 and its plain
version.

Replaces the XLA transpose of ``stmask_tpu/ops/correlation.py::correlate``
that the JAX package differentiates in training.  ``correlation_bwd``
dispatches on the device: CPU tensors take ``correlation_bwd_reference``,
CUDA tensors take the kernel in ``csrc/correlation_bwd.cu`` or raise.  The
upstream gradient ``g`` comes already multiplied by the leaky ReLU's
derivative (``ops.correlation`` does that).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .build import CudaKernel, check_cuda

KERNEL = CudaKernel('correlation_bwd', 'stmask_correlation_bwd',
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p])


def correlation_bwd_reference(g: torch.Tensor, x1: torch.Tensor,
                              x2: torch.Tensor, patch_size: int = 11
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch gradients (dx1, dx2) [B, H, W, C] of the correlation
    before its activation, from ``g`` [B, H, W, P^2]."""
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


def correlation_bwd_cuda(g: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                         patch_size: int = 11
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3 on contiguous fp32 CUDA tensors (shapes as above)."""
    check_cuda('correlation_bwd_cuda', g, x1, x2)
    if x1.dim() != 4 or x1.shape != x2.shape:
        raise ValueError(f'correlation_bwd_cuda: x1 {tuple(x1.shape)} and x2 '
                         f'{tuple(x2.shape)} must be equal [B, H, W, C]')
    b, h, w, c = x1.shape
    if patch_size % 2 != 1 or tuple(g.shape) != (b, h, w,
                                                  patch_size * patch_size):
        raise ValueError(f'correlation_bwd_cuda: g {tuple(g.shape)} is not '
                         f'[{b}, {h}, {w}, P^2] for an odd patch '
                         f'{patch_size}')
    dx1 = torch.empty_like(x1)
    dx2 = torch.empty_like(x2)
    KERNEL(g.data_ptr(), x1.data_ptr(), x2.data_ptr(), dx1.data_ptr(),
           dx2.data_ptr(), b, h, w, c, patch_size,
           torch.cuda.current_stream(x1.device).cuda_stream)
    return dx1, dx2


def correlation_bwd(g: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                    patch_size: int = 11
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    if x1.device.type == 'cpu':
        return correlation_bwd_reference(g, x1, x2, patch_size)
    return correlation_bwd_cuda(g, x1, x2, patch_size)
