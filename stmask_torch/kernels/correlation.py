"""Cross-frame local correlation: CUDA kernel K1 and its plain version.

Replaces ``stmask_tpu/kernels/correlation_pallas.py::correlate_pallas``.
``correlate`` dispatches on the tensors' device: CPU tensors take
``correlate_reference`` (the translation of ``ops/correlation.py:40-53``),
CUDA tensors take the kernel in ``csrc/correlation.cu`` or raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import CudaKernel, check_cuda_f32

KERNEL = CudaKernel('correlation', 'stmask_correlation',
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p])


def correlate_reference(x1: torch.Tensor, x2: torch.Tensor,
                        patch_size: int = 11,
                        apply_activation: bool = True) -> torch.Tensor:
    """Plain PyTorch correlation of two NHWC maps -> [B, H, W, P^2]."""
    b, h, w, c = x1.shape
    r = (patch_size - 1) // 2
    x2p = F.pad(x2, (0, 0, r, r, r, r))
    outs = [(x1 * x2p[:, dy:dy + h, dx:dx + w, :]).sum(dim=-1)
            for dy in range(patch_size) for dx in range(patch_size)]
    out = torch.stack(outs, dim=-1) / c
    if apply_activation:
        out = F.leaky_relu(out, 0.1)
    return out


def correlate_cuda(x1: torch.Tensor, x2: torch.Tensor, patch_size: int = 11,
                   apply_activation: bool = True) -> torch.Tensor:
    """Kernel K1 on contiguous fp32 CUDA tensors [B, H, W, C]."""
    check_cuda_f32('correlate_cuda', x1, x2)
    if x1.dim() != 4 or x1.shape != x2.shape:
        raise ValueError(f'correlate_cuda: x1 {tuple(x1.shape)} and x2 '
                         f'{tuple(x2.shape)} must be equal [B, H, W, C]')
    if patch_size not in range(1, 32, 2):
        raise ValueError(f'correlate_cuda: patch {patch_size} is not odd '
                         'in 1..31')
    b, h, w, c = x1.shape
    out = torch.empty((b, h, w, patch_size * patch_size),
                      dtype=torch.float32, device=x1.device)
    KERNEL(x1.data_ptr(), x2.data_ptr(), out.data_ptr(), b, h, w, c,
           patch_size, int(apply_activation),
           torch.cuda.current_stream(x1.device).cuda_stream)
    return out


def correlate(x1: torch.Tensor, x2: torch.Tensor, patch_size: int = 11,
              apply_activation: bool = True) -> torch.Tensor:
    if x1.device.type == 'cpu':
        return correlate_reference(x1, x2, patch_size, apply_activation)
    return correlate_cuda(x1, x2, patch_size, apply_activation)
