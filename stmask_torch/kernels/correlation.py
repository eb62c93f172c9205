"""Cross-frame local correlation: CUDA kernel K1 (fp32 and bf16 inputs) and
its plain versions.

Replaces ``stmask_tpu/kernels/correlation_pallas.py::correlate_pallas``.
``correlate`` calls the custom op ``stmask::correlate``, which dispatches on
the tensors' device: CPU tensors take ``correlate_reference`` (fp32: the
translation of ``ops/correlation.py:40-53``; bf16: the Pallas kernel's
arithmetic), CUDA tensors take the kernel of their type in
``csrc/correlation.cu`` or raise.  Being an op, it is traced by
``torch.export`` (its fake implementation gives the output's shape) and
called by an exported program.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import CudaKernel, check_cuda, records_grad

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
KERNEL = CudaKernel('correlation', 'stmask_correlation', _ARGTYPES)
KERNEL_BF16 = CudaKernel('correlation', 'stmask_correlation_bf16', _ARGTYPES)


def correlate_reference(x1: torch.Tensor, x2: torch.Tensor,
                        patch_size: int = 11,
                        apply_activation: bool = True) -> torch.Tensor:
    """Plain PyTorch correlation of two NHWC maps -> fp32 [B, H, W, P^2].

    fp32 inputs sum their products in fp32 and divide by C.  bf16 inputs
    follow the Pallas kernel (``correlation_pallas.py:28-30``): each
    product rounded to bf16, the sum in fp32, times 1/C."""
    b, h, w, c = x1.shape
    r = (patch_size - 1) // 2
    bf16 = x1.dtype == torch.bfloat16
    if bf16:
        x1, x2 = x1.float(), x2.float()
    x2p = F.pad(x2, (0, 0, r, r, r, r))
    outs = []
    for dy in range(patch_size):
        for dx in range(patch_size):
            prod = x1 * x2p[:, dy:dy + h, dx:dx + w, :]
            if bf16:
                prod = prod.to(torch.bfloat16).float()
            outs.append(prod.sum(dim=-1))
    out = torch.stack(outs, dim=-1)
    out = out * (1.0 / c) if bf16 else out / c
    if apply_activation:
        out = F.leaky_relu(out, 0.1)
    return out


def correlate_cuda(x1: torch.Tensor, x2: torch.Tensor, patch_size: int = 11,
                   apply_activation: bool = True) -> torch.Tensor:
    """Kernel K1 on contiguous CUDA tensors [B, H, W, C], both fp32 or both
    bf16; the output is fp32."""
    check_cuda('correlate_cuda', x1, x2, dtype=x1.dtype)
    if x1.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'correlate_cuda: {x1.dtype} is neither float32 '
                        'nor bfloat16')
    if x1.dim() != 4 or x1.shape != x2.shape:
        raise ValueError(f'correlate_cuda: x1 {tuple(x1.shape)} and x2 '
                         f'{tuple(x2.shape)} must be equal [B, H, W, C]')
    if patch_size not in range(1, 32, 2):
        raise ValueError(f'correlate_cuda: patch {patch_size} is not odd '
                         'in 1..31')
    b, h, w, c = x1.shape
    out = torch.empty((b, h, w, patch_size * patch_size),
                      dtype=torch.float32, device=x1.device)
    kernel = KERNEL_BF16 if x1.dtype == torch.bfloat16 else KERNEL
    kernel(x1.data_ptr(), x2.data_ptr(), out.data_ptr(), b, h, w, c,
           patch_size, int(apply_activation),
           torch.cuda.current_stream(x1.device).cuda_stream)
    return out


@torch.library.custom_op('stmask::correlate', mutates_args=(),
                         device_types='cuda')
def _correlate_op(x1: torch.Tensor, x2: torch.Tensor, patch_size: int,
                  apply_activation: bool) -> torch.Tensor:
    return correlate_cuda(x1, x2, patch_size, apply_activation)


@_correlate_op.register_kernel('cpu')
def _(x1, x2, patch_size, apply_activation):
    return correlate_reference(x1, x2, patch_size, apply_activation)


@_correlate_op.register_fake
def _(x1, x2, patch_size, apply_activation):
    b, h, w, _ = x1.shape
    return x1.new_empty((b, h, w, patch_size * patch_size),
                        dtype=torch.float32)


def correlate(x1: torch.Tensor, x2: torch.Tensor, patch_size: int = 11,
              apply_activation: bool = True) -> torch.Tensor:
    if records_grad(x1, x2):
        if x1.device.type == 'cpu':
            return correlate_reference(x1, x2, patch_size, apply_activation)
        return correlate_cuda(x1, x2, patch_size, apply_activation)
    return torch.ops.stmask.correlate(x1, x2, patch_size, apply_activation)
