"""Exact greedy NMS over score-sorted candidates: CUDA kernel B5 and its
plain version.

Replaces ``stmask_tpu/ops/nms.py::greedy_nms_mask`` (an XLA ``fori_loop``),
which ``greedy_nms_per_class`` vmaps over the classes; here the classes are
the groups of one launch.  ``greedy_nms_keep`` calls the custom op
``stmask::greedy_nms_keep`` (traced by ``torch.export``), which dispatches
on the tensors' device: CPU tensors take ``greedy_nms_mask_reference`` (the
loop in torch), CUDA tensors the kernel in ``csrc/greedy_nms.cu`` or raise.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel, check_cuda

MAX_K = 1024
KERNEL = CudaKernel('greedy_nms', 'stmask_greedy_nms',
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                    + [ctypes.c_float, ctypes.c_void_p])


def greedy_nms_mask_reference(iou: torch.Tensor, valid: torch.Tensor,
                              thr: float) -> torch.Tensor:
    """keep [G, K] from iou [G, K, K] and valid [G, K]: row i suppresses
    every j > i with ``iou[i, j] > thr`` while i itself is unsuppressed;
    suppression starts as ``~valid`` (``stmask_tpu/ops/nms.py:130-137``)."""
    k = iou.shape[-1]
    later = torch.arange(k, device=iou.device)
    suppressed = ~valid
    for i in range(k):
        newly = (iou[:, i] > thr) & (later > i)
        suppressed = torch.where(suppressed[:, i:i + 1], suppressed,
                                 suppressed | newly)
    return ~suppressed & valid


def greedy_nms_cuda(iou: torch.Tensor, valid: torch.Tensor,
                    thr: float) -> torch.Tensor:
    """Kernel B5 on contiguous CUDA tensors: iou [G, K, K] float32, valid
    [G, K] bool, 1 <= K <= 1024 -> keep [G, K] bool."""
    check_cuda('greedy_nms_cuda', iou)
    check_cuda('greedy_nms_cuda', valid, dtype=torch.bool)
    if iou.device != valid.device:
        raise ValueError('greedy_nms_cuda: iou and valid on different '
                         'devices')
    if iou.dim() != 3 or iou.shape[1] != iou.shape[2] \
            or tuple(valid.shape) != tuple(iou.shape[:2]):
        raise ValueError(f'greedy_nms_cuda: iou {tuple(iou.shape)} must be '
                         f'[G, K, K] and valid {tuple(valid.shape)} [G, K]')
    g, k = valid.shape
    if not 1 <= k <= MAX_K or g < 1:
        raise ValueError(f'greedy_nms_cuda: G {g} and K {k} must be >= 1, '
                         f'K <= {MAX_K}')
    keep = torch.empty((g, k), dtype=torch.bool, device=iou.device)
    KERNEL(iou.data_ptr(), valid.data_ptr(), keep.data_ptr(), g, k,
           float(thr), torch.cuda.current_stream(iou.device).cuda_stream)
    return keep


@torch.library.custom_op('stmask::greedy_nms_keep', mutates_args=(),
                         device_types='cuda')
def _greedy_nms_op(iou: torch.Tensor, valid: torch.Tensor,
                   thr: float) -> torch.Tensor:
    return greedy_nms_cuda(iou, valid, thr)


@_greedy_nms_op.register_kernel('cpu')
def _(iou, valid, thr):
    return greedy_nms_mask_reference(iou, valid, thr)


@_greedy_nms_op.register_fake
def _(iou, valid, thr):
    return valid.new_empty(valid.shape)


def greedy_nms_keep(iou: torch.Tensor, valid: torch.Tensor,
                    thr: float) -> torch.Tensor:
    return torch.ops.stmask.greedy_nms_keep(iou, valid, float(thr))
