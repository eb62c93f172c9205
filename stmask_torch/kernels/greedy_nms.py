"""Exact greedy NMS over score-sorted candidates: CUDA kernel B5 and its
plain version.

Replaces ``stmask_tpu/ops/nms.py::greedy_nms_mask`` (an XLA ``fori_loop``),
which ``greedy_nms_per_class`` vmaps over the classes; here the classes are
the groups of one launch.  Two entries, each a custom op traced by
``torch.export`` that dispatches on the tensors' device (CPU tensors take
the plain version, CUDA tensors the kernel in ``csrc/greedy_nms.cu`` or
raise):

- ``greedy_nms_keep`` (``stmask::greedy_nms_keep``) takes the IoU matrix;
  its plain version is ``greedy_nms_mask_reference``, the loop in torch.
- ``greedy_nms_plus_one_keep`` (``stmask::greedy_nms_plus_one_keep``) takes
  the boxes, ``boxes[idx] * scale``, and forms the Cython +1-pixel IoUs
  (``plus_one_iou``, ``stmask_tpu/ops/nms.py::_plus_one_iou``) in the
  kernel, in the same order of operations: bit for bit the plain version
  ``greedy_nms_mask_reference(plus_one_iou(boxes[idx] * scale), valid,
  thr)``.  ``greedy_nms_per_class`` calls it.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel, check_cuda

MAX_K = 1024
KERNEL = CudaKernel('greedy_nms', 'stmask_greedy_nms',
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                    + [ctypes.c_float, ctypes.c_void_p])
KERNEL_BOXES = CudaKernel('greedy_nms', 'stmask_greedy_nms_boxes',
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                          + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def plus_one_iou(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., K, K] of [..., K, 4] pixel boxes with the Cython
    NMS convention: areas ``(x2 - x1 + 1) * (y2 - y1 + 1)``
    (utils/cython_nms.pyx:31,67-70), in ``stmask_tpu/ops/nms.py:140``'s
    order of operations (the boxes entry's kernel follows it)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    iw = torch.clamp(ix2 - ix1 + 1.0, min=0.0)
    ih = torch.clamp(iy2 - iy1 + 1.0, min=0.0)
    inter = iw * ih
    return inter / (area[..., :, None] + area[..., None, :] - inter)


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


def greedy_nms_plus_one_reference(boxes: torch.Tensor, idx: torch.Tensor,
                                  valid: torch.Tensor, scale: float,
                                  thr: float) -> torch.Tensor:
    """keep [G, K] of the groups' boxes ``boxes[idx] * scale`` (boxes [P,
    4], idx [G, K]): the plain greedy loop over their +1-pixel IoUs."""
    g, k = idx.shape
    bx = boxes[idx.reshape(-1)].reshape(g, k, 4) * scale
    return greedy_nms_mask_reference(plus_one_iou(bx), valid, thr)


def greedy_nms_boxes_cuda(boxes: torch.Tensor, idx: torch.Tensor,
                          valid: torch.Tensor, scale: float,
                          thr: float) -> torch.Tensor:
    """Kernel B5's boxes entry on contiguous CUDA tensors: boxes [P, 4]
    float32, idx [G, K] int64 (rows of boxes), valid [G, K] bool, 1 <= K
    <= 1024 -> keep [G, K] bool."""
    check_cuda('greedy_nms_boxes_cuda', boxes)
    check_cuda('greedy_nms_boxes_cuda', idx, dtype=torch.int64)
    check_cuda('greedy_nms_boxes_cuda', valid, dtype=torch.bool)
    if not boxes.device == idx.device == valid.device:
        raise ValueError('greedy_nms_boxes_cuda: boxes, idx and valid on '
                         'different devices')
    if boxes.dim() != 2 or boxes.shape[1] != 4 or idx.dim() != 2 \
            or tuple(valid.shape) != tuple(idx.shape):
        raise ValueError(f'greedy_nms_boxes_cuda: boxes {tuple(boxes.shape)} '
                         f'must be [P, 4], idx {tuple(idx.shape)} and valid '
                         f'{tuple(valid.shape)} [G, K]')
    g, k = idx.shape
    p = boxes.shape[0]
    if not 1 <= k <= MAX_K or g < 1 or p < 1:
        raise ValueError(f'greedy_nms_boxes_cuda: P {p}, G {g} and K {k} '
                         f'must be >= 1, K <= {MAX_K}')
    keep = torch.empty((g, k), dtype=torch.bool, device=boxes.device)
    KERNEL_BOXES(boxes.data_ptr(), idx.data_ptr(), valid.data_ptr(),
                 keep.data_ptr(), p, g, k, float(scale), float(thr),
                 torch.cuda.current_stream(boxes.device).cuda_stream)
    return keep


@torch.library.custom_op('stmask::greedy_nms_plus_one_keep', mutates_args=(),
                         device_types='cuda')
def _greedy_nms_boxes_op(boxes: torch.Tensor, idx: torch.Tensor,
                         valid: torch.Tensor, scale: float,
                         thr: float) -> torch.Tensor:
    return greedy_nms_boxes_cuda(boxes, idx, valid, scale, thr)


@_greedy_nms_boxes_op.register_kernel('cpu')
def _(boxes, idx, valid, scale, thr):
    return greedy_nms_plus_one_reference(boxes, idx, valid, scale, thr)


@_greedy_nms_boxes_op.register_fake
def _(boxes, idx, valid, scale, thr):
    return valid.new_empty(valid.shape)


def greedy_nms_plus_one_keep(boxes: torch.Tensor, idx: torch.Tensor,
                             valid: torch.Tensor, scale: float,
                             thr: float) -> torch.Tensor:
    """The op on contiguous copies where needed: top-k slices of a
    transposed score map come out strided."""
    return torch.ops.stmask.greedy_nms_plus_one_keep(
        boxes.contiguous(), idx.contiguous(), valid.contiguous(),
        float(scale), float(thr))
