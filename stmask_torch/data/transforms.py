"""Device-side preparation of frames and training batches (port of
``preprocess_frame_u8``, the ``*_device`` functions and ``pad_gt`` of
``stmask_tpu/data/transforms.py``).

An eval frame is resized on the device to (img_w, img_h) and stays uint8;
the video step normalizes and pads it.  A batch in ``ClipLoader``'s format
(``image_u8=True``) carries uint8 frames [B, 2, img_h, img_w, 3] and
bit-packed gt masks; the card normalizes and pads the frames and unpacks
the masks.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from ..config import STMaskConfig
from ..inference.pipeline import normalize_pad
from ..utils.device import resolve_device


_COEF = 2048   # cv2's INTER_RESIZE_COEF_SCALE: 11-bit weights


@functools.lru_cache(maxsize=32)
def _taps(src: int, dst: int, cols: bool, device: torch.device):
    """Per destination index: the two source indices and their 11-bit
    weights along one axis, as cv2's ``resize`` sets them up for
    ``INTER_LINEAR`` (the source coordinate in float32, from cv2's double
    scale; columns clamp the coordinate at the edges, rows only the
    indices)."""
    scale = 1.0 / (dst / src)
    f = ((torch.arange(dst, dtype=torch.float64) + 0.5) * scale
         - 0.5).float()
    s = torch.floor(f)
    f = f - s
    s = s.long()
    if cols:
        f = torch.where((s < 0) | (s >= src - 1), 0.0, f)
        s = s.clamp(0, src - 1)
    w1 = torch.round(f * _COEF).int()          # round half to even
    w0 = torch.round((1.0 - f) * _COEF).int()
    s0 = s.clamp(0, src - 1)
    s1 = (s + 1).clamp(0, src - 1)
    return tuple(t.to(device) for t in (s0, s1, w0, w1))


def resize_u8(img: torch.Tensor, size_hw) -> torch.Tensor:
    """uint8 [H, W, C] -> uint8 [h, w, C], bit for bit what cv2's
    ``resize(..., INTER_LINEAR)`` gives an 8-bit image: half-pixel
    centres, 11-bit fixed-point weights, a horizontal pass in int32 and
    cv2's vertical pass ``((H0 >> 4) * b0 >> 16) + ((H1 >> 4) * b1 >> 16)
    + 2 >> 2``.  Integer tensor code on the frame's own device."""
    h, w = size_hw
    src_h, src_w = img.shape[:2]
    if (src_h, src_w) == (h, w):
        return img
    ys0, ys1, b0, b1 = _taps(src_h, h, False, img.device)
    xs0, xs1, a0, a1 = _taps(src_w, w, True, img.device)
    a0, a1 = a0[:, None], a1[:, None]

    def hpass(rows):                          # [h, W, C] -> [h, w, C] >> 4
        rows = rows.int()
        return (rows[:, xs0] * a0 + rows[:, xs1] * a1) >> 4

    out = (((hpass(img[ys0]) * b0[:, None, None]) >> 16)
           + ((hpass(img[ys1]) * b1[:, None, None]) >> 16) + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8)


def preprocess_frame_u8(cfg: STMaskConfig, img_rgb,
                        device: torch.device | str = 'cuda') -> Dict:
    """An RGB uint8 frame of any size (numpy or tensor) -> its (img_w,
    img_h) resize on ``device``, still uint8 (``transforms.py:115-125``);
    normalization and padding happen in the video step."""
    img = torch.as_tensor(img_rgb).to(resolve_device(device),
                                      non_blocking=True)
    return {'image': resize_u8(img, (cfg.img_h, cfg.img_w)),
            'img_shape': (cfg.img_h, cfg.img_w),
            'pad_shape': (cfg.pad_h, cfg.pad_w)}


def train_base_transform(cfg: STMaskConfig, images: torch.Tensor
                         ) -> torch.Tensor:
    """uint8 [..., img_h, img_w, 3] -> normalized float32 [..., pad_h,
    pad_w, 3] (``transforms.py:169-182``)."""
    return normalize_pad(cfg, images)


def unpack_masks_device(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``np.packbits(masks, axis=-1)``: uint8 [..., W/8] ->
    uint8 [..., W], most significant bit first, as numpy packs
    (``transforms.py:185-199``)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))


def pad_gt(cfg: STMaskConfig, frame: Dict) -> Dict:
    """Pad one frame's targets to the static ``max_gt_per_frame`` and
    ``crowd_capacity`` (``transforms.py:202-227``); host numpy."""
    g = cfg.max_gt_per_frame
    hp, wp = cfg.pad_h // 4, cfg.pad_w // 4
    n = min(len(frame['labels']), g)
    boxes = np.zeros((g, 4), np.float32)
    labels = np.zeros((g,), np.int32)
    ids = np.zeros((g,), np.int32)
    valid = np.zeros((g,), bool)
    masks = np.zeros((g, hp, wp), np.uint8)
    boxes[:n] = frame['boxes'][:n]
    labels[:n] = frame['labels'][:n]
    ids[:n] = frame['ids'][:n]
    valid[:n] = True
    masks[:n] = frame['masks_proto'][:n]
    gc = cfg.crowd_capacity
    crowd = np.zeros((gc, 4), np.float32)
    crowd_valid = np.zeros((gc,), bool)
    cb = frame.get('crowd_boxes')
    if cb is not None and len(cb):
        nc = min(len(cb), gc)
        crowd[:nc] = cb[:nc]
        crowd_valid[:nc] = True
    return {'image': frame['image'], 'boxes': boxes, 'labels': labels,
            'ids': ids, 'valid': valid, 'masks_proto': masks,
            'crowd_boxes': crowd, 'crowd_valid': crowd_valid}


def prepare_batch(cfg: STMaskConfig, batch: Dict,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """A ``ClipLoader`` batch (uint8 frames, packed masks; numpy or
    tensors) -> the train step's batch on ``device``: normalized padded
    images and unpacked masks cut to the prototype width (``train.py:
    184-196``)."""
    out = {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device, non_blocking=True)
        for k, v in batch.items()}
    out['images'] = train_base_transform(cfg, out['images'])
    out['masks_proto'] = unpack_masks_device(
        out['masks_proto'])[..., :cfg.pad_w // 4]
    return out
