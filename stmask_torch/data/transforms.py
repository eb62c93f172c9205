"""Preparation of frames and training batches (port of
``stmask_tpu/data/transforms.py``).

An eval frame is resized on the device to (img_w, img_h) and stays uint8;
the video step normalizes and pads it.  A training frame and its targets
are prepared on the host with cv2 (``preprocess_frame``, then ``pad_gt``),
as the JAX package does.  A batch in ``ClipLoader``'s format
(``image_u8=True``) carries uint8 frames [B, 2, img_h, img_w, 3] and
bit-packed gt masks; the card normalizes and pads the frames and unpacks
the masks.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from ..config import MEANS, STD, STMaskConfig
from ..inference.pipeline import normalize_pad
from ..utils.device import resolve_device
from .ytvis import FrameAnnots


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


def preprocess_frame(cfg: STMaskConfig, img_rgb: np.ndarray,
                     annots: Optional[FrameAnnots] = None,
                     flip: bool = False, image_u8: bool = False) -> Dict:
    """One training frame on the host (``transforms.py:37-112``): cv2
    ``INTER_LINEAR`` resize to (img_w, img_h), the optional horizontal
    flip, and either the normalized frame zero-padded to (pad_h, pad_w)
    float32 or, with ``image_u8``, the resized uint8 frame (an augmented
    float frame rounded and clipped).  With ``annots`` also: boxes scaled,
    flipped, clipped to the image and divided by the padded size; labels,
    ids, crowd boxes alike; and ``masks_proto`` [n, pad_h/4, pad_w/4]
    uint8, each mask resized ``INTER_NEAREST``, padded, then resized
    ``INTER_LINEAR`` to prototype size and thresholded at 0.5."""
    import cv2

    ow, oh = img_rgb.shape[1], img_rgb.shape[0]
    iw, ih = cfg.img_w, cfg.img_h
    pw, ph = cfg.pad_w, cfg.pad_h

    img = cv2.resize(img_rgb, (iw, ih), interpolation=cv2.INTER_LINEAR)
    if image_u8:
        if flip:
            img = img[:, ::-1]
        if img.dtype != np.uint8:
            img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
        out = {'image': np.ascontiguousarray(img),
               'img_shape': (ih, iw), 'pad_shape': (ph, pw)}
    else:
        img = ((img.astype(np.float32) - np.asarray(MEANS, np.float32))
               / np.asarray(STD, np.float32))
        if flip:
            img = img[:, ::-1]
        padded = np.zeros((ph, pw, 3), np.float32)
        padded[:ih, :iw] = img
        out = {'image': padded, 'img_shape': (ih, iw), 'pad_shape': (ph, pw)}
    if annots is None:
        return out

    w_scale, h_scale = iw / ow, ih / oh

    def tf_boxes(b):
        b = b * np.asarray([w_scale, h_scale, w_scale, h_scale], np.float32)
        if flip:                      # reference bbox_flip
            x1 = iw - b[:, 2] - 1
            x2 = iw - b[:, 0] - 1
            b = np.stack([x1, b[:, 1], x2, b[:, 3]], axis=1)
        b = b.copy()
        b[:, 0::2] = np.clip(b[:, 0::2], 0, iw) / pw
        b[:, 1::2] = np.clip(b[:, 1::2], 0, ih) / ph
        return b.astype(np.float32)

    boxes = tf_boxes(annots.boxes)
    crowd = annots.crowd_boxes
    crowd = (tf_boxes(crowd.reshape(-1, 4)) if crowd is not None
             and len(crowd) else np.zeros((0, 4), np.float32))

    hp, wp = ph // 4, pw // 4
    n = annots.masks.shape[0]
    masks_proto = np.zeros((n, hp, wp), np.uint8)
    for i in range(n):
        m = cv2.resize(annots.masks[i], (iw, ih),
                       interpolation=cv2.INTER_NEAREST)
        if flip:
            m = m[:, ::-1]
        mp = np.zeros((ph, pw), np.uint8)
        mp[:ih, :iw] = m
        small = cv2.resize(mp.astype(np.float32), (wp, hp),
                           interpolation=cv2.INTER_LINEAR)
        masks_proto[i] = (small > 0.5).astype(np.uint8)

    out.update(boxes=boxes, labels=annots.labels, ids=annots.ids,
               masks_proto=masks_proto, crowd_boxes=crowd)
    return out


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
