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

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..config import STMaskConfig
from ..inference.pipeline import normalize_pad


def resize_u8(img: torch.Tensor, size_hw) -> torch.Tensor:
    """uint8 [H, W, C] -> uint8 [h, w, C], bilinear as cv2 ``INTER_LINEAR``
    computes it: half-pixel centres, the edge pixel repeated, no
    antialiasing, rounded half up.  cv2 sums 8-bit images in fixed point
    (11-bit weights), this in float32, so a pixel can differ by one grey
    level."""
    h, w = size_hw
    if tuple(img.shape[:2]) == (h, w):
        return img
    x = img.permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(h, w), mode='bilinear', align_corners=False)
    y = torch.floor(y + 0.5).clamp_(0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).contiguous()


def preprocess_frame_u8(cfg: STMaskConfig, img_rgb,
                        device: torch.device | str = 'cpu') -> Dict:
    """An RGB uint8 frame of any size (numpy or tensor) -> its (img_w,
    img_h) resize on ``device``, still uint8 (``transforms.py:115-125``);
    normalization and padding happen in the video step."""
    img = torch.as_tensor(img_rgb).to(device, non_blocking=True)
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
