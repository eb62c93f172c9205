"""Device-side preparation of training batches (port of the ``*_device``
functions and ``pad_gt`` of ``stmask_tpu/data/transforms.py``).

A batch in ``ClipLoader``'s format (``image_u8=True``) carries uint8 frames
[B, 2, img_h, img_w, 3] and bit-packed gt masks; the card normalizes and
pads the frames and unpacks the masks.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import STMaskConfig
from ..inference.pipeline import normalize_pad


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
