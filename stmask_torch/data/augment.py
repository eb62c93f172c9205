"""Training augmentations on the host (port of
``stmask_tpu/data/augment.py``; reference ``datasets/extra_aug.py`` and
``utils/augmentations.py``).

Photometric distortion (brightness, contrast, HSV saturation and hue,
channel swap), Expand (zoom out over a mean fill), the IoU-constrained
crops, and the horizontal and vertical flips, applied jointly to image,
boxes, labels, masks and ids.  Every transform draws from the caller's
``np.random.RandomState``, so a seed gives the JAX package's result.
``ClipLoader`` applies ``ExtraAugmentation`` or ``SSDAugmentation`` when
``cfg.train_augment`` asks for it (no preset does).
"""

from __future__ import annotations

import cv2
import numpy as np


def _pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class PhotoMetricDistortion:
    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, img, boxes, labels, masks, ids, rng=None):
        rng = rng or np.random
        img = img.astype(np.float32)
        if rng.randint(2):
            img = img + rng.uniform(-self.brightness_delta,
                                    self.brightness_delta)
        mode = rng.randint(2)
        if mode == 1 and rng.randint(2):
            img = img * rng.uniform(*self.contrast_range)

        hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                           cv2.COLOR_RGB2HSV).astype(np.float32)
        if rng.randint(2):
            hsv[..., 1] *= rng.uniform(*self.saturation_range)
        if rng.randint(2):
            # cv2 hue range is [0, 180)
            hsv[..., 0] += rng.uniform(-self.hue_delta, self.hue_delta) / 2
            hsv[..., 0] = np.mod(hsv[..., 0], 180)
        hsv[..., 1:] = np.clip(hsv[..., 1:], 0, 255)
        img = cv2.cvtColor(hsv.astype(np.uint8),
                           cv2.COLOR_HSV2RGB).astype(np.float32)

        if mode == 0 and rng.randint(2):
            img = img * rng.uniform(*self.contrast_range)
        if rng.randint(2):
            img = img[..., rng.permutation(3)]
        return img, boxes, labels, masks, ids


class Expand:
    def __init__(self, mean=(123.675, 116.28, 103.53),
                 ratio_range=(1, 4), keep_size=True):
        self.mean = mean
        self.ratio_range = ratio_range
        # keep_size: resize the expanded canvas back to the input size
        # (mmcv extra_aug semantics); False leaves the canvas expanded
        # (SSD-chain semantics — the fixed resize happens later anyway)
        self.keep_size = keep_size

    def __call__(self, img, boxes, labels, masks, ids, rng=None):
        rng = rng or np.random
        if rng.randint(2):
            return img, boxes, labels, masks, ids
        h, w, c = img.shape
        ratio = rng.uniform(*self.ratio_range)
        eh, ew = int(h * ratio), int(w * ratio)
        canvas = np.full((eh, ew, c), self.mean, img.dtype)
        left = int(rng.uniform(0, ew - w))
        top = int(rng.uniform(0, eh - h))
        canvas[top:top + h, left:left + w] = img
        new_masks = []
        for m in masks:
            cm = np.zeros((eh, ew), m.dtype)
            cm[top:top + h, left:left + w] = m
            new_masks.append(cm)
        if not self.keep_size:
            boxes = boxes + np.tile((left, top), 2).astype(boxes.dtype)
            out_masks = np.stack(new_masks) if new_masks else masks
            return canvas, boxes, labels, out_masks, ids
        img = cv2.resize(canvas, (w, h), interpolation=cv2.INTER_NEAREST)
        boxes = np.rint((boxes + np.tile((left, top), 2)) / ratio) \
            .astype(boxes.dtype)
        new_masks = [cv2.resize(m, (w, h),
                                interpolation=cv2.INTER_NEAREST)
                     for m in new_masks]
        out_masks = np.stack(new_masks) if new_masks else masks
        return img, boxes, labels, out_masks, ids


class RandomCrop:
    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9),
                 min_crop_size=0.3):
        self.sample_mode = (1, *min_ious, 0)
        self.min_crop_size = min_crop_size

    def __call__(self, img, boxes, labels, masks, ids, rng=None):
        rng = rng or np.random
        h, w, _ = img.shape
        for _ in range(50):
            mode = self.sample_mode[rng.randint(len(self.sample_mode))]
            if mode == 1:
                return img, boxes, labels, masks, ids
            min_iou = mode
            for _ in range(50):
                new_w = rng.uniform(self.min_crop_size * w, w)
                new_h = rng.uniform(self.min_crop_size * h, h)
                if not (0.5 <= new_h / new_w <= 2):
                    continue
                left = rng.uniform(w - new_w)
                top = rng.uniform(h - new_h)
                patch = np.asarray([int(left), int(top), int(left + new_w),
                                    int(top + new_h)])
                overlaps = _pairwise_iou(patch[None].astype(np.float32),
                                         boxes)[0]
                if overlaps.size and overlaps.min() < min_iou:
                    continue
                center = (boxes[:, :2] + boxes[:, 2:]) / 2
                keep = ((center[:, 0] > patch[0]) & (center[:, 1] > patch[1])
                        & (center[:, 0] < patch[2])
                        & (center[:, 1] < patch[3]))
                if not keep.any():
                    continue
                boxes = boxes[keep].copy()
                labels = labels[keep]
                masks = np.asarray(masks)[keep]
                ids = np.asarray(ids)[keep]

                # true crop (the loader's fixed resize follows host-side,
                # so the dynamic intermediate shape is fine)
                img_crop = img[patch[1]:patch[3], patch[0]:patch[2]].copy()
                boxes[:, 2:] = boxes[:, 2:].clip(max=patch[2:])
                boxes[:, :2] = boxes[:, :2].clip(min=patch[:2])
                boxes -= np.tile(patch[:2], 2)
                masks_crop = masks[:, patch[1]:patch[3],
                                   patch[0]:patch[2]].copy()
                return img_crop, boxes, labels, masks_crop, ids
        return img, boxes, labels, masks, ids


class RandomSampleCrop:
    """The SSD-chain crop (reference ``utils/augmentations.py:241-330``):
    sample a (min_iou, max_iou) mode, then a patch whose jaccard overlap
    with the boxes satisfies it and that contains at least one box center;
    true-crop image/masks, clip + shift kept boxes."""

    MODES = (None, (0.1, None), (0.3, None), (0.7, None), (0.9, None),
             (None, None))

    def __call__(self, img, boxes, labels, masks, ids, rng=None):
        rng = rng or np.random
        h, w, _ = img.shape
        while True:
            mode = self.MODES[rng.randint(len(self.MODES))]
            if mode is None or len(boxes) == 0:
                return img, boxes, labels, masks, ids
            min_iou = mode[0] if mode[0] is not None else -np.inf
            max_iou = mode[1] if mode[1] is not None else np.inf
            for _ in range(50):
                cw = rng.uniform(0.3 * w, w)
                ch = rng.uniform(0.3 * h, h)
                if ch / cw < 0.5 or ch / cw > 2:
                    continue
                left = rng.uniform(w - cw)
                top = rng.uniform(h - ch)
                rect = np.asarray([int(left), int(top), int(left + cw),
                                   int(top + ch)])
                overlap = _pairwise_iou(boxes.astype(np.float32),
                                        rect[None].astype(np.float32))[:, 0]
                # the reference's (odd) accept condition, kept verbatim
                if overlap.min() < min_iou and max_iou < overlap.max():
                    continue
                centers = (boxes[:, :2] + boxes[:, 2:]) / 2
                keep = ((rect[0] < centers[:, 0]) & (rect[1] < centers[:, 1])
                        & (rect[2] > centers[:, 0])
                        & (rect[3] > centers[:, 1]))
                if not keep.any():
                    continue
                boxes = boxes[keep].copy()
                labels = labels[keep]
                masks = np.asarray(masks)[keep]
                ids = np.asarray(ids)[keep]
                img = img[rect[1]:rect[3], rect[0]:rect[2]].copy()
                masks = masks[:, rect[1]:rect[3], rect[0]:rect[2]].copy()
                boxes[:, :2] = np.maximum(boxes[:, :2], rect[:2]) - rect[:2]
                boxes[:, 2:] = np.minimum(boxes[:, 2:], rect[2:]) - rect[:2]
                return img, boxes, labels, masks, ids


class RandomMirror:
    """Horizontal flip (reference ``augmentations.py:332-341``)."""

    def __call__(self, img, boxes, labels, masks, ids, rng=None):
        rng = rng or np.random
        if rng.randint(2):
            w = img.shape[1]
            img = img[:, ::-1].copy()
            masks = np.asarray(masks)[:, :, ::-1].copy()
            boxes = boxes.copy()
            boxes[:, 0::2] = w - boxes[:, 2::-2]
        return img, boxes, labels, masks, ids


class RandomFlip:
    """Vertical flip (reference ``augmentations.py:344-354``)."""

    def __call__(self, img, boxes, labels, masks, ids, rng=None):
        rng = rng or np.random
        if rng.randint(2):
            h = img.shape[0]
            img = img[::-1].copy()
            masks = np.asarray(masks)[:, ::-1].copy()
            boxes = boxes.copy()
            boxes[:, 1::2] = h - boxes[:, 3::-2]
        return img, boxes, labels, masks, ids


class SSDAugmentation:
    """The legacy YOLACT training chain (reference
    ``utils/augmentations.py:666-686``): PhotometricDistort -> Expand
    (canvas kept) -> RandomSampleCrop -> RandomMirror [-> RandomFlip].
    The fixed resize/pad/normalize happen downstream in
    ``transforms.preprocess_frame``."""

    def __init__(self, photometric=True, expand=True, sample_crop=True,
                 mirror=True, flip=False,
                 mean=(123.675, 116.28, 103.53)):
        self.transforms = []
        if photometric:
            self.transforms.append(PhotoMetricDistortion())
        if expand:
            self.transforms.append(Expand(mean=mean, keep_size=False))
        if sample_crop:
            self.transforms.append(RandomSampleCrop())
        if mirror:
            self.transforms.append(RandomMirror())
        if flip:
            self.transforms.append(RandomFlip())

    def __call__(self, img, boxes, labels, masks, ids, rng=None):
        img = img.astype(np.float32)
        for t in self.transforms:
            img, boxes, labels, masks, ids = t(img, boxes, labels, masks,
                                               ids, rng=rng)
        return img, boxes, labels, masks, ids


class ExtraAugmentation:
    def __init__(self, photo_metric_distortion=None, expand=None,
                 random_crop=None):
        self.transforms = []
        if photo_metric_distortion is not None:
            self.transforms.append(
                PhotoMetricDistortion(**photo_metric_distortion))
        if expand is not None:
            self.transforms.append(Expand(**expand))
        if random_crop is not None:
            self.transforms.append(RandomCrop(**random_crop))

    def __call__(self, img, boxes, labels, masks, ids, rng=None):
        img = img.astype(np.float32)
        for t in self.transforms:
            img, boxes, labels, masks, ids = t(img, boxes, labels, masks,
                                               ids, rng=rng)
        return img, boxes, labels, masks, ids
