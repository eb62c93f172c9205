"""Kernel-shaped anchor (prior) generation — the "FCA" anchors.

Copy of ``stmask_tpu/ops/anchors.py``.  The FCA head's priors have a
(w, h) equal to the prediction-head kernel shape in feature cells — 3x3,
3x5, 5x3 (reference ``layers/modules/prediction_head_FC.py:224-247``);
the legacy YOLACT head's aspect-ratio anchors come from
``make_yolact_priors`` (a copy of ``stmask_tpu/models/legacy_head.py:21``).
Iteration order matches the head's channel-concat order: position-major
(row j, col i), then aspect ratio (bank), then scale.
"""

from __future__ import annotations

from itertools import product
from math import sqrt
from typing import Sequence, Tuple

import numpy as np

from ..config import STMaskConfig


def make_priors(conv_h: int, conv_w: int,
                aspect_ratios: Sequence[Tuple[int, int]],
                scales: Sequence[float]) -> np.ndarray:
    """Priors for one FPN level, [conv_h * conv_w * A, 4] in [cx, cy, w, h].

    ``ar = (kh, kw)``; ``ratio = scale / scales[0]``;
    ``w = ratio * kw / conv_w``; ``h = ratio * kh / conv_h``.
    """
    jj, ii = np.meshgrid(np.arange(conv_h), np.arange(conv_w), indexing='ij')
    x = (ii.reshape(-1) + 0.5) / conv_w          # [hw]
    y = (jj.reshape(-1) + 0.5) / conv_h

    whs = []
    for (arh, arw) in aspect_ratios:
        for scale in scales:
            ratio = scale / scales[0]
            whs.append((ratio * arw / conv_w, ratio * arh / conv_h))
    whs = np.asarray(whs, dtype=np.float32)      # [A, 2]

    a = whs.shape[0]
    hw = x.shape[0]
    out = np.empty((hw, a, 4), dtype=np.float32)
    out[:, :, 0] = x[:, None]
    out[:, :, 1] = y[:, None]
    out[:, :, 2] = whs[None, :, 0]
    out[:, :, 3] = whs[None, :, 1]
    return out.reshape(hw * a, 4)


def make_yolact_priors(conv_h: int, conv_w: int,
                       aspect_ratios: Sequence[float],
                       scales: Sequence[float],
                       max_size: int = 550,
                       use_pixel_scales: bool = True,
                       use_square_anchors: bool = False) -> np.ndarray:
    """Scalar-aspect-ratio priors of one level, [conv_h * conv_w * A, 4] in
    [cx, cy, w, h]: position-major (row j, col i), then aspect ratio, then
    scale (reference prediction_head.py make_priors)."""
    data = []
    for j, i in product(range(conv_h), range(conv_w)):
        x = (i + 0.5) / conv_w
        y = (j + 0.5) / conv_h
        for ar in aspect_ratios:
            for scale in scales:
                a = sqrt(ar)
                if use_pixel_scales:
                    w = scale * a / max_size
                    h = scale / a / max_size
                else:
                    w = scale * a / conv_w
                    h = scale / a / conv_h
                if use_square_anchors:
                    h = w
                data.append((x, y, w, h))
    return np.asarray(data, np.float32)


def all_priors(cfg: STMaskConfig) -> np.ndarray:
    """Concatenated priors over all FPN levels, [num_priors, 4]: the FCA
    head's kernel-shaped anchors, or the legacy YOLACT head's aspect-ratio
    anchors (reference prediction_head.py make_priors)."""
    per_level = []
    for lvl, (fh, fw) in enumerate(cfg.feature_shapes()):
        if cfg.head_type == 'legacy':
            per_level.append(make_yolact_priors(
                fh, fw, aspect_ratios=(1.0, 0.5, 2.0),
                scales=tuple(cfg.pred_scales[lvl]),
                max_size=max(cfg.pad_w, cfg.pad_h)))
        else:
            per_level.append(make_priors(fh, fw, cfg.head_kernel_sizes,
                                         cfg.pred_scales[lvl]))
    return np.concatenate(per_level, axis=0)


def check_anchor_count(cfg: STMaskConfig, n_anchor: int,
                       n_priors: int) -> None:
    """Raise ``ValueError`` when the head emits another number of anchors
    than ``all_priors`` gives.  The priors assume P3..P7 at strides 8 x
    2^level (``feature_shapes``), but ``STMask_vgg16``'s backbone ends at
    stride 16 (its tail keeps the size of stage 4), so its head emits
    18180 anchors against 15345 priors at 384x640 (912 against 771 at
    96x128).  The JAX package's ``detect_frame`` fails there on a shape
    mismatch; the port stops before decode or match and says why
    (ROADMAP C.8: a fault of the JAX package)."""
    if n_anchor != n_priors:
        raise ValueError(
            f'{cfg.name}: the prediction head emits {n_anchor} anchors '
            f'but all_priors gives {n_priors} priors at {cfg.pad_h}x'
            f'{cfg.pad_w}: the backbone\'s selected outputs are not at '
            'strides 8, 16, 32, as feature_shapes assumes (ROADMAP C.8)')
