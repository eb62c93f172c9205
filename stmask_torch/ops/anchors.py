"""Kernel-shaped anchor (prior) generation — the "FCA" anchors.

Copy of ``stmask_tpu/ops/anchors.py`` (the ``'fc'`` head branch): priors
whose (w, h) equal the prediction-head kernel shape in feature cells — 3x3,
3x5, 5x3 (reference ``layers/modules/prediction_head_FC.py:224-247``).
Iteration order matches the head's channel-concat order: position-major
(row j, col i), then aspect ratio (bank), then scale.
"""

from __future__ import annotations

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


def all_priors(cfg: STMaskConfig) -> np.ndarray:
    """Concatenated priors over all FPN levels, [num_priors, 4]."""
    if cfg.head_type != 'fc':
        raise NotImplementedError(
            f'head_type {cfg.head_type!r}: only the FCA head is ported '
            '(ROADMAP A.12 for the legacy YOLACT head)')
    per_level = [make_priors(fh, fw, cfg.head_kernel_sizes,
                             cfg.pred_scales[lvl])
                 for lvl, (fh, fw) in enumerate(cfg.feature_shapes())]
    return np.concatenate(per_level, axis=0)
