"""Anchor recall of a config's priors against a dataset's gt boxes (the
counterpart of the JAX package's ``scripts/bbox_recall.py``):

    python -m stmask_torch.scripts.bbox_recall --ann_file A
        [--config STMask_plus_resnet50] [--thresh 0.5]

The share of gt boxes whose best prior, by a size-only IoU (the box and
the prior centred on one point, the reference script's best case), reaches
0.3, 0.5 and 0.7, and the mean best IoU.  Host-only (numpy).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np


def run(cfg, whs: np.ndarray) -> Dict[str, float]:
    """Print and return {'n_boxes', 'n_priors', 'recall@t', 'mean_best'}
    for the [N, 2] normalized box sizes ``whs``."""
    from ..ops.anchors import all_priors
    priors = all_priors(cfg)                       # [P, 4] cxcywh
    pw, ph = priors[:, 2], priors[:, 3]
    inter = (np.minimum(whs[:, None, 0], pw[None, :])
             * np.minimum(whs[:, None, 1], ph[None, :]))
    union = (whs[:, 0] * whs[:, 1])[:, None] + (pw * ph)[None, :] - inter
    best = (inter / np.maximum(union, 1e-12)).max(1)
    out = {'n_boxes': len(whs), 'n_priors': len(priors)}
    print(f'{len(whs)} gt boxes, {len(priors)} priors')
    for t in (0.3, 0.5, 0.7):
        out[f'recall@{t}'] = float((best >= t).mean())
        print(f'recall@{t}: {out[f"recall@{t}"]:.4f}')
    out['mean_best'] = float(best.mean())
    print(f'mean best IoU: {out["mean_best"]:.4f}')
    return out


def main(argv=None) -> int:
    from ..config import get_config
    from ._boxes import collect_boxes
    p = argparse.ArgumentParser()
    p.add_argument('--ann_file', required=True)
    p.add_argument('--config', default='STMask_plus_resnet50')
    p.add_argument('--thresh', type=float, default=0.5)
    args = p.parse_args(argv)
    run(get_config(args.config), collect_boxes(args.ann_file))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
