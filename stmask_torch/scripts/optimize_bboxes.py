"""Optimize the anchor shapes for the mean best IoU against the training
boxes (the counterpart of the JAX package's ``scripts/optimize_bboxes.py``):

    python -m stmask_torch.scripts.optimize_bboxes --ann_file A
        [--box_file B] [--config STMask_plus_resnet50]

Nelder-Mead (scipy) over the log of the config's unique (w, h) prior
shapes, maximizing the mean over boxes of the best size-only IoU.
Host-only (numpy, scipy).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np


def mean_best_iou(whs: np.ndarray, anchors: np.ndarray) -> float:
    inter = (np.minimum(whs[:, None, 0], anchors[None, :, 0])
             * np.minimum(whs[:, None, 1], anchors[None, :, 1]))
    union = (whs[:, 0] * whs[:, 1])[:, None] \
        + (anchors[:, 0] * anchors[:, 1])[None, :] - inter
    return (inter / np.maximum(union, 1e-12)).max(1).mean()


def run(cfg, whs: np.ndarray, maxiter: int = 2000) -> Dict:
    """Print and return {'current', 'optimized', 'shapes'} (the optimized
    shapes sorted by area)."""
    from scipy.optimize import minimize

    from ..ops.anchors import all_priors
    cur = all_priors(cfg)[:, 2:]
    anchors0 = np.unique(np.round(cur, 5), axis=0)
    current = mean_best_iou(whs, anchors0)
    print(f'current: {len(anchors0)} unique shapes, '
          f'mean best IoU {current:.4f}')
    x0 = np.log(anchors0.reshape(-1))
    res = minimize(lambda x: -mean_best_iou(whs, np.exp(x).reshape(-1, 2)),
                   x0, method='Nelder-Mead',
                   options={'maxiter': maxiter, 'xatol': 1e-4})
    best = np.exp(res.x).reshape(-1, 2)
    optimized = mean_best_iou(whs, best)
    print(f'optimized mean best IoU {optimized:.4f}')
    shapes = best[np.argsort(best.prod(1))]
    for wh in shapes:
        print(f'  w={wh[0]:.4f} h={wh[1]:.4f}')
    return {'current': float(current), 'optimized': float(optimized),
            'shapes': shapes}


def main(argv=None) -> int:
    from ..config import get_config
    from ._boxes import load_whs
    p = argparse.ArgumentParser()
    p.add_argument('--ann_file', default=None)
    p.add_argument('--box_file', default=None,
                   help='normalized-wh pickle from augment_bbox.py '
                        '(or [w,h,x,y,bw,bh] rows from save_bboxes.py)')
    p.add_argument('--config', default='STMask_plus_resnet50')
    args = p.parse_args(argv)
    run(get_config(args.config), load_whs(args))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
