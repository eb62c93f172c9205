"""How often the training window clamps the deformable offsets (the
counterpart of the JAX package's ``scripts/dcn_clip_rate.py``):

    python -m stmask_torch.scripts.dcn_clip_rate [--config
        STMask_plus_resnet50] [--ckpt model.pth | --mirror] [--batches 2]
        [--data DIR] [--device cuda|cpu]

Training clamps the backbone DCN offsets to +-``dcn_window_radius`` and
FCB's to +-``fcb_window_radius`` (the reference's DCNv2 does not clamp; at
radius 0 the port trains through the exact gather).  Per site this prints
the share of offset components with |offset| > radius, their max and p99
(the mean over the captures of each capture's p99), over training forwards
of ``--batches`` batches of 2 clips from the synthetic overfit set
(``stmask_torch.overfit_sanity.make_dataset``, written to ``--data`` when
missing).  The offsets are read by forward hooks: on each DCN's
``conv_offset_mask`` (its first 18 channels), on FCB's ``conv_offset``
(``_ada``), or, for FCB banks without one (``_ali``), computed from the
bank's box input as the bank computes them.

Weights: ``--ckpt`` the port's checkpoint (``{'model': state_dict}``);
``--mirror`` the port's own random init (``init_random``: offset
predictors of std 0.01 and a bias of std 0.5, a worst case); neither, the
seeded init drawn as flax's (``init_flax``: zero offset predictors, so
every share is 0).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import tempfile
from typing import Dict, Iterable, List

import numpy as np
import torch


def site_name(module_name: str) -> str:
    """The JAX script's name of a site: ``layer{i}_{j}/conv2`` for a
    backbone DCN, ``{conf|track|mask}_align_{k}`` for an FCB bank."""
    m = re.fullmatch(r'backbone\.layers\.(\d+)\.(\d+)\.conv2', module_name)
    if m:
        return f'layer{m.group(1)}_{m.group(2)}/conv2'
    m = re.search(r'(conf|track|mask)_layer\.(\d+)$', module_name)
    if m:
        return f'{m.group(1)}_align_{m.group(2)}'
    raise KeyError(module_name)


def _hooks(cfg, model, captured: Dict[str, List[np.ndarray]]):
    """Register the offset hooks; returns their handles."""
    from ..models.backbone import DCNConv
    from ..models.heads import FeatureAlign, _ali_offsets
    handles = []

    def keep(name, offsets):
        captured.setdefault(name, []).append(
            np.abs(offsets.detach().float().cpu().numpy()))

    for name, m in model.named_modules():
        if isinstance(m, DCNConv):
            site = site_name(name)
            handles.append(m.conv_offset_mask.register_forward_hook(
                lambda mod, args, out, s=site: keep(s, out[:, :18])))
        elif isinstance(m, FeatureAlign):
            site = site_name(name)
            if m.conv_offset is not None:
                handles.append(m.conv_offset.register_forward_hook(
                    lambda mod, args, out, s=site: keep(s, out)))
            else:
                handles.append(m.register_forward_pre_hook(
                    lambda mod, args, s=site: keep(s, _ali_offsets(
                        args[1].detach().permute(0, 2, 3, 1),
                        mod.kernel_size))))
    return handles


def radius_of(cfg, site: str) -> int:
    return (cfg.backbone.dcn_window_radius if site.endswith('conv2')
            else cfg.fcb_window_radius)


@torch.no_grad()
def capture(cfg, model, batches: Iterable[np.ndarray], device
            ) -> Dict[str, List[np.ndarray]]:
    """{site: [|offsets| of each capture]} over training forwards of the
    image batches [B, 2, H, W, 3]."""
    captured: Dict[str, List[np.ndarray]] = {}
    handles = _hooks(cfg, model, captured)
    try:
        for images in batches:
            model(torch.as_tensor(images, device=device), train=True)
    finally:
        for h in handles:
            h.remove()
    return captured


def stats(cfg, captured: Dict[str, List[np.ndarray]]) -> List[Dict]:
    """One row a site, sorted by name: clip share (%), max, p99."""
    rows = []
    for site in sorted(captured):
        r = radius_of(cfg, site)
        offs = captured[site]
        n = sum(o.size for o in offs)
        clipped = sum(int((o > r).sum()) for o in offs)
        rows.append({'site': site, 'clip_pct': 100.0 * clipped / max(n, 1),
                     'clipped': clipped, 'n': n,
                     'max_abs': max(float(o.max()) for o in offs),
                     'p99': float(np.mean([np.percentile(o, 99)
                                           for o in offs])),
                     'radius': r})
    return rows


def run(cfg, model, batches: Iterable[np.ndarray], device,
        source: str = 'init') -> List[Dict]:
    """Capture, print the table and the JSON line; returns the rows."""
    rows = stats(cfg, capture(cfg, model, batches, device))
    radius = cfg.backbone.dcn_window_radius
    print(f'# config={cfg.name} radius={radius} source={source}')
    print(f'{"site":28s} {"clip%":>8s} {"max|off|":>9s} {"p99":>7s}')
    for r in rows:
        print(f'{r["site"]:28s} {r["clip_pct"]:8.4f} {r["max_abs"]:9.3f} '
              f'{r["p99"]:7.3f}')
    worst = max((r['clip_pct'] for r in rows), default=0.0)
    print(json.dumps({'config': cfg.name, 'radius': radius,
                      'source': source, 'worst_clip_pct': worst,
                      'sites': rows}))
    return rows


def load_model(cfg, device, ckpt: str = None, mirror: bool = False):
    """(model on ``device`` in eval mode, source label)."""
    from ..models.stmask import STMask, init_flax, init_random
    model = STMask(cfg)
    if ckpt:
        saved = torch.load(ckpt, map_location='cpu', weights_only=True)
        model.load_state_dict(saved['model'] if 'model' in saved else saved)
        source = ckpt
    elif mirror:
        init_random(model, torch.Generator().manual_seed(0))
        source = 'port-random-init'
    else:
        init_flax(model, torch.Generator().manual_seed(0))
        source = 'init'
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.eval(), source


def loader_batches(cfg, data: str, n: int):
    """The images of the first ``n`` batches of 2 clips of the synthetic
    overfit set under ``data`` (written when missing)."""
    from ..data.loader import ClipLoader
    from ..data.ytvis import YTVISDataset
    ann = os.path.join(data, 'train.json')
    if not os.path.exists(ann):
        from ..overfit_sanity import make_dataset
        make_dataset(data)
    loader = ClipLoader(cfg, YTVISDataset(ann, os.path.join(data, 'imgs')),
                        batch_size=2, num_workers=4)
    for i, batch in enumerate(loader.epoch(0)):
        if i >= n:
            break
        yield batch['images']


def main(argv=None) -> int:
    from ..config import get_config
    from ..utils.device import resolve_device
    from ._common import add_device
    p = argparse.ArgumentParser()
    p.add_argument('--config', default='STMask_plus_resnet50')
    p.add_argument('--ckpt', default=None)
    p.add_argument('--mirror', action='store_true')
    p.add_argument('--batches', type=int, default=2)
    p.add_argument('--data', default=os.path.join(tempfile.gettempdir(),
                                                  'overfit_sanity'),
                   help='overfit dataset root (created if missing)')
    add_device(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    model, source = load_model(cfg, dev, args.ckpt, args.mirror)
    run(cfg, model, loader_batches(cfg, args.data, args.batches), dev,
        source)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
