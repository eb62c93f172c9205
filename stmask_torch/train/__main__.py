#!/usr/bin/env python
"""The port's training script (the counterpart of the JAX package's
``train.py``):

    python -m stmask_torch.train --ann_file A --img_prefix P [flags]

Config by name, batch-size autoscaling (unless ``--no_autoscale``), warm-up
and step decay, checkpoints every ``--save_interval`` iterations, on Ctrl-C
and at the end, ``--resume latest|interrupt|path``, ``--init_weights`` from
a reference-keyed ``.pth``, in-train validation every
``--validation_epoch`` epochs through the eval CLI's batched bf16 path,
overlays of the batch every ``--vis_every`` steps, and a JSON-lines log.
The initial weights are drawn as the JAX package draws them
(``models.stmask.init_flax``, seed 0).  Batches come from
``ClipLoader`` (uint8 frames, packed masks) through the loop's
``Prefetcher``.  The model runs on ``--device`` (default ``cuda``, which
raises on a host without a GPU).

Data-parallel over N processes, one card each (``train.py:86-89``,
``:125-147``):

    torchrun --nproc_per_node=N -m stmask_torch.train --ann_file A ...

Each process loads its shard of every epoch (``ClipLoader(num_shards=N,
shard_id=rank)``, an epoch being the shard's clips over ``--batch_size``)
and ``--batch_size`` is per process, so a step takes N x ``--batch_size``
clips; autoscaling sees the per-process ``--batch_size``, as the JAX
package's ``train.py`` does.  The processes compute the single-process step over the
whole batch (``parallel/mesh.py``); rank 0 writes the checkpoints, the log
and the validation.  NCCL joins ranks with a card each; ranks on the CPU,
or several on one card, use gloo.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from typing import Dict, Optional

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='stmask_torch training')
    p.add_argument('--config', default='STMask_plus_resnet50',
                   help='config preset name (stmask_torch.config.REGISTRY)')
    p.add_argument('--batch_size', type=int, default=8,
                   help='clips (two frames each) a step')
    p.add_argument('--resume', default=None,
                   help='checkpoint path, or "latest" / "interrupt"')
    p.add_argument('--init_weights', default=None,
                   help='reference-keyed .pth to overlay on the initial '
                        'weights')
    p.add_argument('--ann_file', default=None)
    p.add_argument('--img_prefix', default=None)
    p.add_argument('--save_folder', default='weights/')
    p.add_argument('--log_folder', default='logs/')
    p.add_argument('--save_interval', type=int, default=10000)
    p.add_argument('--keep_latest', type=int, default=0)
    p.add_argument('--validation_epoch', type=int, default=2)
    p.add_argument('--valid_ann_file', default=None)
    p.add_argument('--valid_img_prefix', default=None)
    p.add_argument('--valid_max_videos', type=int, default=20)
    p.add_argument('--num_workers', type=int, default=8)
    p.add_argument('--max_iter', type=int, default=None)
    p.add_argument('--lr', type=float, default=None)
    p.add_argument('--no_autoscale', action='store_true')
    p.add_argument('--img_w', type=int, default=None,
                   help='override the input width')
    p.add_argument('--img_h', type=int, default=None)
    p.add_argument('--vis_every', type=int, default=0,
                   help='every N steps write train / gt overlays of the '
                        'batch to --vis_dir (debug)')
    p.add_argument('--vis_dir', default='results/train_vis')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def validate(args, cfg, model, epoch: int, iteration: int
             ) -> Optional[Dict]:
    """In-train validation (``train.py:253-270``): the eval CLI's batched
    bf16 path over ``--valid_max_videos`` videos with ``--eval_metrics``.
    It runs on a copy of the model, because the eval path casts its model
    to bf16 in place and sets eval mode."""
    from .. import eval as eval_cli

    eval_args = eval_cli.parse_args([
        '--ann_file', args.valid_ann_file,
        '--img_prefix', args.valid_img_prefix or args.img_prefix,
        '--eval_metrics', '--max_videos', str(args.valid_max_videos),
        '--mask_det_file', os.path.join(args.save_folder,
                                        'valid_results.json'),
        '--device', args.device])
    with torch.no_grad():
        snapshot = copy.deepcopy(model)
    stats = eval_cli.evaluate_dataset_batched(eval_args, cfg, snapshot)
    del snapshot
    print(f'[validation] epoch {epoch} iteration {iteration}: '
          + json.dumps({k: v for k, v in stats.items()
                        if isinstance(v, float)}))
    return stats


def run(argv=None) -> Optional[Dict]:
    """Train as ``argv`` asks; returns the final state, the loader and the
    config, or None when no dataset is given."""
    args = parse_args(argv)

    from ..config import get_config
    from ..convert import load_reference_weights
    from ..data.loader import ClipLoader, shard_indices
    from ..data.ytvis import YTVISDataset
    from ..models.stmask import STMask, init_flax
    from ..parallel import initialize_multihost, rank, world_size
    from .loop import train
    from .schedule import autoscale

    cfg = get_config(args.config)
    if not args.no_autoscale:
        cfg = autoscale(cfg, args.batch_size)
    if args.lr is not None:
        cfg = cfg.replace(lr=args.lr)
    if args.max_iter is not None:
        cfg = cfg.replace(max_iter=args.max_iter)
    if args.img_w is not None:
        cfg = cfg.replace(img_w=args.img_w)
    if args.img_h is not None:
        cfg = cfg.replace(img_h=args.img_h)
    dev = initialize_multihost(device=args.device)

    if args.ann_file is None or args.img_prefix is None:
        print('No --ann_file/--img_prefix given; nothing to train on.',
              file=sys.stderr)
        return None

    dataset = YTVISDataset(args.ann_file, args.img_prefix)
    loader = ClipLoader(cfg, dataset, args.batch_size,
                        num_workers=args.num_workers,
                        num_shards=world_size(), shard_id=rank(),
                        image_u8=True)
    model = init_flax(STMask(cfg), torch.Generator().manual_seed(0))
    if args.init_weights:
        if not args.init_weights.endswith('.pth'):
            raise ValueError(f'--init_weights {args.init_weights}: a '
                             'reference-keyed .pth is needed')
        kept, dropped = load_reference_weights(model, args.init_weights)
        print(f'--init_weights {args.init_weights}: {len(kept)} tensors '
              f'keep their initial values, {len(dropped)} unused')

    def valid(mdl, epoch, iteration):
        if not args.valid_ann_file:
            return None
        return validate(args, cfg, mdl, epoch, iteration)

    shard = shard_indices(loader.index, 0, world_size(), rank())
    state = train(cfg, model, loader.epoch,
                  max(1, len(shard) // args.batch_size),
                  args.save_folder, args.log_folder,
                  save_interval=args.save_interval,
                  keep_latest=args.keep_latest, resume=args.resume,
                  device=dev, validate=valid,
                  validation_epoch=args.validation_epoch,
                  session_data={'args': vars(args), 'config': cfg.name},
                  vis_every=args.vis_every, vis_dir=args.vis_dir)
    t = loader.timing
    n = max(t['batches'], 1)
    print(f'[data] {int(t["batches"])} batches of {args.batch_size} clips; '
          f'worker ms a batch: decode {t["decode"] * 1e3 / n:.1f}, '
          f'preprocess {t["preprocess"] * 1e3 / n:.1f}; collate '
          f'{t["collate"] * 1e3 / n:.1f}')
    return {'state': state, 'loader': loader, 'cfg': cfg}


def main(argv=None) -> int:
    try:
        return 0 if run(argv) is not None else 2
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == '__main__':
    sys.exit(main())
