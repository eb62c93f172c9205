#!/usr/bin/env python
"""End-to-end sanity: overfit on synthetic videos, then eval mAP (port of
``scripts/overfit_sanity.py``).

    python -m stmask_torch.overfit_sanity [--steps 400] [--out DIR]

Writes a tiny synthetic YouTube-VIS set (4 videos x 8 JPEG frames at
360x640: two coloured boxes moving over noise, seed 0), trains the full
``STMask_plus_resnet50`` from seeded initial weights drawn as the JAX
package's flax init draws them (``models.stmask.init_flax``) for a few
hundred steps with trainable BN affine and a gradient clip, runs the
batched eval over the training videos and scores them with the
YouTube-VIS evaluator.  A healthy port overfits to a high mAP (PASS at
mAP > 0.3); this exercises the loader, the matcher, the losses, the
optimizer, NMS, tracking, postprocess and the evaluator in one loop.
It runs on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def make_dataset(root: str, n_videos: int = 4, n_frames: int = 8,
                 h: int = 360, w: int = 640, seed: int = 0):
    """The synthetic set, byte for byte the JAX script's: (ann_file,
    img_prefix).  Each video holds two boxes (red, blue) of 70-120 pixels
    that move a few pixels a frame over uniform noise in [0, 80)."""
    import cv2
    from .utils import rle

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, 'imgs')
    os.makedirs(img_dir, exist_ok=True)
    videos, annotations = [], []
    aid = 1
    colors = [(230, 60, 40), (40, 90, 230)]
    for vid in range(1, n_videos + 1):
        names = []
        objs = []
        for _ in range(2):
            x0 = rng.randint(30, w - 200)
            y0 = rng.randint(30, h - 160)
            vx, vy = rng.randint(-8, 9), rng.randint(-5, 6)
            size = rng.randint(70, 120)
            objs.append([x0, y0, vx, vy, size])
        frames_ann = [[] for _ in range(2)]
        os.makedirs(os.path.join(img_dir, f'v{vid:02d}'), exist_ok=True)
        for f in range(n_frames):
            img = rng.randint(0, 80, (h, w, 3), np.uint8)
            for obj, (x0, y0, vx, vy, size) in enumerate(objs):
                x = int(np.clip(x0 + vx * f, 0, w - size - 1))
                y = int(np.clip(y0 + vy * f, 0, h - int(0.8 * size) - 1))
                hh = int(0.8 * size)
                img[y:y + hh, x:x + size] = colors[obj]
                m = np.zeros((h, w), np.uint8)
                m[y:y + hh, x:x + size] = 1
                frames_ann[obj].append((rle.encode(m), [x, y, size, hh]))
            name = f'v{vid:02d}/f{f:02d}.jpg'
            cv2.imwrite(os.path.join(img_dir, name),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            names.append(name)
        videos.append({'id': vid, 'file_names': names, 'height': h,
                       'width': w})
        for obj in range(2):
            annotations.append({
                'id': aid, 'video_id': vid, 'category_id': obj + 1,
                'segmentations': [s for s, _ in frames_ann[obj]],
                'bboxes': [b for _, b in frames_ann[obj]],
            })
            aid += 1
    ann = {'videos': videos, 'annotations': annotations,
           'categories': [{'id': 1, 'name': 'red_box'},
                          {'id': 2, 'name': 'blue_box'}]}
    ann_file = os.path.join(root, 'train.json')
    with open(ann_file, 'w') as fjson:
        json.dump(ann, fjson)
    return ann_file, img_dir


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='overfit sanity check')
    p.add_argument('--steps', type=int, default=400)
    p.add_argument('--batch_size', type=int, default=4)
    p.add_argument('--lr', type=float, default=2e-3)
    p.add_argument('--out', default=os.path.join(tempfile.gettempdir(),
                                                 'overfit_sanity'))
    p.add_argument('--save_ckpt', action='store_true',
                   help='write the trained weights to <out>/<config>_0_'
                        '<steps>.pth (loads with stmask_torch.eval '
                        '--trained_model)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    p.add_argument('--img_w', type=int, default=None)
    p.add_argument('--img_h', type=int, default=None)
    p.add_argument('--debug_nans', action='store_true',
                   help='autograd anomaly detection')
    p.add_argument('--bf16', action='store_true',
                   help='bf16 training (not ported: raises)')
    p.add_argument('--config', default='STMask_plus_resnet50')
    p.add_argument('--remat', action='store_true',
                   help='rematerialized forward (not ported: raises)')
    args = p.parse_args(argv)
    if args.bf16 or args.remat:
        raise NotImplementedError('--bf16 and --remat: bf16 training and '
                                  'remat are not ported (ROADMAP A.9c)')
    return args


def main(argv=None) -> None:
    """Train, evaluate and print PASS or WEAK."""
    args = parse_args(argv)

    import torch

    from . import eval as eval_cli
    from .config import get_config
    from .data.loader import ClipLoader
    from .data.ytvis import YTVISDataset
    from .models.stmask import STMask, init_flax
    from .train.checkpoint import ckpt_name
    from .train.train_step import build_train_step
    from .utils.device import resolve_device
    from .utils.hostguard import wait_for_quiet_host

    print('[hostguard]', json.dumps(wait_for_quiet_host(max_wait_s=300.0)),
          flush=True)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    ann_file, img_prefix = make_dataset(args.out)

    cfg = get_config(args.config).replace(
        lr=args.lr, lr_warmup_until=100, lr_steps=(10 ** 9,),
        max_iter=args.steps,
        # from scratch: the BN affine learns (the statistics stay frozen)
        freeze_bn=False,
        # from scratch at this lr the run sits at the edge of stability; a
        # real clip keeps it there (the presets keep the reference's no-op
        # clip, since they fine-tune from pretrained weights)
        grad_clip_norm=1e3)
    if args.img_w:
        cfg = cfg.replace(img_w=args.img_w)
    if args.img_h:
        cfg = cfg.replace(img_h=args.img_h)
    dataset = YTVISDataset(ann_file, img_prefix)
    loader = ClipLoader(cfg, dataset, args.batch_size, num_workers=8)

    model = init_flax(STMask(cfg), torch.Generator().manual_seed(0))
    train_step, init_state = build_train_step(cfg, model, dev)
    state = init_state()

    it = 0
    t0 = time.perf_counter()
    while it < args.steps:
        for batch in loader.epoch(it):
            if it >= args.steps:
                break
            batch = {k: torch.from_numpy(v).to(dev, non_blocking=True)
                     for k, v in batch.items()}
            state, metrics = train_step(state, batch)
            it += 1
            if it % 25 == 0 or it == 1:
                total = float(metrics['total'])
                parts = ' '.join(
                    f'{k}:{float(v):.2f}' for k, v in sorted(metrics.items())
                    if k not in ('total', 'lr'))
                print(f'[{it:5d}] total={total:.3f} | {parts} | '
                      f'{(time.perf_counter() - t0) / it:.2f}s/it',
                      flush=True)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0

    if args.save_ckpt:
        path = os.path.join(os.path.abspath(args.out),
                            ckpt_name(cfg.name, 0, it) + '.pth')
        torch.save(model.state_dict(), path)
        print('saved the weights to', path)

    # ---- eval on the training videos (the overfit check) ----
    eval_args = eval_cli.parse_args([
        '--ann_file', ann_file, '--img_prefix', img_prefix,
        '--eval_metrics', '--device', args.device, '--mask_det_file',
        os.path.join(args.out, 'results.json')])
    stats = eval_cli.evaluate_dataset_batched(eval_args, cfg, model)
    print('OVERFIT SANITY:', json.dumps(
        {k: v for k, v in stats.items() if not isinstance(v, dict)}))
    ok = stats is not None and stats['mAP'] > 0.3
    print('PASS' if ok else 'WEAK', '- mAP', stats['mAP'] if stats else None,
          f'- {it} steps in {train_s:.1f} s of training')


if __name__ == '__main__':
    main()
