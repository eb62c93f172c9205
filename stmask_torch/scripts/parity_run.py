"""Real-data mAP parity runbook (the counterpart of the JAX package's
``scripts/parity_run.py``):

    python -m stmask_torch.scripts.parity_run --pth STMask_plus_resnet50.pth
        --ann_file .../valid.json --img_prefix .../valid/JPEGImages
        [--device cuda|cpu]

It (1) converts the released ``.pth`` with ``convert_weights`` (or takes
the port's own checkpoint, ``--trained_model``), (2) runs the eval CLI's
batched evaluation in process twice, cross-class fast NMS (``--nms cc``, the
reference's mAP) and per-class fast NMS (``--nms per_class``, mAP*), and a
third time with exact greedy NMS under ``--with_greedy``, writing each
results JSON, (3) scores them with ``utils/ytvis_eval.py`` when the
annotation file has annotations, and (4) prints the table against the
config's BASELINE.md row.  The official YouTube-VIS 2019 ``valid`` split
has no public annotations: point ``--ann_file`` at an annotated held-out
split, or pass ``--no_metrics`` and submit the JSONs.  ``--dryrun`` runs
the whole runbook on the synthetic overfit set
(``stmask_torch.overfit_sanity.make_dataset``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

# BASELINE.md rows keyed by config name: (mask mAP [cc], mAP* [per-class])
BASELINE_ROWS = {
    'STMask_plus_resnet50': (32.6, 33.4),
    'STMask_plus_resnet50_ali': (None, 32.1),
    'STMask_plus_resnet50_ada': (32.8, 33.0),
    'STMask_plus_base': (36.0, 36.3),
    'STMask_plus_base_ali': (36.3, 37.1),
    'STMask_plus_base_ada': (36.8, 37.9),
    'STMask_plus_resnet50_YTVIS2021': (None, 30.6),
    'STMask_plus_resnet50_ada_YTVIS2021': (None, 31.1),
    'STMask_plus_base_YTVIS2021': (None, 33.7),
    'STMask_plus_base_ada_YTVIS2021': (None, 34.6),
    'STMask_plus_resnet50_OVIS': (None, 15.4),
    'STMask_plus_resnet50_ada_OVIS': (None, 15.4),
    'STMask_plus_base_OVIS': (None, 17.3),
    'STMask_plus_base_ada_OVIS': (None, 15.8),
}


def parse_args(argv=None):
    from ._common import add_device
    ap = argparse.ArgumentParser()
    ap.add_argument('--pth', default=None,
                    help='released torch checkpoint (.pth); converted on '
                         'the fly, config inferred from the filename')
    ap.add_argument('--trained_model', default=None,
                    help="alternative: the port's own checkpoint")
    ap.add_argument('--config', default=None)
    ap.add_argument('--ann_file', default=None)
    ap.add_argument('--img_prefix', default=None)
    ap.add_argument('--out_dir', default='results/parity')
    ap.add_argument('--max_videos', type=int, default=-1)
    ap.add_argument('--batch_videos', type=int, default=8)
    ap.add_argument('--fp32', action='store_true',
                    help='fp32 forward (default bf16; use for strictest '
                         'numerical parity runs)')
    ap.add_argument('--no_metrics', dest='eval_metrics',
                    action='store_false', default=True,
                    help="only write the results JSONs (e.g. for the "
                         "YTVIS eval server's unannotated valid split)")
    ap.add_argument('--with_greedy', action='store_true',
                    help='add a third pass with exact sequential greedy '
                         'NMS; no published baseline column')
    ap.add_argument('--dryrun', action='store_true',
                    help='run on the synthetic overfit dataset (no real '
                         'data needed; exercises the whole runbook)')
    ap.add_argument('--img_w', type=int, default=None,
                    help='input-size override (small-scale dryruns)')
    ap.add_argument('--img_h', type=int, default=None)
    add_device(ap)
    return ap.parse_args(argv)


def _convert(args) -> str:
    """The released ``.pth`` as the port's checkpoint under ``--out_dir``,
    keeping its file name (the eval CLI infers the config from it)."""
    from ..config import config_from_checkpoint_name, get_config
    from .convert_weights import run as convert
    cfg = (get_config(args.config) if args.config else
           config_from_checkpoint_name(args.pth)
           or get_config('STMask_plus_resnet50'))
    out = os.path.join(args.out_dir, 'converted',
                       os.path.basename(args.pth))
    convert(cfg, args.pth, out)
    return out


def dryrun_set(h: int, w: int):
    """(annotation file, image prefix) of the synthetic overfit set: 4
    videos x 8 frames at 360x640 (``overfit_sanity.make_dataset``, whose
    boxes need that size), with the gt drawn at the model's input size h x
    w, where the eval CLI writes its masks (ROADMAP C.2)."""
    import cv2
    import numpy as np

    from ..overfit_sanity import make_dataset
    from ..utils import rle
    root = os.path.join(tempfile.gettempdir(), 'stmask_parity_dryrun')
    ann = os.path.join(root, 'train.json')
    if not os.path.exists(ann):
        make_dataset(root, n_videos=4, n_frames=8)
    scaled = os.path.join(root, f'train_{h}x{w}.json')
    if not os.path.exists(scaled):
        with open(ann) as fh:
            data = json.load(fh)
        for v in data['videos']:
            sy, sx = h / v['height'], w / v['width']
            v['height'], v['width'] = h, w
        for a in data['annotations']:
            a['segmentations'] = [rle.encode(np.ascontiguousarray(cv2.resize(
                rle.decode(s), (w, h), interpolation=cv2.INTER_NEAREST)))
                for s in a['segmentations']]
            a['bboxes'] = [[b[0] * sx, b[1] * sy, b[2] * sx, b[3] * sy]
                           for b in a['bboxes']]
        with open(scaled, 'w') as fh:
            json.dump(data, fh)
    return scaled, os.path.join(root, 'imgs')


def run_eval(args, nms: str, out_json: str):
    """One pass of the eval CLI's batched evaluation; returns (cfg, stats)."""
    from .. import eval as t_eval
    argv = ['--ann_file', args.ann_file, '--img_prefix', args.img_prefix,
            '--mask_det_file', out_json, '--nms', nms,
            '--batch_videos', str(args.batch_videos),
            '--device', args.device]
    for flag, value in (('--trained_model', args.trained_model),
                        ('--config', args.config),
                        ('--img_w', args.img_w), ('--img_h', args.img_h)):
        if value:
            argv += [flag, str(value)]
    if args.max_videos > 0:
        argv += ['--max_videos', str(args.max_videos)]
    if args.eval_metrics:
        argv += ['--eval_metrics']
    if args.fp32:
        argv += ['--fp32']
    ea = t_eval.parse_args(argv)
    cfg, model = t_eval.load_model(ea)
    stats = t_eval.evaluate_dataset_batched(ea, cfg, model)
    return cfg, (stats or {})


def run(args) -> dict:
    """The runbook for parsed ``args``; returns the summary written to
    ``parity_summary.json``."""
    from ..utils.device import resolve_device
    resolve_device(args.device)
    if args.dryrun and not args.ann_file:
        args.ann_file, args.img_prefix = dryrun_set(args.img_h or 360,
                                                    args.img_w or 640)
    if not args.ann_file or not args.img_prefix:
        raise SystemExit('need --ann_file and --img_prefix (or --dryrun)')
    os.makedirs(args.out_dir, exist_ok=True)
    if args.pth:
        args.trained_model = _convert(args)

    rows, cfg = [], None
    passes = [('mAP', 'cc'), ('mAP*', 'per_class')]
    if args.with_greedy:
        passes.append(('mAP(g)', 'greedy'))
    for label, nms in passes:
        out_json = os.path.join(args.out_dir, f'results_{nms}.json')
        print(f'=== eval with {nms} NMS -> {out_json}', flush=True)
        cfg, stats = run_eval(args, nms, out_json)
        rows.append((label, nms, out_json, stats.get('mAP', stats.get('AP'))))

    base = BASELINE_ROWS.get(cfg.name, (None, None))
    base = tuple(base) + (None,) * (len(rows) - len(base))
    print()
    print(f'config: {cfg.name}')
    print(f'{"metric":8s} {"nms":10s} {"measured":>9s} {"baseline":>9s} '
          f'{"diff":>7s}  results')
    summary = {}
    for (label, nms, out_json, measured), expect in zip(rows, base):
        m = f'{100 * measured:.1f}' if measured is not None else 'n/a'
        b = f'{expect:.1f}' if expect is not None else 'n/a'
        d = (f'{100 * measured - expect:+.1f}'
             if measured is not None and expect is not None else '')
        print(f'{label:8s} {nms:10s} {m:>9s} {b:>9s} {d:>7s}  {out_json}')
        summary[label] = {
            # both in mAP percentage points (the BASELINE.md unit)
            'measured': None if measured is None else 100 * measured,
            'baseline': expect, 'nms': nms, 'results': out_json}
    out = {'config': cfg.name, 'rows': summary}
    path = os.path.join(args.out_dir, 'parity_summary.json')
    with open(path, 'w') as fh:
        json.dump(out, fh, indent=2)
    print(f'summary -> {path}')
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == '__main__':
    sys.exit(main())
