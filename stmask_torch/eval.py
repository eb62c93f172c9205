#!/usr/bin/env python
"""The port's evaluation script (the counterpart of the JAX package's
``eval.py``):

    python -m stmask_torch.eval --ann_file A --img_prefix P [--eval_metrics]

By default it steps 8 videos in lockstep, 4 frames a dispatch, in bf16
(``evaluate_dataset_batched``, ``eval.py:237-395``): a thread pool decodes
frames and postprocesses results, and a queue of depth 2 lets the fetch of
chunk N overlap the compute of chunk N+1.  It writes a YouTube-VIS results
JSON and, with ``--eval_metrics``, scores it against the annotations.
Every mode of the JAX script is ported, with its routing
(``eval.py:520-556``):

* ``--coco``: the batched path over a COCO instance file, each image a
  one-frame video, scored against ``COCOAsVideos.to_ytvis_gt``;
* ``--sequential``, ``--benchmark``, ``--display`` (with
  ``--display_lincomb``, ``--display_fpn_outs``): one video at a time in
  the parameters' dtype, fp32 (``evaluate_dataset``); ``--benchmark``
  prints the stage table and ``FPS:`` and writes no JSON; ``--display``
  writes overlays to ``--display_dir`` (what ``web/server.py --image_dir``
  serves);
* ``--video_dir D``: one directory of frames as one video, fp32;
* ``--metrics_only``: scores an existing results file, and with
  ``--tensorboard_dir`` writes the metrics as TensorBoard scalars.

The model runs on ``--device`` (default ``cuda``, which raises on a host
without a GPU).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

def parse_args(argv=None):
    p = argparse.ArgumentParser(description='stmask_torch evaluation')
    p.add_argument('--config', default=None)
    p.add_argument('--trained_model', default=None,
                   help="the port's checkpoint (train/checkpoint.py) or a "
                        'reference-keyed state_dict (.pth)')
    p.add_argument('--ann_file', default=None)
    p.add_argument('--img_prefix', default=None)
    p.add_argument('--mask_det_file', default='results/results.json')
    p.add_argument('--benchmark', action='store_true',
                   help='frames/s after 5 warm-up frames and a table of the '
                        'load, step and postprocess stages (sequential, '
                        'fp32; no JSON)')
    p.add_argument('--metrics_only', action='store_true')
    p.add_argument('--eval_metrics', action='store_true',
                   help='score results against --ann_file annotations')
    p.add_argument('--max_videos', type=int, default=-1)
    p.add_argument('--score_threshold', type=float, default=0.0)
    p.add_argument('--video_dir', default=None,
                   help='directory of frames (*.jpg, *.jpeg, *.png) for a '
                        'single video')
    p.add_argument('--display', action='store_true',
                   help='write detection overlays to --display_dir')
    p.add_argument('--display_lincomb', action='store_true',
                   help='with --display, also write the prototype '
                        'linear-combination breakdown of the top detection '
                        '(reference eval.py:91, output_utils.py:168)')
    p.add_argument('--display_fpn_outs', action='store_true',
                   help='with --display, also write channel-activation '
                        'grids of each FPN level (reference eval.py:65, '
                        'output_utils.py:225-244)')
    p.add_argument('--display_dir', default='results/display')
    p.add_argument('--batch_videos', type=int, default=8,
                   help='video streams stepped in lockstep')
    p.add_argument('--chunk_frames', type=int, default=4,
                   help='frames per dispatch')
    p.add_argument('--sequential', action='store_true',
                   help='one video at a time, in fp32')
    p.add_argument('--bf16', action='store_true', default=True,
                   help='the batched path\'s compute dtype (default)')
    p.add_argument('--fp32', dest='bf16', action='store_false')
    p.add_argument('--coco', action='store_true',
                   help='image-level COCO eval (images as 1-frame videos)')
    p.add_argument('--time_device', action='store_true',
                   help='wait for every dispatch to report device-only '
                        'frames/s (no host/device overlap)')
    p.add_argument('--img_w', type=int, default=None,
                   help='override the input width')
    p.add_argument('--img_h', type=int, default=None)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    p.add_argument('--nms', default=None,
                   choices=['cc', 'per_class', 'greedy'],
                   help="NMS family: 'cc' = cross-class fast NMS (mAP), "
                        "'per_class' = fast NMS (mAP*), 'greedy' = exact "
                        "sequential Cython-parity NMS (kernel B5 on the "
                        "card)")
    p.add_argument('--nms_as_miou', action='store_true',
                   help='blend box IoU with mask IoU in cc NMS '
                        '(reference detection.py:154-158)')
    p.add_argument('--tensorboard_dir', default=None,
                   help='with --metrics_only, also write the metrics as '
                        'TensorBoard scalars (reference eval.py:850-852)')
    return p.parse_args(argv)


def load_model(args):
    """(cfg, model): the config from --config, else from the checkpoint's
    name, else the flagship; weights from --trained_model, else seeded
    random ones (``models.init_random``, seed 0)."""
    from .config import config_from_checkpoint_name, get_config
    from .models.stmask import STMask, init_random

    cfg = None
    if args.config:
        cfg = get_config(args.config)
    elif args.trained_model:
        cfg = config_from_checkpoint_name(args.trained_model)
    if cfg is None:
        cfg = get_config('STMask_plus_resnet50')
        print(f'No config resolved; defaulting to {cfg.name}')
    if args.nms:
        cfg = cfg.replace(eval_nms_method=args.nms)
    if args.nms_as_miou:
        cfg = cfg.replace(nms_as_miou=True)
    if args.img_w:
        cfg = cfg.replace(img_w=args.img_w)
    if args.img_h:
        cfg = cfg.replace(img_h=args.img_h)

    model = STMask(cfg)
    if args.trained_model:
        saved = torch.load(args.trained_model, map_location='cpu',
                           weights_only=True)
        state = saved['model'] if 'model' in saved else saved
        missing, unexpected = model.load_state_dict(state, strict=False)
        if missing:
            raise KeyError(f'{args.trained_model} lacks {len(missing)} of '
                           f"the model's tensors, e.g. {missing[:3]}")
        if unexpected:
            print(f'{args.trained_model}: {len(unexpected)} tensors the '
                  f'model does not use, e.g. {unexpected[:3]}')
    else:
        init_random(model, torch.Generator().manual_seed(0))
    return cfg, model.eval()


def _dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.bf16 else torch.float32


def _sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _decode(path: str, pin: bool) -> torch.Tensor:
    """A frame file -> uint8 [H, W, 3] RGB, in pinned memory when it goes
    to the card (so that its upload does not wait for the device)."""
    from .data.image_io import load_image_rgb
    img = torch.from_numpy(load_image_rgb(path))
    return img.pin_memory() if pin else img


def _score(args, json_results, fps: Dict,
           gt: Optional[Dict] = None) -> Dict:
    """With ``--eval_metrics``, the metrics of ``json_results`` against
    ``gt`` (default: the ``--ann_file`` annotations) and ``fps``."""
    if not args.eval_metrics:
        return fps
    from .utils.ytvis_eval import evaluate_ytvis
    if gt is None:
        with open(args.ann_file) as fh:
            gt = json.load(fh)
    stats = evaluate_ytvis(gt, json_results)
    print(json.dumps(stats, indent=2))
    return dict(stats, **fps)


def _write_display(args, cfg, pre: Dict, out, vid: int, f: int) -> None:
    """One frame's tracked detections drawn on its resized frame, to
    ``{display_dir}/{vid:05d}_{f:04d}.png`` (``--display`` and the web
    viewer; ``eval.py:121-146``)."""
    import cv2

    from .utils.visualization import draw_detections
    os.makedirs(args.display_dir, exist_ok=True)
    keep = np.asarray(out.keep)
    img_h, img_w = pre['img_shape']
    img = pre['image'].cpu().numpy()[:img_h, :img_w]     # uint8 RGB
    idx = np.nonzero(keep)[0]
    pad_h, pad_w = pre['pad_shape']
    boxes = np.asarray(out.box)[idx] * [pad_w, pad_h, pad_w, pad_h]
    masks = np.asarray(out.mask)[idx]
    masks_up = np.stack([
        cv2.resize(m.astype(np.float32), (img_w, img_h)) > 0.5
        for m in masks]) if len(idx) else None
    over = draw_detections(img, boxes, np.asarray(out.cls)[idx],
                           np.asarray(out.score)[idx], masks_up,
                           np.asarray(out.obj_id)[idx], cfg.classes)
    cv2.imwrite(os.path.join(args.display_dir, f'{vid:05d}_{f:04d}.png'),
                cv2.cvtColor(over, cv2.COLOR_RGB2BGR))


def _write_grids(args, sub: str, grids: Dict[str, np.ndarray], vid: int,
                 f: int) -> None:
    """Each grid min-max scaled to 8-bit grey, to
    ``{display_dir}/{sub}/{vid:05d}_{f:04d}_{name}.png``."""
    import cv2
    out_dir = os.path.join(args.display_dir, sub)
    os.makedirs(out_dir, exist_ok=True)
    for name, g in grids.items():
        gmin, gmax = float(g.min()), float(g.max())
        img = ((g - gmin) / max(gmax - gmin, 1e-6) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(out_dir, f'{vid:05d}_{f:04d}_{name}.png'),
                    img)


def _write_lincomb(args, dbg: Dict, vid: int, f: int) -> None:
    """The prototype linear-combination breakdown of the frame's top
    detection (``--display_lincomb``, ``eval.py:149-167``; reference
    output_utils.py:168)."""
    from .utils.visualization import display_lincomb
    valid = dbg['det_valid'].cpu().numpy()
    if not valid.any():
        return
    top = int(np.nonzero(valid)[0][0])
    coeff = np.tanh(dbg['mask_coeff'][top].float().cpu().numpy())
    _write_grids(args, 'proto', display_lincomb(
        dbg['proto'].float().cpu().numpy(), coeff), vid, f)


def _write_fpn_outs(args, dbg: Dict, vid: int, f: int) -> None:
    """Channel-activation grids of each FPN level (``--display_fpn_outs``,
    ``eval.py:170-185``; reference output_utils.py:225-244)."""
    from .utils.visualization import display_fpn_outs
    _write_grids(args, 'fpn', display_fpn_outs(
        [x.float().cpu().numpy() for x in dbg['fpn_outs']]), vid, f)


def evaluate_dataset_batched(args, cfg, model) -> Dict:
    """Throughput eval: B lockstep video streams x K-frame chunks.

    The results equal those of ``evaluate_dataset`` (tracker state is per
    lane); a lane picks up the next video as soon as its current one ends,
    with ``is_first`` resetting its tracker mid-chunk."""
    from .data.transforms import preprocess_frame_u8
    from .data.ytvis import YTVISDataset
    from .inference.fetch import KeptFetch, compact_frame
    from .inference.pipeline import build_video_step_batched
    from .inference.postprocess import postprocess_frame, \
        results2json_videoseg
    from .utils.device import resolve_device

    dev = resolve_device(args.device)
    b, k = args.batch_videos, args.chunk_frames
    if args.coco:
        from .data.coco import COCOAsVideos, COCODataset
        dataset = COCOAsVideos(COCODataset(
            args.ann_file, args.img_prefix,
            has_annotations=args.eval_metrics))
    else:
        dataset = YTVISDataset(args.ann_file, args.img_prefix,
                               has_annotations=args.eval_metrics)
    video_chunk, make_states = build_video_step_batched(
        cfg, model, b, k, uint8_input=True, device=dev,
        compute_dtype=_dtype(args))
    states = make_states()

    vids = dataset.video_ids()
    if args.max_videos > 0:
        vids = vids[:args.max_videos]
    queue = list(vids)
    lanes: List[Optional[list]] = [None] * b   # [vid, next_frame, n_frames]
    pool = ThreadPoolExecutor(16)
    pin = dev.type == 'cuda'

    def next_chunk():
        """[K, B] uint8 frames on the device + flags + metas; None marks an
        inactive lane."""
        frames = torch.zeros((k, b, cfg.img_h, cfg.img_w, 3),
                             dtype=torch.uint8, device=dev)
        first = np.zeros((k, b), bool)
        metas = [[None] * b for _ in range(k)]
        jobs = {}
        for step in range(k):
            for lane in range(b):
                if lanes[lane] is None or lanes[lane][1] >= lanes[lane][2]:
                    if not queue:
                        lanes[lane] = None
                        continue
                    vid = queue.pop(0)
                    lanes[lane] = [vid, 0, dataset.num_frames(vid)]
                vid, f, _ = lanes[lane]
                jobs[(step, lane)] = pool.submit(
                    _decode, dataset.frame_path(vid, f), pin)
                first[step, lane] = f == 0
                metas[step][lane] = {'video_id': vid, 'frame_id': f}
                lanes[lane][1] += 1
        if not jobs:
            return None
        for (step, lane), fut in jobs.items():
            pre = preprocess_frame_u8(cfg, fut.result(), dev)
            frames[step, lane] = pre['image']
            metas[step][lane].update(img_shape=pre['img_shape'],
                                     pad_shape=pre['pad_shape'])
        return frames, torch.from_numpy(first), metas

    # one dispatch before the clock starts: kernel builds, cuDNN's choices
    # and the allocator's first blocks.  Every video's first frame has
    # is_first set, so the warm-up leaves no trace in the results.
    states, warm = video_chunk(
        states, torch.zeros((k, b, cfg.img_h, cfg.img_w, 3),
                            dtype=torch.uint8, device=dev),
        torch.zeros((k, b), dtype=torch.bool))
    _sync(dev)
    del warm

    per_frame = []
    # the main thread's seconds in each stage (the pool's work overlaps
    # them; what the main thread waits for shows where the wall goes)
    host = dict.fromkeys(('next_chunk', 'dispatch', 'fetch', 'postprocess'),
                         0.0)

    def timed(stage, fn, *fn_args):
        t = time.perf_counter()
        out = fn(*fn_args)
        host[stage] += time.perf_counter() - t
        return out

    def drain(fetch: KeptFetch, metas) -> int:
        """Fetch one chunk's kept outputs and postprocess them in the
        pool."""
        small, keep_idx, kept = timed('fetch', fetch.result)
        todo = [(compact_frame(small, keep_idx, kept, lead=(step, lane)),
                 metas[step][lane])
                for step in range(k) for lane in range(b)
                if metas[step][lane] is not None]
        per_frame.extend(timed('postprocess', lambda: list(pool.map(
            lambda fm: postprocess_frame(
                cfg, fm[0], fm[1], score_threshold=args.score_threshold),
            todo))))
        return len(todo)

    t0 = time.perf_counter()
    n_frames, n_chunks, device_s = 0, 0, 0.0
    pending = deque()
    chunk = timed('next_chunk', next_chunk)
    while chunk is not None or pending:
        if chunk is not None and (len(pending) < 2 or args.time_device):
            frames, first, metas = chunk
            td = time.perf_counter()
            states, outs = timed('dispatch', video_chunk, states, frames,
                                 first)
            if args.time_device:
                _sync(dev)
                device_s += time.perf_counter() - td
            pending.append((KeptFetch(outs), metas))
            n_chunks += 1
            # decode the next chunk meanwhile
            chunk = timed('next_chunk', next_chunk)
            if chunk is not None and len(pending) < 2:
                continue
        n_frames += drain(*pending.popleft())
    pool.shutdown()

    dt = time.perf_counter() - t0
    fps = {'e2e_fps': n_frames / dt, 'n_frames': n_frames,
           'n_chunks': n_chunks, 'seconds': dt,
           'host_ms_per_chunk': {st: v * 1e3 / n_chunks
                                 for st, v in host.items()}}
    print(f'{n_frames} frames in {dt:.1f}s = {n_frames / dt:.1f} frames/s '
          '(end to end: decode, resize, device, postprocess); main thread '
          'ms a chunk: ' + ', '.join(
              f'{st} {v:.1f}' for st, v in fps['host_ms_per_chunk'].items()))
    if args.time_device and device_s > 0:
        # each dispatch steps all K x B lane-frames, inactive lanes too
        fps['device_fps'] = n_frames / device_s
        fps['device_ms_per_chunk'] = device_s * 1e3 / n_chunks
        print(f'device-only: {device_s:.1f}s = {fps["device_fps"]:.1f} '
              f'frames/s, {fps["device_ms_per_chunk"]:.3f} ms a chunk')

    # the JSON writer expects each video's frames together and in order
    per_frame.sort(key=lambda r: (r['video_id'], r['frame_id']))
    json_results = results2json_videoseg(per_frame, args.mask_det_file)
    print(f'wrote {len(json_results)} tracks to {args.mask_det_file}')
    gt = dataset.to_ytvis_gt() if args.coco and args.eval_metrics else None
    return _score(args, json_results, fps, gt)


def _sequential_frame(args, cfg, video_step, state, path: str, vid: int,
                      f: int, dev: torch.device, timer):
    """One frame of the sequential eval loops: decode and preprocess (stage
    ``load`` of ``timer``), the step (``step``), the fetch of the kept rows
    and their postprocess (``postprocess``); then, with ``--display``, the
    overlay and the grids of the step's debug dict, where the step returns
    one.  Returns (state, the frame's result)."""
    from .data.transforms import preprocess_frame_u8
    from .inference.fetch import compact_frame, fetch_kept
    from .inference.postprocess import postprocess_frame

    with timer.env('load'):
        pre = preprocess_frame_u8(cfg, _decode(path, dev.type == 'cuda'), dev)
    with timer.env('step'):
        state, out, *dbg = video_step(state, pre['image'], f == 0)
    with timer.env('postprocess'):
        # only the kept rows' masks leave the device
        out = compact_frame(*fetch_kept(out))
        meta = {'video_id': vid, 'frame_id': f,
                'img_shape': pre['img_shape'], 'pad_shape': pre['pad_shape']}
        result = postprocess_frame(cfg, out, meta,
                                   score_threshold=args.score_threshold)
    if args.display:
        _write_display(args, cfg, pre, out, vid, f)
        if dbg and args.display_lincomb:
            _write_lincomb(args, dbg[0], vid, f)
        if dbg and args.display_fpn_outs:
            _write_fpn_outs(args, dbg[0], vid, f)
    return state, result


def evaluate_dataset(args, cfg, model) -> Dict:
    """One video at a time, one frame a dispatch (``eval.py:398-480``), in
    the parameters' dtype, fp32, whatever ``--bf16`` says: the JAX script
    casts nothing here.  Host time per stage (load, step, postprocess)
    goes into a ``StageTimer``; with ``--display`` each frame's overlay
    (and the ``--display_lincomb`` / ``--display_fpn_outs`` grids) is
    written.  ``--benchmark`` starts its clock after frame 5, stops after
    the first video that brings the count to 300 frames, prints the stage
    table and ``FPS:``, writes no JSON and returns {'fps', 'n_frames',
    'stages'}; otherwise the JSON is written and the frames/s (and, with
    ``--eval_metrics``, the metrics) are returned."""
    from .data.ytvis import YTVISDataset
    from .inference.pipeline import build_video_step
    from .inference.postprocess import results2json_videoseg
    from .utils.device import resolve_device
    from .utils.logger import StageTimer

    dev = resolve_device(args.device)
    dataset = YTVISDataset(args.ann_file, args.img_prefix,
                           has_annotations=args.eval_metrics)
    debug = args.display and args.display_lincomb
    debug_fpn = args.display and args.display_fpn_outs
    video_step, make_state = build_video_step(
        cfg, model, uint8_input=True, debug=debug, debug_fpn=debug_fpn,
        device=dev)
    timer = StageTimer()
    vids = dataset.video_ids()
    if args.max_videos > 0:
        vids = vids[:args.max_videos]

    results = []
    n_frames = 0
    t_start = None
    t0 = time.perf_counter()
    for vi, vid in enumerate(vids):
        state = make_state()
        nf = dataset.num_frames(vid)
        for f in range(nf):
            state, result = _sequential_frame(
                args, cfg, video_step, state, dataset.frame_path(vid, f),
                vid, f, dev, timer)
            results.append(result)
            n_frames += 1
            if args.benchmark and n_frames == 5:
                t_start = time.perf_counter()      # warm-up excluded
        print(f'video {vi + 1}/{len(vids)} ({nf} frames) done')
        if args.benchmark and n_frames >= 300:
            break

    if args.benchmark and t_start is not None:
        fps = (n_frames - 5) / (time.perf_counter() - t_start)
        timer.print_stats()
        print(f'FPS: {fps:.2f}')
        return {'fps': fps, 'n_frames': n_frames, 'stages': timer.stats()}

    dt = time.perf_counter() - t0
    json_results = results2json_videoseg(results, args.mask_det_file)
    print(f'wrote {len(json_results)} tracks to {args.mask_det_file}')
    return _score(args, json_results, {'e2e_fps': n_frames / dt,
                                       'n_frames': n_frames, 'seconds': dt})


def evaluate_video_dir(args, cfg, model) -> Dict:
    """Single-video mode: the ``*.jpg``, ``*.jpeg`` and ``*.png`` frames of
    ``--video_dir``, sorted, as video 0, in the parameters' dtype (fp32)
    -> the results JSON and, with ``--display``, overlays
    (``eval.py:483-517``; reference evaluate_single / evalimages,
    eval.py:703-755).  Returns the frame count and frames/s end to end."""
    from .inference.pipeline import build_video_step
    from .inference.postprocess import results2json_videoseg
    from .utils.device import resolve_device
    from .utils.logger import StageTimer

    frames = sorted(sum((glob.glob(os.path.join(args.video_dir, ext))
                         for ext in ('*.jpg', '*.jpeg', '*.png')), []))
    if not frames:
        print('no frames found in', args.video_dir)
        return {'n_frames': 0}
    dev = resolve_device(args.device)
    video_step, make_state = build_video_step(cfg, model, uint8_input=True,
                                              device=dev)
    state = make_state()
    timer = StageTimer()
    results = []
    t0 = time.perf_counter()
    for f, path in enumerate(frames):
        state, result = _sequential_frame(args, cfg, video_step, state,
                                          path, 0, f, dev, timer)
        results.append(result)
    dt = time.perf_counter() - t0
    results2json_videoseg(results, args.mask_det_file)
    print(f'processed {len(frames)} frames -> {args.mask_det_file}')
    return {'e2e_fps': len(frames) / dt, 'n_frames': len(frames),
            'seconds': dt}


def _export_scalars(log_dir: str, stats: Dict) -> None:
    """The metrics as TensorBoard scalars ``valid_metrics/{name}`` at step
    1 (reference eval.py:850-852); skipped, as the JAX script does, where
    TensorBoard does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print('tensorboard not available; skipping scalar export',
              file=sys.stderr)
        return
    writer = SummaryWriter(log_dir=log_dir, filename_suffix='VIS')
    for name, value in stats.items():
        writer.add_scalar(f'valid_metrics/{name}', value, 1)
    writer.close()


def evaluate(argv=None) -> Dict:
    """Parse ``argv`` and run the mode it asks for, routed as
    ``eval.py:520-556`` routes it; returns the metrics and frames/s (or,
    under ``--benchmark``, the FPS and the stage table) as a dict."""
    args = parse_args(argv)
    if args.metrics_only:
        from .utils.ytvis_eval import evaluate_ytvis
        stats = evaluate_ytvis(args.ann_file, args.mask_det_file)
        print(json.dumps(stats, indent=2))
        if args.tensorboard_dir:
            _export_scalars(args.tensorboard_dir, stats)
        return stats
    if args.video_dir is not None:
        cfg, model = load_model(args)
        return evaluate_video_dir(args, cfg, model)
    if args.ann_file is None:
        raise SystemExit('need --ann_file (and --img_prefix) for dataset '
                         'eval')
    cfg, model = load_model(args)
    if args.sequential or args.benchmark or args.display:
        return evaluate_dataset(args, cfg, model)
    return evaluate_dataset_batched(args, cfg, model)


def main(argv=None) -> int:
    evaluate(argv)
    return 0


if __name__ == '__main__':
    sys.exit(main())
