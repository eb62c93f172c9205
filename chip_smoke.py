#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero):
  1. build the CUDA kernels from stmask_torch/kernels/csrc with nvcc (one
     process per source, in parallel) and print ptxas's registers, shared
     memory and spills of every kernel (K4 and deform_wgrad must not
     spill);
  2. the frame resize (``resize_u8``) on the card against the machine's cv2
     INTER_LINEAR, bit for bit, at the sizes of RESIZES; K1 (correlation)
     against its plain PyTorch version, main-path and ragged shapes, with
     fp32 and with bf16 inputs;
  3. K2 (deformable gather) against its plain version at the 7 DCN sites'
     shapes of a 384x640 input, alone and after the fp32 matmul; then the
     fused deformable conv against its plain version at the 7 sites and at
     ragged, rectangular and dilated shapes, at a tolerance that a single
     TF32 product (emulated at the 7 sites as a control) fails; then its
     bf16 variant at the 7 sites with 8 frames (the batched eval's shapes)
     and at ragged shapes, against the plain bf16 version; then the DCN
     weight gradient (deform_wgrad) against its plain version (K2's plain
     gather and an fp32 matmul) at the 7 sites x 8 frames with random, zero
     and integer offsets, at a tolerance that a single TF32 product
     (emulated as a control) fails, and at the shapes of K4_SHAPES, bit
     for bit the same over two launches;
  4. the eval video step of STMask_plus_resnet50 at 360x640 (seeded random
     weights, two synthetic 8-frame videos) through build_video_step,
     postprocess_frame and results2json_videoseg, with kernel launch
     counts (the DCN sites run the fused kernel, K2 not at all); the
     model's outputs are also held against the CPU path (the plain
     versions, which tests/ hold against the JAX package) on a small
     input; then a torch.profiler window over steady frames (device busy
     share, top kernels) and each stage's time on its own;
  5. kernel times (CUDA events) beside their plain versions and bounds;
     per DCN site the fused kernel beside K2 + matmul + bias (the path it
     replaced) and, as a size reference only, a dense cuDNN 3x3 conv; the
     bf16 K1 and the bf16 fused conv (8 frames) beside their fp32 siblings;
  6. the training step of STMask_plus_resnet50 at 360x640 (seeded random
     weights, 4 clips = 8 frames a step, synthetic batches in ClipLoader's
     format) through build_train_step: 6 steps (2 warm-up), launch counts
     per step (the fused conv, deform_wgrad and K4 at the 7 DCN sites, K1
     and K3 once, K2 never), a step from the zero-offset state, one step of
     the loop with a checkpoint save and restore, the card against the CPU
     path at 96x128, a profile of one step, and the times of K3, K4 and
     deform_wgrad (beside K2 + the cuBLAS SGEMM g^T @ cols it replaced,
     and that SGEMM alone, and at each tile height and cluster split that
     wgrad_plan chooses among);
  7. the eval CLI (``stmask_torch.eval``) with its default flags (bf16, 8
     lockstep streams x 4-frame chunks) over a synthetic YouTube-VIS set of
     16 videos x 12 PNG frames at 1280x720, with --eval_metrics, then again
     with --time_device: launch counts (the bf16 fused conv 7 times a step
     of 8 frames, the bf16 K1 once a lane-frame), frames/s end to end and
     device-only, peak memory, mAP; a profile of steady chunks (idle share,
     launches a frame); one bf16 batched chunk on the card against the CPU
     path at 96x128.

K3 (correlation backward) and K4 (deformable col2im) are checked against
their plain versions in phases 2 and 3, beside K1, K2 and the fused conv:
K3 at the shapes of CORR_BWD_SHAPES with and without the forward's output
(its leaky ReLU's derivative folded in), bit-identical over two launches,
and in phase 6 as the training step runs it (K3 the only kernel of the
backward through torch.cat's gradient slice); K4 at the 7 DCN sites x 8
frames with random, zero and integer offsets and at the shapes of
K4_SHAPES (v1, 3x5 and 5x3 taps, dilation 2, ragged Cin,
H and W off the tile, images inside the border band), with d_offset and
d_mask bit-identical over two launches.

Prints a JSON kernel table and the card's name and power limit, and as its
last line {"ok": true, "device": {...}}.  Without a GPU it prints no result
and exits non-zero.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12        # H100 SXM fp32, non-tensor-core
PEAK_TF32_FLOPS = 495e12       # H100 SXM TF32 tensor cores, dense
PEAK_BF16_FLOPS = 989e12       # H100 SXM bf16 tensor cores, dense
# the fused deformable conv against its fp32 plain version: 3xTF32 holds
# ~3e-7 there, a single TF32 product (weights scaled by 1/K) 2e-5 to 5e-5
FUSED_ATOL = 5e-6
FRAMES_PER_VIDEO = 8
N_VIDEOS = 2
WARMUP_FRAMES = 3
TRAIN_CLIPS = 4                # the recipe's baseline batch: 8 frames
TRAIN_STEPS = 6
TRAIN_WARMUP = 2
# launches of each kernel in one training step of the flagship
TRAIN_LAUNCHES = {'deform_conv': 7, 'deform_wgrad': 7, 'deform_im2col': 0,
                  'deform_col2im': 7, 'correlation': 1, 'correlation_bwd': 1}
KERNEL_NAMES = ('correlation', 'deform_im2col', 'deform_conv',
                'correlation_bwd', 'deform_col2im',
                'deform_wgrad')                       # the libraries
# deform_wgrad against its fp32 plain version, relative to max|ref| (sums
# over up to 30720 sites): 3xTF32 holds ~1e-6 there, a single TF32 product
# ~8e-4 (the control); fixed before the kernel's first run
WGRAD_RTOL = 1e-5
# the bf16 kernels against their plain bf16 versions: the same rounding
# points, the fp32 sums in another order, so a sum near a rounding boundary
# may round the other way: 2^-6 of max|ref| (two to four bf16 ulps)
BF16_REL_ATOL = 2.0 ** -6
EVAL_SET = (16, 12, 720, 1280)    # videos, frames each, frame height, width
EVAL_LANES, EVAL_CHUNK = 8, 4     # the eval CLI's defaults
# K4's shapes beside the 7 sites: (H, W, Cin, stride, kh, kw, dilation,
# v1): FCB's 3x5 and 5x3 v1 taps, dilation 2, ragged Cin, H and W off the
# tile, images inside the border band (each footprint past every edge)
K4_SHAPES = [(24, 40, 64, 1, 3, 5, 1, True), (24, 40, 64, 1, 5, 3, 1, True),
             (24, 40, 256, 1, 3, 3, 1, True), (24, 40, 64, 1, 3, 3, 2, False),
             (19, 37, 3, 1, 3, 3, 1, False), (19, 37, 6, 2, 3, 3, 1, False),
             (13, 21, 40, 1, 3, 3, 1, False), (3, 4, 8, 1, 3, 3, 1, False),
             (2, 3, 36, 2, 3, 3, 1, False)]
# K3's shapes ((B, H, W, C), patch): the training shape, two column tiles
# (W > 64), H and W below the patch, C 40 and 5, patch 1, 5 and 11
CORR_BWD_SHAPES = [((4, 24, 40, 256), 11), ((2, 48, 80, 256), 11),
                   ((2, 7, 9, 40), 5), ((1, 5, 7, 5), 11),
                   ((2, 9, 13, 100), 5), ((1, 4, 3, 40), 11),
                   ((2, 3, 70, 5), 5), ((1, 6, 5, 12), 1)]
# frame sizes (H, W) that resize_u8 takes to (360, 640), and two more
# resizes: all bit for bit cv2's INTER_LINEAR
RESIZES = [((h, w), (360, 640)) for h, w in (
    (100, 77), (240, 320), (480, 640), (481, 853), (500, 500), (720, 960),
    (720, 1280), (1080, 1440), (1080, 1920))] + [
    ((1080, 1920), (720, 1280)), ((360, 640), (384, 640))]
DCN_SITES = [  # name, (H, W, Cin) of the DCN input at 384x640, stride
    ('layer1_0', (96, 160, 128), 2), ('layer1_2', (48, 80, 128), 1),
    ('layer2_0', (48, 80, 256), 2), ('layer2_2', (24, 40, 256), 1),
    ('layer2_4', (24, 40, 256), 1), ('layer3_0', (24, 40, 512), 2),
    ('layer3_2', (12, 20, 512), 1)]


def _wgrad_at(KW, g, x, off, mask, stride: int, tm: int, split: int):
    """deform_wgrad (3x3 taps) launched with the tile height ``tm`` and
    the cluster split ``split`` in place of wgrad_plan's choice."""
    import torch
    b, h, w, cin = x.shape
    _, ho, wo, _ = off.shape
    dw = torch.empty((g.shape[1], 3, 3, cin), device=x.device)
    KW.KERNEL(g.data_ptr(), x.data_ptr(), off.data_ptr(), mask.data_ptr(),
              dw.data_ptr(), b, h, w, cin, ho, wo, g.shape[1], 3, 3, stride,
              1, tm, split, torch.cuda.current_stream(x.device).cuda_stream)
    return dw


def _nvidia_smi() -> str:
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip() or f'nvidia-smi failed: {res.stderr.strip()}'


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    """ms per call of ``fn`` called back to back (CUDA events): the time a
    caller sees, host launch cost included where it exceeds the device's."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` (CUDA events), with every call enqueued
    behind a sleep kernel so that the kernels run back to back and the
    host's launch cost is hidden.  ``fn`` must launch few kernels (the
    launch queue holds about a thousand)."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 20_000_000
    for _ in range(4):
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > host_ms:   # the queue never drained
            return ev[1].elapsed_time(ev[2]) / iters
        cycles *= 4
    raise RuntimeError('the sleep kernel never outlasted the launches')


def _device_events(fn, iters: int):
    """Run ``fn`` ``iters`` times under torch.profiler; returns the
    key_averages() rows of device kernels as (name, count, device us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, 'self_device_time_total', None)
        if us is None:
            us = getattr(e, 'self_cuda_time_total', 0)
        if us > 0 and str(e.device_type).endswith('CUDA'):
            rows.append((e.key, e.count, us))
    return rows


def _ops_s(flops: float, tf32_flops: float = 0.0,
           bf16_flops: float = 0.0) -> float:
    """Seconds of arithmetic: fp32 flops on the CUDA cores plus TF32 and
    bf16 flops on the tensor cores, each at its peak."""
    return (flops / PEAK_FP32_FLOPS + tf32_flops / PEAK_TF32_FLOPS
            + bf16_flops / PEAK_BF16_FLOPS)


def _bound_ms(nbytes: float, flops: float, tf32_flops: float = 0.0,
              bf16_flops: float = 0.0):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = _ops_s(flops, tf32_flops, bf16_flops) * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def _tf32_hi(torch, t):
    """``t`` with its 13 low mantissa bits cleared: the TF32 value a tensor
    core reads."""
    return (t.view(torch.int32) & -8192).view(torch.float32)


def _synthetic_clip(h: int, w: int, n: int, seed: int) -> np.ndarray:
    """Seeded uint8 frames [n, h, w, 3]: smooth blobs over noise, each
    frame the previous one shifted by (2, 3) pixels."""
    rng = np.random.RandomState(seed)
    coarse = rng.rand(h // 16 + 2, w // 16 + 2, 3)
    base = np.kron(coarse, np.ones((16, 16, 1)))[:h, :w] * 200.0
    frame = np.clip(base + rng.rand(h, w, 3) * 55.0, 0, 255).astype(np.uint8)
    return np.stack([np.roll(frame, (2 * i, 3 * i), axis=(0, 1))
                     for i in range(n)])


def _dcn_inputs(torch, dev, h, w, cin, stride, seed, kh=3, kw=3, b=1):
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, cin, device=dev, generator=g)
    off = torch.randn(b, ho, wo, 2 * kh * kw, device=dev, generator=g) * 2.0
    mask = torch.rand(b, ho, wo, kh * kw, device=dev, generator=g)
    return x, off, mask


def _dcn_weight(torch, dev, kh, kw, cin, cout, seed):
    """[Cout, kh, kw, Cin] weight scaled by 1/(kh*kw*Cin) and a bias."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k = kh * kw * cin
    return (torch.randn(cout, kh, kw, cin, device=dev, generator=g) / k,
            torch.randn(cout, device=dev, generator=g))


def _dcn_cost(torch, x, off, stride):
    """(bytes, flops) the gather needs for these inputs: x, offset and mask
    read once, cols written once; 2 flops per channel for every in-image
    bilinear corner, plus 1 per output element for the modulation."""
    _, h, w, cin = x.shape
    b, ho, wo, _ = off.shape
    k = torch.arange(3, device=x.device)
    oy = torch.arange(ho, device=x.device) * stride - 1      # pad 1
    ox = torch.arange(wo, device=x.device) * stride - 1
    base_y = (oy[:, None, None, None] + k[None, None, :, None]).expand(
        ho, wo, 3, 3).reshape(ho, wo, 9)
    base_x = (ox[None, :, None, None] + k[None, None, None, :]).expand(
        ho, wo, 3, 3).reshape(ho, wo, 9)
    o = off.reshape(b, ho, wo, 9, 2)
    y0 = torch.floor(base_y + o[..., 0])
    x0 = torch.floor(base_x + o[..., 1])
    corners = sum(int((((y0 + dy) >= 0) & ((y0 + dy) < h) & ((x0 + dx) >= 0)
                       & ((x0 + dx) < w)).sum())
                  for dy in (0, 1) for dx in (0, 1))
    n_out = b * ho * wo * 9 * cin
    nbytes = 4 * (x.numel() + off.numel() + b * ho * wo * 9 + n_out)
    return nbytes, 2 * cin * corners + n_out


def _stage_ms(torch, cfg, model, state, frame, n: int):
    """Median ms of each stage of one steady frame over ``n`` runs, host
    clock, every stage ended by ``torch.cuda.synchronize()`` (so the stages
    add up to more than a frame, whose stages overlap host and device)."""
    from stmask_torch.inference import postprocess_frame
    from stmask_torch.inference.candidates import detect_frame
    from stmask_torch.inference.pipeline import normalize_pad
    from stmask_torch.inference.tracker import track_step_tf
    from stmask_torch.ops.anchors import all_priors

    dev = next(model.parameters()).device
    priors = torch.as_tensor(all_priors(cfg), device=dev)
    meta = {'video_id': 1, 'frame_id': 1, 'img_shape': (cfg.img_h, cfg.img_w)}
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return res

    with torch.inference_mode():
        for _ in range(n):
            x = timed('input: copy, normalize, pad', lambda: normalize_pad(
                cfg, torch.as_tensor(frame).to(dev))[None])
            timed('backbone (R50, 7 DCN sites)', lambda: model.backbone(
                x.permute(0, 3, 1, 2)))
            preds = timed('whole forward (backbone, FPN, ProtoNet, head)',
                          lambda: model(x))
            fp = {k: preds[k][0] for k in
                  ('loc', 'conf', 'mask_coeff', 'track', 'centerness')}
            det = timed('detect: decode, cc fast NMS',
                        lambda: detect_frame(cfg, fp, priors))
            _, out = timed('track: shift (correlation, RoIAlign, TemporalNet)'
                           ', match, assign', lambda: track_step_tf(
                               cfg, model.temporal_shift, state, det,
                               preds['proto'][0], preds['fpn_feat'][0],
                               preds['T2S_feat'][0], False))
            timed('postprocess: upsample, transfer, RLE',
                  lambda: postprocess_frame(cfg, out, meta))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}

def _train_batch(cfg, seed: int, clips: int = TRAIN_CLIPS) -> dict:
    """A training batch as ClipLoader(image_u8=True) yields it: uint8
    frames [clips, 2, img_h, img_w, 3] from _synthetic_clip; 2-4 boxes a
    frame, one id persisting, one vanishing after the ref frame, one new in
    the next frame and 0-2 more persisting; box masks at prototype
    resolution packed with np.packbits; the crowd arrays present, empty."""
    from stmask_torch.data.transforms import pad_gt
    rng = np.random.RandomState(seed)
    hp, wp = cfg.pad_h // 4, cfg.pad_w // 4
    out = []
    for c in range(clips):
        imgs = _synthetic_clip(cfg.img_h, cfg.img_w, 2, seed * 100 + c)
        extra = list(range(4, 4 + rng.randint(0, 3)))
        objs = {}
        for gid in [1, 2, 3] + extra:
            w, h = rng.uniform(0.15, 0.5, 2)
            x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            objs[gid] = (np.array([x1, y1, x1 + w, y1 + h], np.float32),
                         rng.randint(1, cfg.num_classes))
        frames = []
        for f, ids in enumerate(([1, 2] + extra, [1, 3] + extra)):
            boxes = np.stack([objs[i][0] + np.float32(0.01 * f)
                              for i in ids]).clip(0, 1)
            masks = np.zeros((len(ids), hp, wp), np.uint8)
            for j, (x1, y1, x2, y2) in enumerate(boxes):
                masks[j, int(y1 * cfg.img_h / 4):int(y2 * cfg.img_h / 4) + 1,
                      int(x1 * cfg.img_w / 4):int(x2 * cfg.img_w / 4) + 1] = 1
            frames.append(pad_gt(cfg, {
                'image': imgs[f], 'boxes': boxes,
                'labels': np.array([objs[i][1] for i in ids], np.int32),
                'ids': np.array([c * 100000 + i for i in ids], np.int32),
                'masks_proto': masks,
                'crowd_boxes': np.zeros((0, 4), np.float32)}))
        out.append({k: np.stack([fr[k] for fr in frames])
                    for k in frames[0]})
    batch = {k: np.stack([o[k] for o in out]) for k in out[0]}
    batch['images'] = batch.pop('image')
    batch['masks_proto'] = np.packbits(batch['masks_proto'], axis=-1)
    return batch


def _corr_bwd_cost(shape, patch: int):
    """(bytes, flops) of K3: g, out (the forward's output, for the leaky
    ReLU's derivative), x1, x2 read once, dx1, dx2 written once; 2 flops per
    channel for every in-image (pixel, displacement) term of each
    output."""
    b, h, w, c = shape
    r = (patch - 1) // 2
    terms = sum((h - abs(dy)) * (w - abs(dx)) for dy in range(-r, r + 1)
                for dx in range(-r, r + 1) if abs(dy) < h and abs(dx) < w)
    nbytes = 4 * (2 * b * h * w * patch * patch + 4 * b * h * w * c)
    return nbytes, 2 * 2 * c * b * terms


def _corr_bwd_inputs(torch, dev, shape, patch: int, gen):
    """K3's inputs: upstream gradient, x1, x2, and a forward output with
    negatives and exact zeros (a fifth of it)."""
    x1 = torch.randn(shape, device=dev, generator=gen)
    x2 = torch.randn(shape, device=dev, generator=gen)
    pp = tuple(shape[:3]) + (patch * patch,)
    up = torch.randn(pp, device=dev, generator=gen)
    out = torch.randn(pp, device=dev, generator=gen)
    out[torch.rand(pp, device=dev, generator=gen) < 0.2] = 0.0
    return up, x1, x2, out


def _col2im_cost(torch, x, off, stride, radius: int = 2):
    """(bytes, flops) of K4 for these inputs: dcols, x, offset, mask read
    once, dx, d_offset, d_mask written once; per channel, 2 flops for each
    in-image corner pair with a weight or a weight derivative (the dot
    product S) and 2 more where the corner gets a dx update."""
    from stmask_torch.kernels.deform_col2im import _hat
    b, h, w, cin = x.shape
    _, ho, wo, _ = off.shape
    dev = x.device
    k = torch.arange(3, device=dev)
    oy = torch.arange(ho, device=dev) * stride - 1
    ox = torch.arange(wo, device=dev) * stride - 1
    by = (oy[:, None, None, None] + k[None, None, :, None]).expand(
        ho, wo, 3, 3).reshape(1, ho, wo, 9)
    bx = (ox[None, :, None, None] + k[None, None, None, :]).expand(
        ho, wo, 3, 3).reshape(1, ho, wo, 9)
    o = off.reshape(b, ho, wo, 9, 2)
    fy, fx = torch.floor(o[..., 0]).long(), torch.floor(o[..., 1]).long()
    ys = [_hat(o[..., 0], fy - 1 + j, radius) + (by + fy - 1 + j,)
          for j in range(3)]
    xs = [_hat(o[..., 1], fx - 1 + i, radius) + (bx + fx - 1 + i,)
          for i in range(3)]
    n_s = n_w = 0
    for hy, dhy, row in ys:
        for hx, dhx, col in xs:
            inside = (row >= 0) & (row < h) & (col >= 0) & (col < w)
            wgt = hy * hx
            act = inside & ((wgt != 0) | (dhy * hx != 0) | (hy * dhx != 0))
            n_s += int(act.sum())
            n_w += int((inside & (wgt != 0)).sum())
    m = b * ho * wo * 9
    nbytes = 4 * (m * cin + 2 * x.numel() + 2 * off.numel() + 2 * m)
    return nbytes, 2 * cin * (n_s + n_w)


def _dcn_train_inputs(torch, dev, h, w, cin, stride, frames, kind, seed,
                      kh=3, kw=3):
    """K4's inputs at one DCN site: x, dcols and the mask random; the
    offsets random (std 1.5, so some pass +-2 and are clamped, as the
    window op clamps them before K4), all 0, or all +-1 / +-2."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    k = kh * kw
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(frames, h, w, cin, device=dev, generator=g)
    shape = (frames, ho, wo, 2 * k)
    if kind == 'random':
        off = torch.randn(shape, device=dev, generator=g) * 1.5
    elif kind == 'zero':
        off = torch.zeros(shape, device=dev)
    else:
        vals = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=dev)
        off = vals[torch.randint(0, 4, shape, device=dev, generator=g)]
    off = off.clamp(-2, 2)
    mask = torch.rand(frames, ho, wo, k, device=dev, generator=g)
    dcols = torch.randn(frames * ho * wo, k * cin, device=dev, generator=g)
    return dcols, x, off, mask


def _resize_vs_cv2(torch, dev) -> None:
    """``resize_u8`` on the card against the machine's cv2 INTER_LINEAR:
    uint8 frames, bit for bit."""
    import cv2
    from stmask_torch.data.transforms import resize_u8
    rng = np.random.RandomState(5)
    for (h, w), (dh, dw) in RESIZES:
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
        got = resize_u8(torch.from_numpy(img).to(dev), (dh, dw))
        assert got.device.type == 'cuda' and got.dtype == torch.uint8
        diff = np.abs(got.cpu().numpy().astype(int) - want.astype(int))
        print(f'[resize] {h}x{w} -> {dh}x{dw} on the card vs cv2 '
              f'{cv2.__version__}: {int((diff > 0).sum())} of {diff.size} '
              'values differ', flush=True)
        assert diff.max() == 0, ((h, w), (dh, dw), int(diff.max()))


def _params_moved(torch, before, model, which):
    return all(not torch.equal(before[n], p.detach())
               for n, p in model.named_parameters() if which in n)


def _dcn_sites(cfg) -> int:
    """DCN sites of the backbone (7 in the flagship)."""
    from stmask_torch.models.backbone import _dcn_flags
    return sum(sum(_dcn_flags(n, d, cfg.backbone.dcn_interval))
               for n, d in zip(cfg.backbone.layers, cfg.backbone.dcn_layers))


def _eval_cli(torch, dev, smi: str, name: str, tmp: str) -> dict:
    """Phase 7: the eval CLI with its default flags on a synthetic
    YouTube-VIS set, then the profile of steady chunks and the card
    against the CPU path."""
    import math

    from stmask_torch import eval as cli
    from stmask_torch.config import get_config
    from stmask_torch.data.synthetic import write_ytvis_set
    from stmask_torch.inference.pipeline import (build_video_step_batched,
                                                 cast_model, normalize_pad)
    from stmask_torch.kernels import KERNELS
    from stmask_torch.models import build_model

    n_vid, n_fr, h, w = EVAL_SET
    cfg = get_config('STMask_plus_resnet50')
    size = (cfg.img_h, cfg.img_w)
    t0 = time.perf_counter()
    # gt at the model's input size, the size the eval CLI writes masks at
    ann, prefix = write_ytvis_set(tmp, n_vid, n_fr, h, w, seed=5, gt_hw=size)
    print(f'[eval] wrote {n_vid} videos x {n_fr} PNG frames at {w}x{h} in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    argv = ['--ann_file', ann, '--img_prefix', prefix, '--eval_metrics',
            '--mask_det_file', f'{tmp}/results.json']
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k.launches = 0
    stats = cli.evaluate(argv)          # bf16, 8 lanes x 4 frames, cuda
    launches = {n: k.launches for n, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    steps = (stats['n_chunks'] + 1) * EVAL_CHUNK     # and the warm-up chunk
    print(f'[eval] launches {launches} over {stats["n_chunks"]} chunks and '
          f'the warm-up chunk ({steps} steps of {EVAL_LANES} lanes)',
          flush=True)
    assert launches['deform_conv_bf16'] == _dcn_sites(cfg) * steps, \
        launches
    assert launches['correlation_bf16'] == EVAL_LANES * steps, launches
    assert sum(v for n, v in launches.items() if not n.endswith('bf16')) \
        == 0, launches
    assert stats['n_frames'] == n_vid * n_fr, stats
    for key in ('mAP', 'AP50', 'AP75', 'AR'):
        assert math.isfinite(stats[key]), stats
    with open(f'{tmp}/results.json') as fh:
        tracks = json.load(fh)
    assert tracks, 'no track in the results JSON'
    for tr in tracks:
        assert len(tr['segmentations']) == n_fr
        for seg in tr['segmentations']:
            assert seg is None or seg['size'] == list(size)
    print(f'[eval] STMask_plus_resnet50 bf16, {EVAL_LANES} streams x '
          f'{EVAL_CHUNK}-frame chunks, {n_vid} videos x {n_fr} frames of '
          f'{w}x{h} PNG: {stats["e2e_fps"]:.2f} frames/s end to end (decode, '
          f'resize, device, postprocess; {stats["seconds"]:.3f} s), peak '
          f'memory {peak / 2**20:.1f} MiB, {len(tracks)} tracks, mAP '
          f'{stats["mAP"]:.6f} AP50 {stats["AP50"]:.6f} ({name}, {smi})',
          flush=True)
    print('[eval] main thread ms a chunk (decode wait, upload and resize in '
          'next_chunk; the dispatch\'s launches; waiting for the fetch; '
          'waiting for the postprocess pool): ' + ', '.join(
              f'{st} {v:.3f}' for st, v in stats['host_ms_per_chunk'].items()),
          flush=True)
    timed = cli.evaluate(argv[:-1] + [f'{tmp}/timed.json', '--time_device'])
    print(f'[eval] --time_device: {timed["device_fps"]:.2f} frames/s '
          f'device-only, {timed["device_ms_per_chunk"]:.3f} ms a chunk of '
          f'{EVAL_LANES} x {EVAL_CHUNK} frames (host clock, each dispatch '
          f'waited for), {timed["e2e_fps"]:.2f} frames/s end to end without '
          'overlap', flush=True)

    # steady chunks under torch.profiler: device busy share and launches
    args = cli.parse_args(argv)
    cfg, model = cli.load_model(args)
    chunk, make_states = build_video_step_batched(
        cfg, model, EVAL_LANES, EVAL_CHUNK, uint8_input=True, device=dev,
        compute_dtype=torch.bfloat16)
    clip = _synthetic_clip(cfg.img_h, cfg.img_w, EVAL_CHUNK * 4, seed=7)
    # 4 chunks, every lane on the same frame of the clip
    frames = torch.from_numpy(np.repeat(clip[:, None], EVAL_LANES, axis=1)
                              ).to(dev).reshape(4, EVAL_CHUNK, EVAL_LANES,
                                                cfg.img_h, cfg.img_w, 3)
    first = torch.zeros(EVAL_CHUNK, EVAL_LANES, dtype=torch.bool)
    states = make_states()
    states, _ = chunk(states, frames[0], ~first)
    states, _ = chunk(states, frames[1], first)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in (2, 3):
        states, _ = chunk(states, frames[c], first)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 2

    def steady():
        nonlocal states
        for c in (2, 3):
            states, _ = chunk(states, frames[c], first)

    rows = _device_events(steady, 1)
    prof = {'chunk_ms': wall}
    if rows:
        busy = sum(us for _, _, us in rows) / 2 / 1e3
        n_kern = sum(c for _, c, _ in rows) / 2
        prof.update(busy_ms=busy, idle=1 - busy / wall,
                    launches_per_frame=n_kern / (EVAL_LANES * EVAL_CHUNK))
        print(f'[profile] eval chunk ({EVAL_LANES} x {EVAL_CHUNK} frames, '
              f'bf16): device busy {busy:.3f} ms of {wall:.3f} ms wall (idle '
              f'share {1 - busy / wall:.3f}), '
              f'{prof["launches_per_frame"]:.1f} kernel launches a frame')
        for key, cnt, us in sorted(rows, key=lambda r: -r[2])[:12]:
            print(f'[profile]   {us / 2 / 1e3:8.4f} ms/chunk {cnt / 2:6.1f}x  '
                  f'{key[:100]}')
    else:
        print('[profile] torch.profiler recorded no device time: device '
              'busy share not measured')
    del model, chunk, states, frames

    # the card against the CPU path at 96x128: the bf16 model's outputs,
    # each within twice the CPU's own bf16-vs-fp32 gap; then one bf16
    # batched chunk (2 lanes x 2 frames, a new video in lane 1 at step 1)
    small = cfg.replace(img_h=96, img_w=128)
    clip = _synthetic_clip(96, 128, 4, seed=9)
    x = normalize_pad(small, torch.from_numpy(clip[:1]))
    cpu = torch.device('cpu')
    with torch.inference_mode():
        ref32 = build_model(small, cpu, seed=0)(x)
        ref16 = cast_model(build_model(small, cpu, seed=0), torch.bfloat16)(
            x.bfloat16())
        got16 = cast_model(build_model(small, dev, seed=0), torch.bfloat16)(
            x.to(dev).bfloat16())
    for key in ('loc', 'conf', 'centerness', 'mask_coeff', 'track', 'proto',
                'T2S_feat', 'fpn_feat'):
        gap = float((ref16[key].float() - ref32[key]).abs().max())
        d = float((got16[key].float().cpu() - ref16[key].float()).abs().max())
        print(f'[check] bf16 card vs CPU {key}: max|diff| {d:.3e} (limit '
              f'twice the CPU bf16-vs-fp32 gap {gap:.3e})')
        assert d <= 2 * gap, (key, d, gap)
    fr = np.stack([clip[:2], clip[2:]], axis=1)          # [K 2, B 2]
    fi = np.array([[True, True], [False, True]])
    outs = []
    for d_ in (dev, cpu):
        ch, mk = build_video_step_batched(
            small, build_model(small, d_, seed=0), 2, 2, uint8_input=True,
            device=d_, compute_dtype=torch.bfloat16)
        _, o = ch(mk(), fr, fi)
        outs.append(type(o)(*(t.cpu() for t in o)))
    a, b = outs
    for t in a:
        if t.is_floating_point():
            assert bool(torch.isfinite(t).all())
    same_keep = float((a.keep == b.keep).float().mean())
    both = a.keep & b.keep
    box_d = float((a.box - b.box)[both].abs().max()) if both.any() else 0.0
    print(f'[check] bf16 batched chunk card vs CPU at 96x128: keep flags '
          f'agree on {same_keep:.4f} of {a.keep.numel()} slots, '
          f'{int(a.keep.sum())} / {int(b.keep.sum())} kept, max|box diff| '
          f'{box_d:.3e} where both keep', flush=True)
    return dict(stats=stats, timed=timed, launches=launches, peak=peak,
                prof=prof)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
              'runs only on a GPU', file=sys.stderr)
        return 2
    from stmask_torch.config import get_config
    from stmask_torch.inference import (build_video_step, postprocess_frame,
                                        results2json_videoseg)
    from stmask_torch.kernels import KERNELS, build
    from stmask_torch.kernels import correlation as K1
    from stmask_torch.kernels import correlation_bwd as K3
    from stmask_torch.kernels import deform_col2im as K4
    from stmask_torch.kernels import deform_conv as KD
    from stmask_torch.kernels import deform_im2col as K2
    from stmask_torch.kernels import deform_wgrad as KW
    from stmask_torch.models import build_model
    from stmask_torch.utils.device import resolve_device

    dev = resolve_device('cuda')            # also turns TF32 off
    smi = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {name} ({smi})', flush=True)

    # ---- 1. build ---------------------------------------------------------
    secs = build.build(KERNEL_NAMES)
    print(f'[build] {" + ".join(KERNEL_NAMES)} with nvcc '
          f'{" ".join(build.NVCC_FLAGS)}: {secs:.2f} s', flush=True)
    for lib in KERNEL_NAMES:
        for line in build.ptxas_report(lib):
            print(f'[ptxas] {lib}: {line}')
    for lib in ('deform_col2im', 'deform_wgrad'):
        spills = [ln for ln in build.ptxas_report(lib) if 'spill' in ln]
        assert spills and all(
            re.search(r'(^|\s)0 bytes spill stores, 0 bytes spill loads', ln)
            for ln in spills), (lib, spills)

    # ---- 2. the frame resize against cv2, then K1 vs plain ----------------
    _resize_vs_cv2(torch, dev)

    err = {n: 0.0 for n in KERNELS}
    g = torch.Generator(device=dev).manual_seed(0)
    for shape, patch in (((1, 24, 40, 256), 11), ((2, 7, 9, 96), 11),
                         ((2, 7, 9, 96), 5), ((1, 5, 70, 40), 11),
                         ((2, 7, 9, 96), 17), ((1, 20, 40, 64), 31)):
        x1 = torch.randn(shape, device=dev, generator=g)
        x2 = torch.randn(shape, device=dev, generator=g)
        got = K1.correlate_cuda(x1, x2, patch)
        want = K1.correlate_reference(x1, x2, patch)
        torch.cuda.synchronize()
        d = float((got - want).abs().max())
        err['correlation'] = max(err['correlation'], d)
        print(f'[K1] correlation {shape} patch {patch}: max|diff| {d:.3e} '
              '(atol 1e-5, rtol 1e-5)', flush=True)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)

    # K1 on bf16 inputs: the batched eval's shape (one lane-frame) and
    # ragged ones; both sides round every product to bf16 and sum in fp32,
    # so only the order of the fp32 sum differs
    for shape, patch in (((1, 24, 40, 256), 11), ((2, 7, 9, 96), 11),
                         ((2, 7, 9, 96), 5), ((1, 5, 70, 40), 11),
                         ((1, 3, 2, 5), 11)):
        x1 = torch.randn(shape, device=dev, generator=g).bfloat16()
        x2 = torch.randn(shape, device=dev, generator=g).bfloat16()
        got = K1.correlate_cuda(x1, x2, patch)
        want = K1.correlate_reference(x1, x2, patch)
        torch.cuda.synchronize()
        d = float((got - want).abs().max())
        err['correlation_bf16'] = max(err['correlation_bf16'], d)
        print(f'[K1 bf16] correlation {shape} patch {patch}: max|diff| '
              f'{d:.3e} (atol 1e-5, rtol 1e-5)', flush=True)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)

    # K3 at the training shape (4 clips at 384x640) and ragged ones: two
    # column tiles (W > 64), H and W below the patch, C 40 and 5 (not a
    # multiple of 4), patch 1, 5 and 11; upstream gradient of both signs and
    # a forward output with negatives and exact zeros (the leaky ReLU's
    # derivative is folded in); each output is summed in a fixed order, so
    # the sums differ from the plain version's only in their order, and a
    # second launch gives the same bits
    for shape, patch in CORR_BWD_SHAPES:
        up, x1, x2, out = _corr_bwd_inputs(torch, dev, shape, patch, g)
        for o in (out, None):
            n0 = K3.KERNEL.launches
            got = K3.correlation_bwd_cuda(up, x1, x2, patch, out=o)
            assert K3.KERNEL.launches == n0 + 1
            again = K3.correlation_bwd_cuda(up, x1, x2, patch, out=o)
            want = K3.correlation_bwd_reference(up, x1, x2, patch, out=o)
            torch.cuda.synchronize()
            d = max(float((a - b).abs().max()) for a, b in zip(got, want))
            err['correlation_bwd'] = max(err['correlation_bwd'], d)
            print(f'[K3] correlation_bwd {shape} patch {patch} '
                  f'{"with" if o is not None else "without"} out: max|diff| '
                  f'{d:.3e} (atol 1e-5, rtol 1e-5)', flush=True)
            for a, a2, b in zip(got, again, want):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
                assert torch.equal(a, a2), 'K3 differs between two launches'

    # ---- 3. K2 vs plain ---------------------------------------------------
    for i, (site, (h, w, cin), stride) in enumerate(DCN_SITES):
        x, off, mask = _dcn_inputs(torch, dev, h, w, cin, stride, i)
        got = K2.deform_im2col_cuda(x, off, mask, 3, 3, stride)
        want = K2.deform_im2col_reference(x, off, mask, 3, 3, stride)
        wt = torch.randn(9 * cin, cin, device=dev, generator=g) / (9 * cin)
        torch.cuda.synchronize()
        d_cols = float((got - want).abs().max())
        d_mm = float((got @ wt - want @ wt).abs().max())
        err['deform_im2col'] = max(err['deform_im2col'], d_cols)
        print(f'[K2] {site} x {(h, w, cin)} stride {stride}: max|diff| cols '
              f'{d_cols:.3e} (atol 1e-5), after fp32 matmul {d_mm:.3e} '
              '(atol 1e-4)', flush=True)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        torch.testing.assert_close(got @ wt, want @ wt, atol=1e-4, rtol=0)

    # the fused kernel: the 7 sites (v2, bias), then ragged channels and
    # strides, v1 and v2, bias and none, FCB's 3x5 / 5x3 v1 taps, dilation.
    # At the 7 sites a control, the same product with both operands cut to
    # TF32 (what one TF32 MMA computes), must miss the tolerance.
    fused_cases = [(site, h, w, cin, cin, 3, 3, stride, 1, True, True)
                   for site, (h, w, cin), stride in DCN_SITES]
    fused_cases += [
        (f'ragged Cin {cin} stride {st} {"v2" if v2 else "v1"} '
         f'{"bias" if bias else "no bias"}', 9, 11, cin, 5, 3, 3, st, 1, v2,
         bias)
        for cin in (3, 6) for st in (1, 2) for v2 in (True, False)
        for bias in (True, False)]
    fused_cases += [('v1 3x5', 24, 40, 256, 256, 3, 5, 1, 1, False, True),
                    ('v1 5x3', 24, 40, 256, 256, 5, 3, 1, 1, False, True),
                    ('v1 3x5 ragged', 9, 11, 6, 5, 3, 5, 2, 1, False, False),
                    ('v1 5x3 ragged', 9, 11, 6, 5, 5, 3, 1, 1, False, True),
                    ('v2 dilation 2', 13, 7, 64, 36, 3, 3, 1, 2, True, True)]
    for i, (label, h, w, cin, cout, kh, kw, st, dil, v2, bias) in enumerate(
            fused_cases):
        x, off, mask = _dcn_inputs(torch, dev, h, w, cin, st, 100 + i, kh, kw)
        wt, b = _dcn_weight(torch, dev, kh, kw, cin, cout, 200 + i)
        args = (x, off, wt, mask if v2 else None, b if bias else None, st,
                dil)
        got = KD.deform_conv_cuda(*args)
        want = KD.deform_conv_reference(*args)
        torch.cuda.synchronize()
        d = float((got - want).abs().max())
        err['deform_conv'] = max(err['deform_conv'], d)
        control = ''
        if i < len(DCN_SITES):
            cols = K2.deform_im2col_reference(x, off, mask, kh, kw, st, dil)
            tf32 = (_tf32_hi(torch, cols)
                    @ _tf32_hi(torch, wt.reshape(cout, -1)).t()
                    + b).reshape(want.shape)
            d_tf32 = float((tf32 - want).abs().max())
            control = f'; single TF32 product {d_tf32:.3e} (must exceed it)'
            assert d_tf32 > FUSED_ATOL, (label, d_tf32)
        print(f'[fused] {label}: x {(h, w, cin)} Cout {cout} {kh}x{kw} '
              f'stride {st} dilation {dil}: max|diff| {d:.3e} (atol '
              f'{FUSED_ATOL}){control}', flush=True)
        torch.testing.assert_close(got, want, atol=FUSED_ATOL, rtol=0)

    # the bf16 variant: the 7 sites with 8 frames (one step of the batched
    # eval), then ragged channels, v1, no bias, 3x5 and dilation 2
    bf16_cases = [(site, h, w, cin, cin, 3, 3, stride, 1, True, True,
                   EVAL_LANES) for site, (h, w, cin), stride in DCN_SITES]
    bf16_cases += [('ragged Cin 6 stride 2 v1 no bias', 9, 11, 6, 5, 3, 3, 2,
                    1, False, False, 2),
                   ('ragged Cin 3 stride 1 v2', 9, 11, 3, 6, 3, 3, 1, 1,
                    True, True, 1),
                   ('v1 3x5', 24, 40, 256, 256, 3, 5, 1, 1, False, True, 1),
                   ('v2 dilation 2', 13, 7, 64, 36, 3, 3, 1, 2, True, True,
                    2)]
    for i, (label, h, w, cin, cout, kh, kw, st, dil, v2, bias, b) in \
            enumerate(bf16_cases):
        x, off, mask = _dcn_inputs(torch, dev, h, w, cin, st, 500 + i, kh, kw,
                                   b)
        wt, bs = _dcn_weight(torch, dev, kh, kw, cin, cout, 600 + i)
        args = tuple(None if t is None else t.bfloat16() for t in (
            x, off, wt, mask if v2 else None, bs if bias else None)) + (
                st, dil)
        got = KD.deform_conv_cuda(*args)
        want = KD.deform_conv_reference(*args)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        d = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        err['deform_conv_bf16'] = max(err['deform_conv_bf16'], d)
        print(f'[fused bf16] {label}: x {(b, h, w, cin)} Cout {cout} '
              f'{kh}x{kw} stride {st} dilation {dil}: max|diff| {d:.3e} '
              f'(max|ref| {scale:.3e}, atol {BF16_REL_ATOL:.4f} of it)',
              flush=True)
        assert d <= BF16_REL_ATOL * scale, (label, d, scale)
        del x, off, mask, args, got, want

    # K4 at the 7 sites with 8 frames and three offset sets, then v1, FCB's
    # 3x5 / 5x3 taps, dilation 2, ragged Cin, H and W off the tile, and
    # images inside the border band.  dx sums with shared and global fp32
    # atomics, so its tolerance is 1e-5 of max|ref|; d_offset and d_mask
    # are summed in a fixed order: a second launch gives them bit for bit.
    def check_k4(label, args, kh, kw, stride, dilation=1):
        got = K4.deform_col2im_cuda(*args, kh, kw, stride, dilation)
        again = K4.deform_col2im_cuda(*args, kh, kw, stride, dilation)
        want = K4.deform_col2im_reference(*args, kh, kw, stride, dilation)
        torch.cuda.synchronize()
        worst = 0.0
        for out_name, a, b in zip(('dx', 'd_offset', 'd_mask'), got, want):
            if b is None:
                assert a is None, label
                continue
            scale = max(float(b.abs().max()), 1.0)
            d = float((a - b).abs().max())
            worst = max(worst, d / scale)
            torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=0,
                                       msg=f'{label} {out_name}')
        assert torch.equal(got[1], again[1]), f'{label}: d_offset varies'
        assert (got[2] is None or torch.equal(got[2], again[2])), \
            f'{label}: d_mask varies'
        err['deform_col2im'] = max(err['deform_col2im'], worst)
        print(f'[K4] {label}: max|diff| / max|ref| {worst:.3e} (atol 1e-5 '
              'of max|ref|); d_offset, d_mask bit-identical over two '
              'launches', flush=True)

    for i, (site, (h, w, cin), stride) in enumerate(DCN_SITES):
        for kind in ('random', 'zero', 'integer'):
            args = _dcn_train_inputs(torch, dev, h, w, cin, stride,
                                     2 * TRAIN_CLIPS, kind, 300 + i)
            check_k4(f'{site} x {(2 * TRAIN_CLIPS, h, w, cin)} stride '
                     f'{stride}, {kind} offsets', args, 3, 3, stride)
            del args
    for (h, w, cin, stride, kh, kw, dil, v1) in K4_SHAPES:
        for kind in ('random', 'integer'):
            dcols, x, off, mask = _dcn_train_inputs(
                torch, dev, h, w, cin, stride, 2, kind, 7, kh, kw)
            check_k4(f'{(2, h, w, cin)} {kh}x{kw} stride {stride} dilation '
                     f'{dil}{" v1" if v1 else ""}, {kind} offsets',
                     (dcols, x, off, None if v1 else mask), kh, kw, stride,
                     dil)
            del dcols, x, off, mask

    # deform_wgrad at the 7 sites x 8 frames with three offset sets and a
    # random g, with the single-TF32 control at each site; then v1, FCB's
    # 3x5 / 5x3 taps, dilation 2, ragged Cin (3, 6, 40) and Cout (5).  No
    # atomics: a second launch gives d_w bit for bit.
    def check_wgrad(label, x, off, mask, cout, kh, kw, stride, dilation=1,
                    control=False):
        gg = torch.randn(off.shape[0] * off.shape[1] * off.shape[2], cout,
                         device=dev, generator=g)
        args = (gg, x, off, mask, kh, kw, stride, dilation)
        got = KW.deform_wgrad_cuda(*args)
        again = KW.deform_wgrad_cuda(*args)
        want = KW.deform_wgrad_reference(*args)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        d = float((got - want).abs().max()) / scale
        err['deform_wgrad'] = max(err['deform_wgrad'], d)
        note = ''
        if control:
            cols = K2.deform_im2col_reference(x, off, mask, kh, kw, stride,
                                              dilation)
            tf32 = (_tf32_hi(torch, gg).t() @ _tf32_hi(torch, cols)
                    ).reshape(want.shape)
            d_tf32 = float((tf32 - want).abs().max()) / scale
            note = f'; single TF32 product {d_tf32:.3e} (must exceed it)'
            assert d_tf32 > WGRAD_RTOL, (label, d_tf32)
            del cols, tf32
        print(f'[wgrad] {label} Cout {cout}: max|diff| / max|ref| {d:.3e} '
              f'(atol {WGRAD_RTOL} of max|ref| {scale:.3e}); bit-identical '
              f'over two launches{note}', flush=True)
        assert d <= WGRAD_RTOL, (label, d)
        assert torch.equal(got, again), f'{label}: d_w varies'

    for i, (site, (h, w, cin), stride) in enumerate(DCN_SITES):
        for kind in ('random', 'zero', 'integer'):
            _, x, off, mask = _dcn_train_inputs(torch, dev, h, w, cin, stride,
                                                2 * TRAIN_CLIPS, kind, 700 + i)
            check_wgrad(f'{site} x {(2 * TRAIN_CLIPS, h, w, cin)} stride '
                        f'{stride}, {kind} offsets', x, off, mask, cin, 3, 3,
                        stride, control=kind == 'random')
            del x, off, mask
    for (h, w, cin, stride, kh, kw, dil, v1) in K4_SHAPES:
        for kind, cout in (('random', cin), ('integer', 5)):
            _, x, off, mask = _dcn_train_inputs(
                torch, dev, h, w, cin, stride, 2, kind, 8, kh, kw)
            check_wgrad(f'{(2, h, w, cin)} {kh}x{kw} stride {stride} '
                        f'dilation {dil}{" v1" if v1 else ""}, {kind} '
                        'offsets', x, off, None if v1 else mask, cout, kh, kw,
                        stride, dil)
            del x, off, mask

    # the whole window DCN op (clamp, fused forward, deform_wgrad, a
    # matmul, K4) on the card against its CPU plain path: five gradients
    from stmask_torch.ops.deform_conv import deform_conv_window
    for site, (h, w, cin), stride in (DCN_SITES[3], DCN_SITES[5]):
        gc = torch.Generator().manual_seed(11)
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        host = [torch.randn(2, h, w, cin, generator=gc),
                torch.randn(2, ho, wo, 18, generator=gc) * 1.5,
                torch.randn(cin, 3, 3, cin, generator=gc) / (3 * cin),
                torch.rand(2, ho, wo, 9, generator=gc),
                torch.randn(cin, generator=gc)]
        host[1][0, 0, 0, :4] = torch.tensor([2.0, -2.0, 0.0, 1.0])
        cot = torch.randn(2, ho, wo, cin, generator=gc)
        grads = []
        for d_ in (torch.device('cpu'), dev):
            ts = [t.detach().to(d_).requires_grad_(True) for t in host]
            (deform_conv_window(*ts, stride=stride) * cot.to(d_)).sum(
                ).backward()
            grads.append([t.grad.cpu() for t in ts])
        for nm, a, b in zip(('dx', 'd_offset', 'dW', 'd_mask', 'db'),
                            grads[1], grads[0]):
            scale = max(float(b.abs().max()), 1.0)
            d = float((a - b).abs().max())
            print(f'[dcn op] {site} card vs CPU {nm}: max|diff| {d:.3e} '
                  f'(max|ref| {scale:.3e}, atol 1e-4 of max|ref|)')
            assert d <= 1e-4 * scale, (site, nm, d, scale)
        del ts, grads

    # ---- 4. main path -----------------------------------------------------
    cfg = get_config('STMask_plus_resnet50')
    model = build_model(cfg, dev, seed=0)
    step, init_state = build_video_step(cfg, model, uint8_input=True,
                                        debug=True, device=dev)
    clips = [_synthetic_clip(cfg.img_h, cfg.img_w, FRAMES_PER_VIDEO, seed=v)
             for v in range(N_VIDEOS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k.launches = 0
    frame_ms, per_frame, outs, bank_nonempty = [], [], [], []
    for v, clip in enumerate(clips):
        state = init_state()
        for f, frame in enumerate(clip):
            if f > 0:
                bank_nonempty.append(state.valid.any())
            t0 = time.perf_counter()
            state, out, dbg = step(state, frame, f == 0)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            per_frame.append((v, f, dbg['det_valid'].sum(), out.keep.sum(),
                              state.valid.sum()))
            outs.append((v, f, out))
    launches = {n: k.launches for n, k in KERNELS.items()}
    peak_mem = torch.cuda.max_memory_allocated()
    n_frames = N_VIDEOS * FRAMES_PER_VIDEO
    print(f'[main] launches {launches} over {n_frames} frames', flush=True)
    assert launches['correlation'] == n_frames, launches
    assert launches['deform_conv'] == 7 * n_frames, launches
    assert launches['deform_im2col'] == 0, launches
    assert launches['correlation_bwd'] == launches['deform_col2im'] == 0, \
        launches
    assert launches['correlation_bf16'] == launches['deform_conv_bf16'] == 0, \
        launches                              # an fp32 path
    assert any(bool(b) for b in bank_nonempty), \
        'candidate_shift never ran with a non-empty track bank'
    for v, f, ndet, nkeep, nvalid in per_frame:
        print(f'[main] video {v} frame {f}: detections {int(ndet)}, '
              f'tracks kept {int(nkeep)}, bank {int(nvalid)}')

    results = []
    for v, f, out in outs:
        for name_, t in zip(out._fields, out):
            if t.is_floating_point():
                assert bool(torch.isfinite(t).all()), (v, f, name_)
        assert tuple(out.mask.shape) == (cfg.track_capacity, cfg.pad_h // 4,
                                         cfg.pad_w // 4)
        results.append(postprocess_frame(
            cfg, out, {'video_id': v + 1, 'frame_id': f,
                       'img_shape': (cfg.img_h, cfg.img_w)}))
    tracks = results2json_videoseg(results)
    json.dumps(tracks)
    assert tracks, 'no track in the results JSON'
    for tr in tracks:
        assert len(tr['segmentations']) == FRAMES_PER_VIDEO
        for s in tr['segmentations']:
            assert s is None or s['size'] == [cfg.img_h, cfg.img_w]
    steady = sorted(frame_ms[WARMUP_FRAMES:])
    med = steady[len(steady) // 2]
    print(f'[main] results JSON: {len(tracks)} tracks in {N_VIDEOS} videos',
          flush=True)
    print(f'[main] STMask_plus_resnet50 {cfg.img_h}x{cfg.img_w} fp32 (TF32 '
          f'off): median {med:.3f} ms/frame after {WARMUP_FRAMES} warm-up '
          f'frames ({1e3 / med:.2f} frames/s), all frames '
          f'{[round(t, 3) for t in frame_ms]}; peak memory '
          f'{peak_mem / 2**20:.1f} MiB ({name}, {smi})', flush=True)

    # the card's model outputs against the CPU path on a small input
    small = cfg.replace(img_h=96, img_w=128)
    x = torch.from_numpy(_synthetic_clip(96, 128, 1, seed=9)[0])
    from stmask_torch.inference.pipeline import normalize_pad
    x = normalize_pad(small, x)[None]
    with torch.inference_mode():
        ref = build_model(small, torch.device('cpu'), seed=0)(x)
        got = build_model(small, dev, seed=0)(x.to(dev))
    for key, atol in dict(loc=2e-3, conf=1e-4, centerness=1e-4,
                          mask_coeff=2e-3, track=1e-3, proto=2e-3,
                          T2S_feat=2e-3, fpn_feat=2e-3).items():
        d = float((got[key].cpu() - ref[key]).abs().max())
        scale = float(ref[key].abs().max())
        print(f'[check] card vs CPU {key}: max|diff| {d:.3e} '
              f'(max|ref| {scale:.3e}, atol {atol} relative to max|ref|)')
        assert d <= atol * max(1.0, scale), key

    # where one steady frame's device time goes (torch.profiler)
    state = init_state()
    clip = clips[0]
    for f in range(2):
        state, _, _ = step(state, clip[f], f == 0)
    n_prof = 4

    def frames():
        nonlocal state
        for f in range(2, 2 + n_prof):
            state, _, _ = step(state, clip[f], False)

    rows = _device_events(frames, 1)
    if rows:
        dev_ms = sum(us for _, _, us in rows) / n_prof / 1e3
        n_kern = sum(c for _, c, _ in rows) / n_prof
        print(f'[profile] per steady frame: device busy {dev_ms:.3f} ms of '
              f'{med:.3f} ms wall (idle share {1 - dev_ms / med:.3f}), '
              f'{n_kern:.0f} kernel launches')
        for key, cnt, us in sorted(rows, key=lambda r: -r[2])[:12]:
            print(f'[profile]   {us / n_prof / 1e3:8.4f} ms/frame '
                  f'{cnt / n_prof:6.1f}x  {key[:100]}')
    else:
        print('[profile] torch.profiler recorded no device time: device '
              'busy share not measured')
    for stage, ms in _stage_ms(torch, cfg, model, state, clip[6], 9).items():
        print(f'[stage] {ms:8.3f} ms  {stage}')

    # ---- 5. kernel times ----------------------------------------------------
    x1 = torch.randn(1, 24, 40, 256, device=dev, generator=g)
    x2 = torch.randn(1, 24, 40, 256, device=dev, generator=g)
    k1_ms = _device_ms(lambda: K1.correlate_cuda(x1, x2, 11), 200)
    k1_call = _time_ms(lambda: K1.correlate_cuda(x1, x2, 11), 500)
    k1_plain = _time_ms(lambda: K1.correlate_reference(x1, x2, 11), 50)
    k1_bound, k1_by = _bound_ms(4 * (2 * x1.numel() + 960 * 121),
                                2 * 960 * 121 * 256)
    print(f'[time] correlation [1,24,40,256] P 11: kernel {k1_ms:.5f} ms '
          f'(device, CUDA events over 200 queued launches), per wrapper call '
          f'{k1_call:.5f} ms (500 back-to-back calls), plain {k1_plain:.5f} '
          f'ms, bound {k1_bound:.5f} ms ({k1_by})')
    # RoIAlign (plain PyTorch, two einsums) at the tracker's shape: the
    # [24, 40, 633] concatenation (121 correlation + 2 x 256 T2S channels)
    # and the 32 shifted slots' boxes; device time of its ~30 launches a
    # call (20 calls, so that the queue behind the sleep kernel holds them)
    from stmask_torch.ops.roi_align import roi_align
    feats = torch.randn(24, 40, 633, device=dev, generator=g)
    lo = torch.rand(32, 2, device=dev, generator=g) * torch.tensor(
        [30.0, 16.0], device=dev)
    boxes = torch.cat([lo, lo + 2 + torch.rand(32, 2, device=dev,
                                               generator=g) * 8], dim=1)
    ra_ms = _device_ms(lambda: roi_align(feats, boxes), 20)
    ra_call = _time_ms(lambda: roi_align(feats, boxes), 200)
    # features read once, the [32, 7, 7, 633] output written once; the
    # two contractions' flops (7 x H x W x C, then 7 x 7 x W x C per box)
    ra_flops = 2 * 32 * (7 * 24 * 40 * 633 + 7 * 7 * 40 * 633)
    ra_bound, ra_by = _bound_ms(4 * (feats.numel() + 32 * 49 * 633),
                                ra_flops)
    print(f'[time] roi_align [24,40,633], 32 boxes, fp32 (plain PyTorch): '
          f'{ra_ms:.5f} ms (device), per call {ra_call:.5f} ms, bound '
          f'{ra_bound:.5f} ms ({ra_by})')

    def tally(acc, ms, call, plain, nbytes, flops, tf32_flops=0.0):
        bound, by = _bound_ms(nbytes, flops, tf32_flops)
        for key, v in (('ms', ms), ('call_ms', call), ('plain_ms', plain),
                       ('bound_ms', bound),
                       ('bytes_s', nbytes / PEAK_BYTES_PER_S),
                       ('ops_s', _ops_s(flops, tf32_flops))):
            acc[key] = acc.get(key, 0.0) + v
        return bound, by

    k2, kd, before, dense = {}, {}, 0.0, 0.0
    for i, (site, (h, w, cin), stride) in enumerate(DCN_SITES):
        x, off, mask = _dcn_inputs(torch, dev, h, w, cin, stride, i)
        wt, bias = _dcn_weight(torch, dev, 3, 3, cin, cin, i)
        nbytes, flops = _dcn_cost(torch, x, off, stride)
        ms = _device_ms(lambda: K2.deform_im2col_cuda(x, off, mask, 3, 3,
                                                      stride), 200)
        call = _time_ms(lambda: K2.deform_im2col_cuda(x, off, mask, 3, 3,
                                                      stride), 200)
        plain = _time_ms(lambda: K2.deform_im2col_reference(
            x, off, mask, 3, 3, stride), 20)
        bound, by = tally(k2, ms, call, plain, nbytes, flops)
        print(f'[time] deform_im2col {site}: kernel {ms:.5f} ms (device), '
              f'per wrapper call {call:.5f} ms, plain {plain:.5f} ms, bound '
              f'{bound:.5f} ms ({by}; {nbytes} B, {flops} flop)')

        # the fused kernel; bound: x, offset, mask, weight, bias read once,
        # out written once; the gather's fp32 flops on the CUDA cores plus
        # the product 2*M*N*K as the three TF32 products of an fp32-accurate
        # result on the tensor cores
        m_sites = off.shape[1] * off.shape[2]
        f_bytes = 4 * (x.numel() + off.numel() + mask.numel() + wt.numel()
                       + bias.numel() + m_sites * cin)
        f_tf32 = 3 * 2 * m_sites * cin * 9 * cin
        f_ms = _device_ms(lambda: KD.deform_conv_cuda(
            x, off, wt, mask, bias, stride), 200)
        f_call = _time_ms(lambda: KD.deform_conv_cuda(
            x, off, wt, mask, bias, stride), 200)
        f_plain = _time_ms(lambda: KD.deform_conv_reference(
            x, off, wt, mask, bias, stride), 20)
        f_bound, f_by = tally(kd, f_ms, f_call, f_plain, f_bytes, flops,
                              f_tf32)
        wt_kn = wt.permute(1, 2, 3, 0).reshape(9 * cin, cin).contiguous()
        b_ms = _device_ms(lambda: K2.deform_im2col_cuda(
            x, off, mask, 3, 3, stride) @ wt_kn + bias, 200)
        before += b_ms
        conv_x = x.permute(0, 3, 1, 2)              # NCHW, channels-last
        conv_w = wt.permute(0, 3, 1, 2)             # OIHW, channels-last
        d_ms = _device_ms(lambda: torch.nn.functional.conv2d(
            conv_x, conv_w, bias, stride, 1), 200)
        dense += d_ms
        print(f'[time] deform_conv {site}: fused kernel {f_ms:.5f} ms '
              f'(device), per wrapper call {f_call:.5f} ms; before (K2 + '
              f'matmul + bias) {b_ms:.5f} ms (device); plain {f_plain:.5f} '
              f'ms; bound {f_bound:.5f} ms ({f_by}; {f_bytes} B, {flops} '
              f'fp32 flop, {f_tf32} TF32 flop); dense 3x3 cuDNN conv of the '
              f'same size (not the same function) {d_ms:.5f} ms')
    print(f'[time] deform_conv, 7 sites summed: fused {kd["ms"]:.5f} ms '
          f'(device), per call {kd["call_ms"]:.5f} ms, before (K2 + matmul + '
          f'bias) {before:.5f} ms, plain {kd["plain_ms"]:.5f} ms, bound '
          f'{kd["bound_ms"]:.5f} ms; dense 3x3 cuDNN conv (not the same '
          f'function) {dense:.5f} ms ({smi})')

    # the bf16 variants.  K1 on bf16 [1,24,40,256] (one lane-frame of the
    # batched eval): half the input bytes, the same fp32 flops.
    x1b, x2b = x1.bfloat16(), x2.bfloat16()
    k1b_ms = _device_ms(lambda: K1.correlate_cuda(x1b, x2b, 11), 200)
    k1b_call = _time_ms(lambda: K1.correlate_cuda(x1b, x2b, 11), 500)
    k1b_plain = _time_ms(lambda: K1.correlate_reference(x1b, x2b, 11), 50)
    k1b_bound, k1b_by = _bound_ms(2 * 2 * x1.numel() + 4 * 960 * 121,
                                  2 * 960 * 121 * 256)
    print(f'[time] correlation bf16 [1,24,40,256] P 11: kernel {k1b_ms:.5f} '
          f'ms (device), per wrapper call {k1b_call:.5f} ms, plain '
          f'{k1b_plain:.5f} ms, bound {k1b_bound:.5f} ms ({k1b_by}); fp32 '
          f'sibling {k1_ms:.5f} ms')
    # the fused conv at the 7 sites with 8 frames (one step of the batched
    # eval): bf16 beside fp32.  Bound of bf16: x, offset, mask, weight,
    # bias read once and out written once at 2 bytes; the gather's flops at
    # the fp32 peak plus 2*M*N*K at the bf16 tensor-core peak.
    kdb, kd8 = {}, {}
    for i, (site, (h, w, cin), stride) in enumerate(DCN_SITES):
        x, off, mask = _dcn_inputs(torch, dev, h, w, cin, stride, i,
                                   b=EVAL_LANES)
        wt, bias = _dcn_weight(torch, dev, 3, 3, cin, cin, i)
        _, flops = _dcn_cost(torch, x, off, stride)
        m_sites = off.shape[0] * off.shape[1] * off.shape[2]
        n_el = (x.numel() + off.numel() + mask.numel() + wt.numel()
                + bias.numel() + m_sites * cin)
        mm = 2 * m_sites * cin * 9 * cin
        ms8 = _device_ms(lambda: KD.deform_conv_cuda(
            x, off, wt, mask, bias, stride), 50)
        call8 = _time_ms(lambda: KD.deform_conv_cuda(
            x, off, wt, mask, bias, stride), 50)
        tally(kd8, ms8, call8, 0.0, 4 * n_el, flops, 3 * mm)
        xb, offb, wtb, maskb, biasb = (t.bfloat16() for t in (
            x, off, wt, mask, bias))
        ms = _device_ms(lambda: KD.deform_conv_cuda(
            xb, offb, wtb, maskb, biasb, stride), 100)
        call = _time_ms(lambda: KD.deform_conv_cuda(
            xb, offb, wtb, maskb, biasb, stride), 100)
        plain = _time_ms(lambda: KD.deform_conv_reference(
            xb, offb, wtb, maskb, biasb, stride), 3, warmup=1)
        bound, by = _bound_ms(2 * n_el, flops, bf16_flops=mm)
        for key, v in (('ms', ms), ('call_ms', call), ('plain_ms', plain),
                       ('bound_ms', bound), ('bytes_s',
                                             2 * n_el / PEAK_BYTES_PER_S),
                       ('ops_s', _ops_s(flops, bf16_flops=mm))):
            kdb[key] = kdb.get(key, 0.0) + v
        print(f'[time] deform_conv bf16 {site} x {EVAL_LANES} frames: kernel '
              f'{ms:.5f} ms (device), per wrapper call {call:.5f} ms, plain '
              f'{plain:.5f} ms, bound {bound:.5f} ms ({by}; {2 * n_el} B, '
              f'{flops} fp32 flop, {mm} bf16 flop); fp32 sibling {ms8:.5f} ms')
        del x, off, mask, xb, offb, maskb
    print(f'[time] deform_conv bf16, 7 sites x {EVAL_LANES} frames summed: '
          f'{kdb["ms"]:.5f} ms (device), per call {kdb["call_ms"]:.5f} ms, '
          f'plain {kdb["plain_ms"]:.5f} ms, bound {kdb["bound_ms"]:.5f} ms; '
          f'fp32 sibling {kd8["ms"]:.5f} ms (bound {kd8["bound_ms"]:.5f} ms) '
          f'({smi})', flush=True)

    # ---- 6. the training step ----------------------------------------------
    from stmask_torch.data.transforms import prepare_batch
    from stmask_torch.train.loop import train
    from stmask_torch.train.train_step import build_train_step
    model = build_model(cfg, dev, seed=0)
    step, init = build_train_step(cfg, model, dev)
    hosts = [_train_batch(cfg, 10 + i) for i in range(TRAIN_STEPS + 2)]
    batches = [prepare_batch(cfg, h_, dev) for h_ in hosts[:TRAIN_STEPS]]
    before_p = {n: p.detach().clone() for n, p in model.named_parameters()}
    before_b = {n: b.clone() for n, b in model.named_buffers()}
    n_gt = [int(b_['valid'].sum()) for b_ in batches]
    state = init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k.launches = 0
    step_ms, metrics = [], []
    for b_ in batches:
        t0 = time.perf_counter()
        state, m = step(state, b_)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    train_launches = {n: k.launches for n, k in KERNELS.items()}
    train_peak = torch.cuda.max_memory_allocated()
    print(f'[train] launches {train_launches} over {TRAIN_STEPS} steps '
          f'(gt boxes per step {n_gt})', flush=True)
    for n_, per in TRAIN_LAUNCHES.items():
        assert train_launches[n_] == per * TRAIN_STEPS, (n_, train_launches)
    for i, m in enumerate(metrics):
        vals = {k: float(v) for k, v in m.items()}
        print(f'[train] step {i}: ' + ', '.join(
            f'{k} {v:.5f}' for k, v in vals.items()))
        assert all(np.isfinite(v) for v in vals.values()), (i, vals)
    offset_grads = [float(p.grad.abs().max()) for n_, p in
                     model.named_parameters() if 'conv_offset_mask' in n_]
    assert len(offset_grads) == 14 and min(offset_grads) > 0, offset_grads
    assert _params_moved(torch, before_p, model, 'conv_offset_mask.weight')
    n_moved = sum(not torch.equal(before_p[n_], p.detach())
                  for n_, p in model.named_parameters())
    for n_, b_ in model.named_buffers():
        assert torch.equal(b_, before_b[n_]), n_
    steady = sorted(step_ms[TRAIN_WARMUP:])
    train_med = (steady[len(steady) // 2 - 1] + steady[len(steady) // 2]) / 2
    print(f'[train] STMask_plus_resnet50 {cfg.img_h}x{cfg.img_w} fp32 (TF32 '
          f'off), {TRAIN_CLIPS} clips = {2 * TRAIN_CLIPS} frames a step: '
          f'median {train_med:.3f} ms/step over {len(steady)} steps after '
          f'{TRAIN_WARMUP} warm-up ({2 * TRAIN_CLIPS * 1e3 / train_med:.2f} '
          f'frames/s), all steps {[round(t, 3) for t in step_ms]}; peak '
          f'memory {train_peak / 2**20:.1f} MiB ({name}, {smi}); '
          f'{n_moved} of {len(before_p)} parameters moved, every '
          f'conv_offset_mask with a gradient (max |grad| '
          f'{min(offset_grads):.3e} to {max(offset_grads):.3e}) and moved; '
          f'BN buffers unchanged', flush=True)

    # the from-scratch state: every offset predictor zero, every offset on
    # the bilinear kink
    with torch.no_grad():
        for n_, p in model.named_parameters():
            if 'conv_offset_mask' in n_:
                p.zero_()
    state, m = step(state, batches[0])
    vals = {k: float(v) for k, v in m.items()}
    print('[train] zero-offset step: ' + ', '.join(
        f'{k} {v:.5f}' for k, v in vals.items()), flush=True)
    assert all(np.isfinite(v) for v in vals.values()), vals

    # one step of the loop with a checkpoint, then a resumed step
    with tempfile.TemporaryDirectory() as tmp:
        save_dir, log_dir = f'{tmp}/weights', f'{tmp}/logs'
        s1 = train(cfg.replace(max_iter=1), model, iter(hosts[-2:-1]),
                   save_dir, log_dir, save_interval=1, device=dev)
        saved = sorted(os.listdir(save_dir))
        s2 = train(cfg.replace(max_iter=2), model, iter(hosts[-1:]),
                   save_dir, log_dir, resume='latest', device=dev)
        n_log = sum(1 for _ in open(f'{log_dir}/{cfg.name}.log'))
        print(f'[loop] checkpoints {saved}, then {sorted(os.listdir(save_dir))}'
              f'; steps {s1.step} then {s2.step} (resumed); {n_log} log lines',
              flush=True)
        assert saved == [f'{cfg.name}_0_1.pth'] and s1.step == 1
        assert s2.step == 2 and int(s2.count) == 2

    # the card against the CPU path: one step at 96x128, full depth.
    # Losses rtol 2e-3; gradients: relative L2 error 2e-3 over all
    # parameters and 2e-2 per parameter (cuDNN and CPU convolutions sum in
    # another order, the fused conv is 3xTF32 and K4 adds with atomics, so
    # a ReLU whose input lies within rounding of 0 can switch on one side)
    small = cfg.replace(img_h=96, img_w=128)
    host = _train_batch(small, 99, clips=1)
    res = {}
    for d_ in (torch.device('cpu'), dev):
        mdl = build_model(small, d_, seed=0)
        st_, in_ = build_train_step(small, mdl, d_)
        _, m = st_(in_(), prepare_batch(small, host, d_))
        res[d_.type] = ({k: float(v) for k, v in m.items()},
                        {n: p.grad.detach().cpu().double()
                         for n, p in mdl.named_parameters()})
        del mdl, st_, in_
    (cm, cg), (gm, gg) = res['cpu'], res['cuda']
    for k in cm:
        print(f'[check] train card vs CPU {k}: {gm[k]:.6f} vs {cm[k]:.6f}')
        assert abs(gm[k] - cm[k]) <= 2e-3 * abs(cm[k]) + 1e-7, k
    rel = {n: float((gg[n] - cg[n]).norm() / cg[n].norm().clamp(min=1e-30))
           for n in cg}
    tot = float(sum((gg[n] - cg[n]).norm() ** 2 for n in cg) ** 0.5
                / sum(cg[n].norm() ** 2 for n in cg) ** 0.5)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    print(f'[check] train card vs CPU gradients: relative L2 error over '
          f'{len(cg)} parameters {tot:.3e} (limit 2e-3); worst '
          f'{[(n, round(v, 6)) for n, v in worst]} (limit 2e-2 each)',
          flush=True)
    assert tot <= 2e-3 and worst[0][1] <= 2e-2, (tot, worst)

    # one steady training step under torch.profiler
    rows = _device_events(lambda: step(state, batches[1]), 1)
    if rows:
        dev_ms = sum(us for _, _, us in rows) / 1e3
        n_kern = sum(c for _, c, _ in rows)
        print(f'[profile] train step: device busy {dev_ms:.3f} ms of '
              f'{train_med:.3f} ms wall (idle share '
              f'{1 - dev_ms / train_med:.3f}), {n_kern} kernel launches')
        for key, cnt, us in sorted(rows, key=lambda r: -r[2])[:15]:
            print(f'[profile]   {us / 1e3:8.4f} ms/step {cnt:6d}x  '
                  f'{key[:100]}')
    else:
        print('[profile] torch.profiler recorded no device time for the '
              'train step: device busy share not measured')
    del model, step, state, batches

    # the correlation's backward as the training step runs it: the op's
    # gradient through torch.cat (a channel slice of the cat's gradient) is
    # K3 alone, with the activation's derivative folded in: one launch a
    # call, and no other kernel in a profile of 50 calls (a profiler
    # session after earlier ones misses the first few launches, so one
    # call is not enough)
    tshape = (TRAIN_CLIPS, 24, 40, 256)
    up, x1, x2, _ = _corr_bwd_inputs(torch, dev, tshape, 11, g)
    a1, a2 = (t.clone().requires_grad_(True) for t in (x1, x2))
    from stmask_torch.ops.correlation import correlate as op_correlate
    corr = op_correlate(a1, a2, 11)
    cat = torch.cat([corr, x1], dim=-1)
    g_cat = torch.randn(cat.shape, device=dev, generator=g)
    n0 = K3.KERNEL.launches
    rows = _device_events(lambda: torch.autograd.grad(
        cat, (a1, a2), g_cat, retain_graph=True), 50)
    assert K3.KERNEL.launches - n0 == 51, K3.KERNEL.launches - n0
    print(f'[train] correlation backward through torch.cat, 50 calls: K3 '
          f'launches {K3.KERNEL.launches - n0 - 1}, device kernels '
          f'{[(k[:60], c) for k, c, _ in rows]}', flush=True)
    if rows:
        assert len(rows) == 1 and 'correlation_bwd' in rows[0][0] and \
            rows[0][1] >= 25, rows
    else:
        print('[train] torch.profiler recorded no device time: the '
              'correlation backward\'s kernels not listed')
    del a1, a2, corr, cat, g_cat

    # K3 and K4 (and K2, whose training shapes are 8 frames) times
    out = K1.correlate_cuda(x1, x2, 11)     # negatives and border zeros
    k3_ms = _device_ms(lambda: K3.correlation_bwd_cuda(up, x1, x2, 11, out),
                       200)
    k3_call = _time_ms(lambda: K3.correlation_bwd_cuda(up, x1, x2, 11, out),
                       200)
    k3_plain = _time_ms(lambda: K3.correlation_bwd_reference(
        up, x1, x2, 11, out), 10)
    k3_bytes, k3_flops = _corr_bwd_cost(tshape, 11)
    k3_bound, k3_by = _bound_ms(k3_bytes, k3_flops)
    print(f'[time] correlation_bwd {list(tshape)} P 11: kernel {k3_ms:.5f} '
          f'ms (device), per wrapper call {k3_call:.5f} ms, plain '
          f'{k3_plain:.5f} ms, bound {k3_bound:.5f} ms ({k3_by}; {k3_bytes} '
          f'B, {k3_flops} flop)')
    k4, k2t, k4_zero = {}, {}, 0.0
    wgt, wg_before, wg_lib = {}, 0.0, 0.0
    for i, (site, (h, w, cin), stride) in enumerate(DCN_SITES):
        dcols, x, off, mask = _dcn_train_inputs(
            torch, dev, h, w, cin, stride, 2 * TRAIN_CLIPS, 'random', 400 + i)
        nbytes, flops = _col2im_cost(torch, x, off, stride)
        ms = _device_ms(lambda: K4.deform_col2im_cuda(dcols, x, off, mask,
                                                      3, 3, stride), 50)
        call = _time_ms(lambda: K4.deform_col2im_cuda(dcols, x, off, mask,
                                                      3, 3, stride), 50)
        plain = _time_ms(lambda: K4.deform_col2im_reference(
            dcols, x, off, mask, 3, 3, stride), 5)
        zero = _device_ms(lambda: torch.zeros_like(x), 50)
        k4_zero += zero
        bound, by = tally(k4, ms, call, plain, nbytes, flops)
        print(f'[time] deform_col2im {site} x 8 frames: kernel {ms:.5f} ms '
              f'(device, with the zeroing of dx: {zero:.5f} ms alone), per '
              f'wrapper call {call:.5f} ms, plain {plain:.5f} ms, bound '
              f'{bound:.5f} ms ({by}; {nbytes} B, {flops} flop); plan '
              f'{K4.col2im_plan(*off.shape[:3], cin, 3, 3, stride)}')
        got = K2.deform_im2col_cuda(x, off, mask, 3, 3, stride)
        want = K2.deform_im2col_reference(x, off, mask, 3, 3, stride)
        torch.cuda.synchronize()
        d = float((got - want).abs().max())
        err['deform_im2col'] = max(err['deform_im2col'], d)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        del got, want
        nbytes, flops = _dcn_cost(torch, x, off, stride)
        ms = _device_ms(lambda: K2.deform_im2col_cuda(x, off, mask, 3, 3,
                                                      stride), 50)
        call = _time_ms(lambda: K2.deform_im2col_cuda(x, off, mask, 3, 3,
                                                      stride), 50)
        plain = _time_ms(lambda: K2.deform_im2col_reference(
            x, off, mask, 3, 3, stride), 5)
        bound, by = tally(k2t, ms, call, plain, nbytes, flops)
        print(f'[time] deform_im2col {site} x 8 frames: max|diff| {d:.3e} '
              f'(atol 1e-5), kernel {ms:.5f} ms (device), per wrapper call '
              f'{call:.5f} ms, plain {plain:.5f} ms, bound {bound:.5f} ms '
              f'({by})')
        # deform_wgrad beside the route it replaced (K2, then the cuBLAS
        # SGEMM g^T @ cols) and that SGEMM alone.  Bound: the product as
        # three TF32 products (3 x 2MNK) on the tensor cores plus the
        # gather's fp32 flops, or x, offset, mask and g read and d_w
        # written once.
        gg = torch.randn(dcols.shape[0], cin, device=dev, generator=g)
        del dcols
        cols = K2.deform_im2col_cuda(x, off, mask, 3, 3, stride)
        w_ms = _device_ms(lambda: KW.deform_wgrad_cuda(gg, x, off, mask, 3,
                                                       3, stride), 50)
        w_call = _time_ms(lambda: KW.deform_wgrad_cuda(gg, x, off, mask, 3,
                                                       3, stride), 50)
        w_plain = _time_ms(lambda: KW.deform_wgrad_reference(
            gg, x, off, mask, 3, 3, stride), 5)
        b_ms = _device_ms(lambda: gg.t() @ K2.deform_im2col_cuda(
            x, off, mask, 3, 3, stride), 50)
        l_ms = _device_ms(lambda: gg.t() @ cols, 50)
        wg_before += b_ms
        wg_lib += l_ms
        w_bytes = 4 * (x.numel() + off.numel() + mask.numel() + gg.numel()
                       + 9 * cin * cin)
        w_tf32 = 3 * 2 * gg.shape[0] * cin * 9 * cin
        w_bound, w_by = tally(wgt, w_ms, w_call, w_plain, w_bytes, flops,
                              w_tf32)
        print(f'[time] deform_wgrad {site} x 8 frames: kernel {w_ms:.5f} ms '
              f'(device), per wrapper call {w_call:.5f} ms, plain '
              f'{w_plain:.5f} ms, bound {w_bound:.5f} ms ({w_by}; {w_bytes} '
              f'B, {flops} fp32 flop, {w_tf32} TF32 flop); before (K2 + '
              f'SGEMM) {b_ms:.5f} ms, the SGEMM alone {l_ms:.5f} ms (device); '
              f'plan {KW.wgrad_plan(gg.shape[0], cin, 9 * cin)}')
        # the tile heights and cluster splits wgrad_plan chooses among
        tiles = []
        for tm in (128, 256) if cin % 256 == 0 else (128,):
            for split in (2, 4, 8, 16)[:4 if tm == 128 else 3]:
                t = _device_ms(lambda: _wgrad_at(KW, gg, x, off, mask, stride,
                                                 tm, split), 50)
                tiles.append(f'tm{tm} s{split} {t:.5f}')
        print(f'[tiles] deform_wgrad {site} x 8 frames, ms (device): '
              f'{", ".join(tiles)}')
        del x, off, mask, gg, cols
    print(f'[time] 7 sites x 8 frames summed: deform_col2im {k4["ms"]:.5f} '
          f'ms (device; the zeroing of dx {k4_zero:.5f} ms of it), per call '
          f'{k4["call_ms"]:.5f} ms, plain '
          f'{k4["plain_ms"]:.5f} ms, bound {k4["bound_ms"]:.5f} ms; '
          f'deform_im2col {k2t["ms"]:.5f} ms, bound {k2t["bound_ms"]:.5f} ms; '
          f'deform_wgrad {wgt["ms"]:.5f} ms (device), per call '
          f'{wgt["call_ms"]:.5f} ms, plain {wgt["plain_ms"]:.5f} ms, bound '
          f'{wgt["bound_ms"]:.5f} ms, before (K2 + SGEMM) {wg_before:.5f} ms, '
          f'the SGEMM alone {wg_lib:.5f} ms ({smi})', flush=True)

    # ---- 7. the eval CLI --------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        ev = _eval_cli(torch, dev, smi, name, tmp)
    eval_launches = ev['launches']

    def by_of(acc):
        return 'bytes' if acc['bytes_s'] >= acc['ops_s'] else 'operations'

    sites = ('the 7 DCN sites of one 384x640 frame, one launch each; times '
             'are their sum')
    eval_path = (f'eval video step, {N_VIDEOS} videos x {FRAMES_PER_VIDEO} '
                 'frames')
    train_path = (f'training step, {TRAIN_STEPS} steps of {TRAIN_CLIPS} '
                  'clips')
    cli_path = (f'eval CLI (bf16, {EVAL_LANES} streams x {EVAL_CHUNK}-frame '
                f'chunks), {ev["stats"]["n_chunks"]} chunks and a warm-up '
                'chunk')
    table = {'kernels': [
        {'name': 'correlation', 'route': 'cuda',
         'source': 'stmask_torch/kernels/csrc/correlation.cu',
         'replaces': 'stmask_tpu/kernels/correlation_pallas.py:35',
         'launches': launches['correlation'], 'launches_path': eval_path,
         'train_launches': train_launches['correlation'],
         'max_abs_err': err['correlation'], 'ms': k1_ms,
         'call_ms': k1_call,
         'plain_ms': k1_plain, 'bound_ms': k1_bound, 'bound_by': k1_by,
         'library_ms': None,
         'shape': 'x1, x2 [1,24,40,256] fp32, patch 11; one launch'},
        {'name': 'correlation_bf16', 'route': 'cuda',
         'source': 'stmask_torch/kernels/csrc/correlation.cu',
         'replaces': 'stmask_tpu/kernels/correlation_pallas.py:35',
         'launches': eval_launches['correlation_bf16'],
         'launches_path': cli_path,
         'max_abs_err': err['correlation_bf16'], 'ms': k1b_ms,
         'call_ms': k1b_call, 'plain_ms': k1b_plain, 'bound_ms': k1b_bound,
         'bound_by': k1b_by, 'library_ms': None, 'fp32_ms': k1_ms,
         'shape': 'x1, x2 [1,24,40,256] bf16, patch 11, fp32 out; one '
                  'launch'},
        {'name': 'deform_im2col', 'route': 'cuda',
         'source': 'stmask_torch/kernels/csrc/deform_im2col.cu',
         'replaces': 'stmask_tpu/ops/deform_conv.py:31',
         'launches': train_launches['deform_im2col'],
         'launches_path': train_path,
         'eval_launches': launches['deform_im2col'],
         'max_abs_err': err['deform_im2col'], 'ms': k2t['ms'],
         'call_ms': k2t['call_ms'],
         'plain_ms': k2t['plain_ms'], 'bound_ms': k2t['bound_ms'],
         'bound_by': by_of(k2t), 'library_ms': None,
         'shape': sites.replace('one 384x640 frame', '8 384x640 frames')
         + '; no path launches it: the yardstick of the fused conv and '
           'deform_wgrad'},
        {'name': 'deform_conv', 'route': 'cuda',
         'source': 'stmask_torch/kernels/csrc/deform_conv.cu',
         'replaces': 'stmask_tpu/ops/deform_conv.py:31',
         'launches': launches['deform_conv'], 'launches_path': eval_path,
         'train_launches': train_launches['deform_conv'],
         'max_abs_err': err['deform_conv'], 'ms': kd['ms'],
         'call_ms': kd['call_ms'],
         'plain_ms': kd['plain_ms'], 'bound_ms': kd['bound_ms'],
         'bound_by': by_of(kd), 'library_ms': None,
         'before_ms': before, 'shape': sites},
        {'name': 'deform_conv_bf16', 'route': 'cuda',
         'source': 'stmask_torch/kernels/csrc/deform_conv.cu',
         'replaces': 'stmask_tpu/ops/deform_conv.py:31',
         'launches': eval_launches['deform_conv_bf16'],
         'launches_path': cli_path,
         'max_abs_err': err['deform_conv_bf16'], 'ms': kdb['ms'],
         'call_ms': kdb['call_ms'], 'plain_ms': kdb['plain_ms'],
         'bound_ms': kdb['bound_ms'], 'bound_by': by_of(kdb),
         'library_ms': None, 'fp32_ms': kd8['ms'],
         'shape': sites.replace('one 384x640 frame',
                                f'{EVAL_LANES} 384x640 frames in bf16')},
        {'name': 'correlation_bwd', 'route': 'cuda',
         'source': 'stmask_torch/kernels/csrc/correlation_bwd.cu',
         'replaces': 'stmask_tpu/ops/correlation.py:22 (its XLA transpose; '
                     'forward kernels/correlation_pallas.py:35)',
         'launches': train_launches['correlation_bwd'],
         'launches_path': train_path,
         'max_abs_err': err['correlation_bwd'], 'ms': k3_ms,
         'call_ms': k3_call, 'plain_ms': k3_plain, 'bound_ms': k3_bound,
         'bound_by': k3_by, 'library_ms': None,
         'shape': f'g, out [{TRAIN_CLIPS},24,40,121], x1, x2 [{TRAIN_CLIPS},'
                  '24,40,256] fp32; one launch, the derivative folded in'},
        {'name': 'deform_col2im', 'route': 'cuda',
         'source': 'stmask_torch/kernels/csrc/deform_col2im.cu',
         'replaces': 'stmask_tpu/ops/deform_conv.py:152 '
                     '(_make_window_gather VJP, with deform_conv2d_window '
                     ':270)',
         'launches': train_launches['deform_col2im'],
         'launches_path': train_path,
         'max_abs_err': err['deform_col2im'],
         'max_abs_err_is': 'relative to max|ref|', 'ms': k4['ms'],
         'call_ms': k4['call_ms'], 'plain_ms': k4['plain_ms'],
         'bound_ms': k4['bound_ms'], 'bound_by': by_of(k4),
         'library_ms': None,
         'shape': sites.replace('one 384x640 frame', '8 384x640 frames')},
        {'name': 'deform_wgrad', 'route': 'cuda',
         'source': 'stmask_torch/kernels/csrc/deform_wgrad.cu',
         'replaces': 'stmask_tpu/ops/deform_conv.py:347 (the transpose of '
                     'jnp.dot in deform_conv2d_window :270; on the port\'s '
                     'path K2 + g^T @ cols)',
         'launches': train_launches['deform_wgrad'],
         'launches_path': train_path,
         'max_abs_err': err['deform_wgrad'],
         'max_abs_err_is': 'relative to max|ref|', 'ms': wgt['ms'],
         'call_ms': wgt['call_ms'], 'plain_ms': wgt['plain_ms'],
         'bound_ms': wgt['bound_ms'], 'bound_by': by_of(wgt),
         'library_ms': wg_lib, 'library_is': 'the cuBLAS SGEMM g^T @ cols '
                                             'alone',
         'before_ms': wg_before, 'before_is': 'K2 + the SGEMM',
         'shape': sites.replace('one 384x640 frame', '8 384x640 frames')}]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
