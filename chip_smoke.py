#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero):
  1. build the CUDA kernels from stmask_torch/kernels/csrc with nvcc (one
     process per source, in parallel) and print ptxas's registers, shared
     memory and spills of the correlation and the fused deformable conv;
  2. K1 (correlation) against its plain PyTorch version, main-path and
     ragged shapes;
  3. K2 (deformable gather) against its plain version at the 7 DCN sites'
     shapes of a 384x640 input, alone and after the fp32 matmul; then the
     fused deformable conv against its plain version at the 7 sites and at
     ragged, rectangular and dilated shapes, at a tolerance that a single
     TF32 product (emulated at the 7 sites as a control) fails;
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
     replaced) and, as a size reference only, a dense cuDNN 3x3 conv;
  6. the training step of STMask_plus_resnet50 at 360x640 (seeded random
     weights, 4 clips = 8 frames a step, synthetic batches in ClipLoader's
     format) through build_train_step: 6 steps (2 warm-up), launch counts
     per step (the fused conv, K2, K4 at the 7 DCN sites, K1 and K3 once),
     a step from the zero-offset state, one step of the loop with a
     checkpoint save and restore, the card against the CPU path at 96x128,
     a profile of one step, and the times of K3 and K4.

K3 (correlation backward) and K4 (deformable col2im) are checked against
their plain versions in phases 2 and 3, beside K1, K2 and the fused conv.

Prints a JSON kernel table and the card's name and power limit, and as its
last line {"ok": true, "device": {...}}.  Without a GPU it prints no result
and exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12        # H100 SXM fp32, non-tensor-core
PEAK_TF32_FLOPS = 495e12       # H100 SXM TF32 tensor cores, dense
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
TRAIN_LAUNCHES = {'deform_conv': 7, 'deform_im2col': 7, 'deform_col2im': 7,
                  'correlation': 1, 'correlation_bwd': 1}
KERNEL_NAMES = ('correlation', 'deform_im2col', 'deform_conv',
                'correlation_bwd', 'deform_col2im')
DCN_SITES = [  # name, (H, W, Cin) of the DCN input at 384x640, stride
    ('layer1_0', (96, 160, 128), 2), ('layer1_2', (48, 80, 128), 1),
    ('layer2_0', (48, 80, 256), 2), ('layer2_2', (24, 40, 256), 1),
    ('layer2_4', (24, 40, 256), 1), ('layer3_0', (24, 40, 512), 2),
    ('layer3_2', (12, 20, 512), 1)]


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


def _ops_s(flops: float, tf32_flops: float = 0.0) -> float:
    """Seconds of arithmetic: fp32 flops on the CUDA cores plus TF32 flops
    on the tensor cores, each at its peak."""
    return flops / PEAK_FP32_FLOPS + tf32_flops / PEAK_TF32_FLOPS


def _bound_ms(nbytes: float, flops: float, tf32_flops: float = 0.0):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = _ops_s(flops, tf32_flops) * 1e3
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


def _dcn_inputs(torch, dev, h, w, cin, stride, seed, kh=3, kw=3):
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(1, h, w, cin, device=dev, generator=g)
    off = torch.randn(1, ho, wo, 2 * kh * kw, device=dev, generator=g) * 2.0
    mask = torch.rand(1, ho, wo, kh * kw, device=dev, generator=g)
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
    """(bytes, flops) of K3: g, x1, x2 read once, dx1, dx2 written once; 2
    flops per channel for every in-image (pixel, displacement) term of
    each output."""
    b, h, w, c = shape
    r = (patch - 1) // 2
    terms = sum((h - abs(dy)) * (w - abs(dx)) for dy in range(-r, r + 1)
                for dx in range(-r, r + 1) if abs(dy) < h and abs(dx) < w)
    nbytes = 4 * (b * h * w * patch * patch + 4 * b * h * w * c)
    return nbytes, 2 * 2 * c * b * terms


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


def _dcn_train_inputs(torch, dev, h, w, cin, stride, frames, kind, seed):
    """K4's inputs at one DCN site: x, dcols and the mask random; the
    offsets random (std 1.5, so some pass +-2 and are clamped, as the
    window op clamps them before K4), all 0, or all +-1 / +-2."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(frames, h, w, cin, device=dev, generator=g)
    shape = (frames, ho, wo, 18)
    if kind == 'random':
        off = torch.randn(shape, device=dev, generator=g) * 1.5
    elif kind == 'zero':
        off = torch.zeros(shape, device=dev)
    else:
        vals = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=dev)
        off = vals[torch.randint(0, 4, shape, device=dev, generator=g)]
    off = off.clamp(-2, 2)
    mask = torch.rand(frames, ho, wo, 9, device=dev, generator=g)
    dcols = torch.randn(frames * ho * wo, 9 * cin, device=dev, generator=g)
    return dcols, x, off, mask


def _params_moved(torch, before, model, which):
    return all(not torch.equal(before[n], p.detach())
               for n, p in model.named_parameters() if which in n)


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

    # ---- 2. K1 vs plain ---------------------------------------------------
    err = {n: 0.0 for n in KERNEL_NAMES}
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

    # K3 at the training shape (4 clips at 384x640) and ragged ones (odd H
    # and W, C not a multiple of 32, patch 5), upstream gradient of both
    # signs; gather form, so the sums differ only in their order
    for shape, patch in (((4, 24, 40, 256), 11), ((2, 7, 9, 40), 5),
                         ((1, 5, 7, 5), 11), ((2, 9, 13, 100), 5)):
        x1 = torch.randn(shape, device=dev, generator=g)
        x2 = torch.randn(shape, device=dev, generator=g)
        up = torch.randn(shape[:3] + (patch * patch,), device=dev,
                         generator=g)
        got = K3.correlation_bwd_cuda(up, x1, x2, patch)
        want = K3.correlation_bwd_reference(up, x1, x2, patch)
        torch.cuda.synchronize()
        d = max(float((a - b).abs().max()) for a, b in zip(got, want))
        err['correlation_bwd'] = max(err['correlation_bwd'], d)
        print(f'[K3] correlation_bwd {shape} patch {patch}: max|diff| '
              f'{d:.3e} (atol 1e-5, rtol 1e-5)', flush=True)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)

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

    # K4 at the 7 sites with 8 frames and three offset sets.  dx sums with
    # fp32 atomics and d_offset / d_mask with a warp butterfly, so the
    # tolerance is 1e-5 of max|ref|.
    for i, (site, (h, w, cin), stride) in enumerate(DCN_SITES):
        for kind in ('random', 'zero', 'integer'):
            args = _dcn_train_inputs(torch, dev, h, w, cin, stride,
                                     2 * TRAIN_CLIPS, kind, 300 + i)
            got = K4.deform_col2im_cuda(*args, 3, 3, stride)
            want = K4.deform_col2im_reference(*args, 3, 3, stride)
            torch.cuda.synchronize()
            worst = 0.0
            for out_name, a, b in zip(('dx', 'd_offset', 'd_mask'), got,
                                      want):
                scale = max(float(b.abs().max()), 1.0)
                d = float((a - b).abs().max())
                worst = max(worst, d / scale)
                torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=0,
                                           msg=f'{site} {kind} {out_name}')
            err['deform_col2im'] = max(err['deform_col2im'], worst)
            print(f'[K4] {site} x {(2 * TRAIN_CLIPS, h, w, cin)} stride '
                  f'{stride}, {kind} offsets: max|diff| / max|ref| '
                  f'{worst:.3e} (atol 1e-5 of max|ref|)', flush=True)
            del args, got, want

    # the whole window DCN op (clamp, fused forward, K2, two matmuls, K4)
    # on the card against its CPU plain path: five gradients
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

    # K3 and K4 (and K2, whose training shapes are 8 frames) times
    tshape = (TRAIN_CLIPS, 24, 40, 256)
    x1 = torch.randn(tshape, device=dev, generator=g)
    x2 = torch.randn(tshape, device=dev, generator=g)
    up = torch.randn(tshape[:3] + (121,), device=dev, generator=g)
    k3_ms = _device_ms(lambda: K3.correlation_bwd_cuda(up, x1, x2, 11), 200)
    k3_call = _time_ms(lambda: K3.correlation_bwd_cuda(up, x1, x2, 11), 200)
    k3_plain = _time_ms(lambda: K3.correlation_bwd_reference(up, x1, x2, 11),
                        10)
    k3_bytes, k3_flops = _corr_bwd_cost(tshape, 11)
    k3_bound, k3_by = _bound_ms(k3_bytes, k3_flops)
    print(f'[time] correlation_bwd {list(tshape)} P 11: kernel {k3_ms:.5f} '
          f'ms (device), per wrapper call {k3_call:.5f} ms, plain '
          f'{k3_plain:.5f} ms, bound {k3_bound:.5f} ms ({k3_by}; {k3_bytes} '
          f'B, {k3_flops} flop)')
    k4, k2t = {}, {}
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
        bound, by = tally(k4, ms, call, plain, nbytes, flops)
        print(f'[time] deform_col2im {site} x 8 frames: kernel {ms:.5f} ms '
              f'(device, with the zeroing of dx), per wrapper call '
              f'{call:.5f} ms, plain {plain:.5f} ms, bound {bound:.5f} ms '
              f'({by}; {nbytes} B, {flops} flop)')
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
        del dcols, x, off, mask
    print(f'[time] 7 sites x 8 frames summed: deform_col2im {k4["ms"]:.5f} '
          f'ms (device), per call {k4["call_ms"]:.5f} ms, plain '
          f'{k4["plain_ms"]:.5f} ms, bound {k4["bound_ms"]:.5f} ms; '
          f'deform_im2col {k2t["ms"]:.5f} ms, bound {k2t["bound_ms"]:.5f} ms '
          f'({smi})', flush=True)

    def by_of(acc):
        return 'bytes' if acc['bytes_s'] >= acc['ops_s'] else 'operations'

    sites = ('the 7 DCN sites of one 384x640 frame, one launch each; times '
             'are their sum')
    eval_path = (f'eval video step, {N_VIDEOS} videos x {FRAMES_PER_VIDEO} '
                 'frames')
    train_path = (f'training step, {TRAIN_STEPS} steps of {TRAIN_CLIPS} '
                  'clips')
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
         + '; rebuilds cols in the DCN backward'},
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
        {'name': 'correlation_bwd', 'route': 'cuda',
         'source': 'stmask_torch/kernels/csrc/correlation_bwd.cu',
         'replaces': 'stmask_tpu/ops/correlation.py:22 (its XLA transpose; '
                     'forward kernels/correlation_pallas.py:35)',
         'launches': train_launches['correlation_bwd'],
         'launches_path': train_path,
         'max_abs_err': err['correlation_bwd'], 'ms': k3_ms,
         'call_ms': k3_call, 'plain_ms': k3_plain, 'bound_ms': k3_bound,
         'bound_by': k3_by, 'library_ms': None,
         'shape': f'g [{TRAIN_CLIPS},24,40,121], x1, x2 [{TRAIN_CLIPS},24,40,'
                  '256] fp32; one launch'},
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
         'shape': sites.replace('one 384x640 frame', '8 384x640 frames')}]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
