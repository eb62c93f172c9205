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
     replaced) and, as a size reference only, a dense cuDNN 3x3 conv.

Prints a JSON kernel table and the card's name and power limit, and as its
last line {"ok": true, "device": {...}}.  Without a GPU it prints no result
and exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
    _, ho, wo, _ = off.shape
    k = torch.arange(3, device=x.device)
    oy = torch.arange(ho, device=x.device) * stride - 1      # pad 1
    ox = torch.arange(wo, device=x.device) * stride - 1
    base_y = (oy[:, None, None, None] + k[None, None, :, None]).expand(
        ho, wo, 3, 3).reshape(ho, wo, 9)
    base_x = (ox[None, :, None, None] + k[None, None, None, :]).expand(
        ho, wo, 3, 3).reshape(ho, wo, 9)
    o = off.reshape(ho, wo, 9, 2)
    y0 = torch.floor(base_y + o[..., 0])
    x0 = torch.floor(base_x + o[..., 1])
    corners = sum(int((((y0 + dy) >= 0) & ((y0 + dy) < h) & ((x0 + dx) >= 0)
                       & ((x0 + dx) < w)).sum())
                  for dy in (0, 1) for dx in (0, 1))
    n_out = ho * wo * 9 * cin
    nbytes = 4 * (x.numel() + off.numel() + ho * wo * 9 + n_out)
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
    secs = build.build(['correlation', 'deform_im2col', 'deform_conv'])
    print(f'[build] correlation + deform_im2col + deform_conv with nvcc '
          f'{" ".join(build.NVCC_FLAGS)}: {secs:.2f} s', flush=True)
    for lib in ('correlation', 'deform_conv'):
        for line in build.ptxas_report(lib):
            print(f'[ptxas] {lib}: {line}')

    # ---- 2. K1 vs plain ---------------------------------------------------
    err = {'correlation': 0.0, 'deform_im2col': 0.0, 'deform_conv': 0.0}
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

    def by_of(acc):
        return 'bytes' if acc['bytes_s'] >= acc['ops_s'] else 'operations'

    sites = ('the 7 DCN sites of one 384x640 frame, one launch each; times '
             'are their sum')
    table = {'kernels': [
        {'name': 'correlation', 'route': 'cuda',
         'source': 'stmask_torch/kernels/csrc/correlation.cu',
         'replaces': 'stmask_tpu/kernels/correlation_pallas.py:35',
         'launches': launches['correlation'],
         'max_abs_err': err['correlation'], 'ms': k1_ms,
         'call_ms': k1_call,
         'plain_ms': k1_plain, 'bound_ms': k1_bound, 'bound_by': k1_by,
         'library_ms': None,
         'shape': 'x1, x2 [1,24,40,256] fp32, patch 11; one launch'},
        {'name': 'deform_im2col', 'route': 'cuda',
         'source': 'stmask_torch/kernels/csrc/deform_im2col.cu',
         'replaces': 'stmask_tpu/ops/deform_conv.py:31',
         'launches': launches['deform_im2col'],
         'max_abs_err': err['deform_im2col'], 'ms': k2['ms'],
         'call_ms': k2['call_ms'],
         'plain_ms': k2['plain_ms'], 'bound_ms': k2['bound_ms'],
         'bound_by': by_of(k2), 'library_ms': None,
         'shape': sites + '; off the main path'},
        {'name': 'deform_conv', 'route': 'cuda',
         'source': 'stmask_torch/kernels/csrc/deform_conv.cu',
         'replaces': 'stmask_tpu/ops/deform_conv.py:31',
         'launches': launches['deform_conv'],
         'max_abs_err': err['deform_conv'], 'ms': kd['ms'],
         'call_ms': kd['call_ms'],
         'plain_ms': kd['plain_ms'], 'bound_ms': kd['bound_ms'],
         'bound_by': by_of(kd), 'library_ms': None,
         'before_ms': before, 'shape': sites}]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
