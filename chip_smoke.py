#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero):
  1. build the CUDA kernels from stmask_torch/kernels/csrc with nvcc (one
     process per source, in parallel) and print ptxas's registers, shared
     memory and spills of every kernel (K4, among them its two bf16 fast
     instantiations, the fused conv's fast route, K5's three fast
     instantiations and deform_wgrad must not spill);
  2. the frame resize (``resize_u8``) on the card against the machine's cv2
     INTER_LINEAR, bit for bit, at the sizes of RESIZES; K1 (correlation)
     against its plain PyTorch version, main-path and ragged shapes, with
     fp32 and with bf16 inputs (the bf16 route printed: the eval shape on
     the fast route, C 5 and an unaligned map on the general one);
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
     bf16 K1 (beside its general route, with the split of both routes) and
     the bf16 fused conv (8 frames) beside their fp32 siblings;
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
     of 8 frames, the bf16 K1 once a step over the 8 lanes), frames/s end
     to end and
     device-only, peak memory, mAP; a profile of steady chunks (idle share,
     launches a frame); one bf16 batched chunk on the card against the CPU
     path at 96x128;
  8. the training CLI (``python -m stmask_torch.train``'s ``run``) over a
     synthetic YouTube-VIS set of 4 videos x 8 JPEG frames at 1280x720:
     12 steps of 4 clips through ClipLoader (8 workers) and the loop's
     Prefetcher, validation after each epoch of 8 steps on 2 videos (the
     eval CLI's bf16 path, on a copy of the model), then --resume latest
     for 4 more steps: launch counts per step, checkpoint names, the
     resumed iteration, bf16-only validation with the fp32 training model
     unchanged; the CLI's ms/step beside phase 6's step alone, the data
     path's ms a batch, the idle share of profiled steady steps, peak
     memory;
  9. FCB (STMask_plus_resnet50_ada / _ali): the fused conv in fp32, in
     bf16 and in bf16 with fp32 offsets (ali's), deform_wgrad and K4 at
     FCB's 15 sites (FCB_SITES) against their plain versions; the _ada
     eval video step over phase 4's videos (the fused conv at 7 + 15 sites
     a frame) with the card against the CPU path; the eval CLI with
     --config STMask_plus_resnet50_ali over phase 7's set (the fp32-offset
     bf16 entry 15 times a step); the _ada training step (the fused conv,
     deform_wgrad and K4 22 times a step) with the card against the CPU
     path, and 4 _ali steps (ROADMAP C.7); the kernels' times at FCB's
     sites;
 10. the mAP* NMS family and the legacy YOLACT preset: B5 (greedy NMS),
     both entries (the IoU matrix; the boxes, IoUs formed in the kernel)
     against their plain versions, bit for bit, at GREEDY_SHAPES, the
     boxes entry also on near-threshold and degenerate boxes; the split of
     the greedy path before the boxes entry (the caller's IoU formation,
     the matrix entry's rows and scan) and of the boxes entry, and both
     entries' times; the flagship's fp32 eval step over phase 4's videos
     under per_class, greedy and cc + nms_as_miou beside phase 4's cc
     (greedy_nms_boxes once a frame under greedy), with each family's
     detect_frame, and cc's, on the card against the CPU path, and the
     greedy step exported and run against the live one;
     YOLACT_legacy_resnet50 at full depth and width (no DCN, no TF:
     the simple tracker), its fp32 eval step (no deformable conv or
     correlation launch) with a profile and the model against the CPU
     path, and the eval CLI's defaults with --nms greedy over phase 7's
     set (greedy_nms_boxes once a step over the 8 lanes, 4 a chunk);
 11. the rest of the model surface: (a) the fp32 eval step of
     STMask_resnet50_gn and STMask_darknet53 at full depth and width over
     phase 4's videos (K1 once a frame, no deformable conv), each model
     against the CPU path at 96x128, and STMask_vgg16's forward alone with
     its video step's ValueError (18180 anchors against 15345 priors,
     ROADMAP C.8); (b) the training step of STMask_resnet50_gn (GroupNorm
     trained; K1 and K3 once a step) and YOLACT_legacy_resnet50 (no kernel
     of the port) over phase 6's batches, each against the CPU path at
     96x128; (c) the flagship at 96x128 under every flag of FLAG_SURFACE:
     one training step with every key of FLAG_KEYS, and the re-scored eval
     step, each on the card against the CPU path; then ROADMAP C.7's
     paths: the fp32 eval step of STMask_plus_resnet50's R101 sibling
     STMask_plus_base (the fused conv at its 11 DCN sites) and the eval
     CLI with --config STMask_plus_resnet50_ada over phase 7's set (the
     bf16 fused conv at 7 + 15 sites a step).
 12. the eval CLI's other modes and the training overlays: (a)
     --video_dir --display over one video of phase 7's set (fp32: the
     fused conv 7 times and K1 once a frame), frames/s; (b) --benchmark over
     phase 7's set: the stage table (load, step, postprocess, one call a
     frame), FPS, no JSON, beside phase 4's step; (c) --display
     --display_lincomb --display_fpn_outs over 2 videos: an overlay, 3
     proto/ grids and 5 fpn/ grids (P3..P7) a frame, each grid's shape;
     (d) --coco --eval_metrics over 16 synthetic COCO images at 1280x720
     (one-frame videos; the bf16 launches a chunk), finite metrics; (e) the
     training CLI with --vis_every 2 over phase 8's set (4 steps: the
     overlay files, the overlay forward's launches, ms a call), and a
     direct save_train_output on the card that leaves every parameter and
     buffer bit for bit; (f) --metrics_only --tensorboard_dir (an events
     file, or the JAX script's skip message without TensorBoard); then
     --video_dir on the card against the CPU at 96x128, reduced depth.
 13. data-parallel training and the serving artifact: (a) DP_RANKS gloo
     ranks spawned on the one card, each with its share of phase 6's
     first DP_STEPS batches (2 clips of 4), from the same seeded weights
     (rank 1's shifted, which replicate undoes): the losses and gnorm of
     each step against one process over the whole batches, the last
     step's raw gradients and parameters against one process's step from
     rank 0's own state, the control (each shard's losses and gradients
     with its own normalizers, averaged) outside the limits at the first
     and the last step, the witness (one process, cuDNN deterministic,
     the network over two 2-clip slices) beside them, launches a rank and
     step (phase 6's), ms/step a rank beside phase 6's, peak memory, the
     gradients' all_reduce alone; (b) an NCCL process group of world size
     1 on the card: its collectives and 2 training steps against phase
     6's, then the training CLI under torchrun --nproc_per_node=1 for 2
     steps over phase 8's set; (c) python -m stmask_torch.export of the
     fp32 single-stream step and of the bf16 2-stream 2-frame step, each
     loaded in a fresh process that imports no model code and run over
     phase 4's videos against the live step (ids and kept slots equal,
     box / score / mask within EXPORT_ATOL; launches: 7 fused conv and 1
     K1 a frame, 14 bf16 fused conv and 2 bf16 K1 a chunk), with the
     export, save and load seconds, the artifact's size and the CLI's
     --bench frames/s beside phase 4's step.
 14. bf16 training and remat: (a) the bf16 entries of deform_wgrad, K4
     (each also with fp32 offsets) and K3 against their plain versions
     (one bf16 ulp of each value plus 2^-12 of max|ref|; d_w, d_offset,
     d_mask, dx1 and dx2 bit for bit over two launches) and their times
     and bounds: at the flagship's 7 sites and FCB's 15 (bf16 and fp32
     offsets) x 8 frames, K3 at [4, 24, 40, 256]; deform_wgrad's bf16
     entries there on their fast path (the route printed), beside the fp32
     kernel on the same inputs, also checked at every site with bf16 and
     fp32 offsets, with and without the mask, random, zero and integer
     offsets, and off the fast path (Cin 48, an unaligned x: the general
     route); K4's bf16 entries on their fast route at all 22 sites (the
     route handed to the entry asserted), beside the general route and
     the fp32 kernel on the same inputs, off it (Cin 6, an unaligned x:
     the general route), and the split of both routes (kernels/split.py:
     builds with a part left out); K3 bf16's fast route against the plain
     version and bit for bit against its general route, both routes
     timed beside the fp32 entry on the same values, and the split of
     both routes (CORR_BWD); (b) the flagship's
     training step over phase 6's batches in each mode of
     build_train_step (fp32, remat, bf16, bf16 + remat): launches a step,
     ms/step, peak memory above the first step's start, the bf16 step's
     device busy share and top kernels under torch.profiler; remat against
     plain from the same state with cuDNN deterministic (gradients within
     1e-6 of their L2 norm, beside two plain steps), and bf16's losses
     against fp32's; (c) two bf16 + remat steps of
     STMask_plus_resnet50_ali (the f32off entries), finite losses and
     peak memory.

 15. training through the exact deformable gather (window radius 0): (a)
     K5 (the exact gather's backward: dx, d_offset, d_mask) against its
     plain version at the 7 DCN sites and FCB's 15 x 8 frames, at zero,
     integer-edge (rows and columns -1, 0, H-1, H), N(0, 6) and N(0, 1.5)
     offsets, with and without the mask, fp32 and both bf16 entries, on
     its fast route (asserted at every site) and its general route, each
     against the other (d_offset and d_mask bit for bit over two launches
     on each), with the share of the fast route's overflow items of each
     kind (none at zero offsets, asserted); then both routes' times and
     the bound at each site (the fast route's sum below the general's,
     asserted), and the split of both routes of the fp32 and bf16 entries
     (kernels/split.py, EXACT_BWD_F32 and EXACT_BWD); (b) deform_wgrad at
     N(0, 6) offsets against its plain version, fast and general paths,
     fp32 and bf16; (c) the flagship with
     dcn_window_radius 0 and STMask_plus_resnet50_ada with
     fcb_window_radius 0 on the card against the CPU at 96x128, and ROADMAP
     C.15's third run (_ada with FCB's offsets kept inside +-2), the five
     worst parameters of each beside phase 9's radius-2 comparison; (d) the
     training steps at 360x640 with both radii 0 (flagship and _ada fp32,
     _ada remat, bf16 and bf16 + remat, _ali bf16): launches a step, finite
     losses, ms/step, peak memory.
 16. the lane axis and the scan: (a) K1 at [8, 24, 40, 256] in fp32 and
     bf16 (fast route) against its plain version and bit for bit against 8
     one-lane launches; (b) B5's boxes entry at G = 8 x 40 over
     lane-offset indices into [8 * P, 4] boxes against its plain version
     and 8 one-lane launches, bit for bit; (c) one fp32 chunk of 8 lanes x
     4 frames of the flagship (a lane starting a new video mid-chunk, an
     idle lane) through build_video_step_batched, held against the
     per-lane wrappers applied lane by lane to the same forward outputs
     (ids, keep and classes equal; box, score and mask within LANE_ATOL);
     (d) its launches a step (the fused conv 7, K1 1); (e) device busy ms
     and launches of a chunk under torch.profiler, the lane axis beside the
     lane loop on the same frames; (f) build_video_scan over phase 4's
     videos in chunks of 6 (two chunks span a video boundary) against
     build_video_step, bit for bit.
 17. the scripts (stmask_torch/scripts/), each through its run() in
     process, the form of what each prints checked: (a) mfu, the FLOP
     count (utils/flops.py) of one flagship fp32 video step at 384x640 and
     of one fp32 training step of 1 clip at 96x128 on the card equal to
     the CPU's (the plain versions) exactly, then its three programs'
     rows (mfu_pct in (0, 100]); (b) trace_step, one-frame and --chunked
     (8 streams x 4 frames, K1 once a step); (c) trace_train --bf16
     (deform_wgrad, K4, K3 in its table); (d) profile_step; (e) bench_dcn
     at fp32 and bf16; (f) dcn_clip_rate at the flax-like init (every
     share 0) and --mirror; (g) parity_run --dryrun at 96x128.

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

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from stmask_torch.utils.profiling import device_ms as _device_ms
from stmask_torch.utils.profiling import device_rows as _device_rows
from stmask_torch.utils.profiling import host_split as _host_split
from stmask_torch.utils.profiling import nvidia_smi as _nvidia_smi
from stmask_torch.utils.profiling import profile as _profile

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
                'deform_wgrad', 'greedy_nms',
                'deform_exact_bwd')                    # the libraries
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
# the training CLI's phase: videos, JPEG frames each, frame height, width;
# steps, then steps after --resume; the dispatches whose intervals give the
# CLI's ms/step (epoch 0 after 2 warm-up steps) and the profiled window
# (epoch 1, after the validation)
TRAIN_CLI_SET = (4, 8, 720, 1280)
TRAIN_CLI_STEPS, TRAIN_CLI_RESUMED = 12, 4
TRAIN_CLI_TIMED = (2, 8)
TRAIN_CLI_PROFILED = (9, 11)
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
# FCB's deformable conv sites at 384x640: FPN levels P3..P7 under each
# bank's taps, Cin = Cout = 256, stride 1, v1 (15 a frame in _ada / _ali)
FCB_SITES = [(h, w, kh, kw) for h, w in ((48, 80), (24, 40), (12, 20),
                                         (6, 10), (3, 5))
             for kh, kw in ((3, 3), (3, 5), (5, 3))]
FCB_PER_FRAME = len(FCB_SITES)
# launches of each kernel in one training step of _ada / _ali
FCB_TRAIN_LAUNCHES = {'deform_conv': 7 + FCB_PER_FRAME,
                      'deform_wgrad': 7 + FCB_PER_FRAME,
                      'deform_col2im': 7 + FCB_PER_FRAME,
                      'deform_im2col': 0, 'correlation': 1,
                      'correlation_bwd': 1}
# B5 (greedy NMS): G groups x K candidates; the eval path's G 40 classes
# (num_classes - 1) at nms_top_k 200, 8 lanes' worth (320), K across the
# 64-bit words' boundaries and the kernel's limit
GREEDY_SHAPES = [(g, k) for g in (40, 320) for k in (1, 63, 64, 65, 200,
                                                     1024)]
GREEDY_PATH_SHAPE = (40, 200)
# the NMS families of phase 10b beside phase 4's cc
NMS_METHODS = (('per_class', False), ('greedy', False), ('cc', True))
DCN_SITES = [  # name, (H, W, Cin) of the DCN input at 384x640, stride
    ('layer1_0', (96, 160, 128), 2), ('layer1_2', (48, 80, 128), 1),
    ('layer2_0', (48, 80, 256), 2), ('layer2_2', (24, 40, 256), 1),
    ('layer2_4', (24, 40, 256), 1), ('layer3_0', (24, 40, 512), 2),
    ('layer3_2', (12, 20, 512), 1)]


# the rest of the model surface: the other backbones, the legacy preset's
# training, the flags, and the R101 / FCB paths of ROADMAP C.7
EXTRA_EVAL = ('STMask_resnet50_gn', 'STMask_darknet53')
EXTRA_TRAIN = ('STMask_resnet50_gn', 'YOLACT_legacy_resnet50')
# the flagship under every flag of the JAX package's config surface
FLAG_SURFACE = dict(use_maskiou=True, rescore_mask=True,
                    use_class_existence_loss=True,
                    use_semantic_segmentation_loss=True,
                    use_sigmoid_focal_loss=True,
                    mask_proto_coeff_diversity_loss=True,
                    mask_proto_loss='l1', use_maskiou_loss=True)
FLAG_KEYS = ('BIoU', 'C', 'M', 'MIoU', 'D', 'P', 'I', 'E', 'T', 'B_shift',
             'M_shift', 'S')
VGG_COUNTS = (18180, 15345)     # the head's anchors, all_priors at 384x640
R101_DCN_SITES = 11
ALI_TRAIN_STEPS = 4
# phase 12: the eval CLI's other modes and the training overlays
COCO_SET = (16, 720, 1280)      # images, height, width
VIS_STEPS, VIS_EVERY = 4, 2     # training steps, overlays every 2 steps
# --video_dir on the card against the CPU at 96x128 (reduced depth): the
# same tracks (count, order, categories), scores within MODES_SCORE_ATOL,
# decoded masks equal on at least MODES_MASK_SHARE of their pixels; fixed
# before the first card run (fp32 with TF32 off on the card; the fused
# conv's 3xTF32 products ~3e-7 from fp32)
MODES_SCORE_ATOL = 1e-3
MODES_MASK_SHARE = 0.99


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


def _device_events(fn, iters: int):
    """Run ``fn`` ``iters`` times under torch.profiler; returns the
    key_averages() rows of device kernels as (name, count, device us)."""
    return _device_rows(_profile(fn, iters))


def _print_host_split(tag: str, prof, span: str, top: int = 10) -> None:
    n, mean, split = _host_split(prof, span)
    print(f'[host] {tag}: {n} `{span}` ranges, {mean:.3f} ms a range on the '
          f'host clock (profiler on); self ms a range by host op '
          f'(`{span}` itself: Python outside the ops)')
    ranked = sorted(split.items(), key=lambda r: -r[1][0])
    waits = [r for r in ranked if 'Synchronize' in r[0] or r[0] in (
        'aten::_local_scalar_dense', 'aten::item')]
    for k, (ms, c) in ranked[:top] + [r for r in waits
                                      if r not in ranked[:top]]:
        print(f'[host]   {ms:8.3f} ms {c:7.1f}x  {k[:80]}')
    print(f'[host]   device waits: '
          + (', '.join(f'{k} {ms:.3f} ms {c:.1f}x' for k, (ms, c) in waits)
             or 'none'))


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


def _tally(acc, ms, call, plain, nbytes, flops, tf32_flops=0.0,
           bf16_flops=0.0):
    """Add one site's times and bound to the sums in ``acc``; returns the
    site's (bound ms, what bounds it)."""
    bound, by = _bound_ms(nbytes, flops, tf32_flops, bf16_flops)
    for key, v in (('ms', ms), ('call_ms', call), ('plain_ms', plain),
                   ('bound_ms', bound),
                   ('bytes_s', nbytes / PEAK_BYTES_PER_S),
                   ('ops_s', _ops_s(flops, tf32_flops, bf16_flops))):
        acc[key] = acc.get(key, 0.0) + v
    return bound, by


def _by_of(acc):
    return 'bytes' if acc['bytes_s'] >= acc['ops_s'] else 'operations'


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


def _dcn_cost(torch, x, off, stride, kh=3, kw=3, modulated=True):
    """(bytes, flops) the gather needs for these inputs: x, offset and
    (v2) mask read once, cols written once; 2 flops per channel for every
    in-image bilinear corner, plus (v2) 1 per output element for the
    modulation."""
    _, h, w, cin = x.shape
    b, ho, wo, _ = off.shape
    k = kh * kw
    ky = torch.arange(kh, device=x.device)
    kx = torch.arange(kw, device=x.device)
    oy = torch.arange(ho, device=x.device) * stride - (kh - 1) // 2
    ox = torch.arange(wo, device=x.device) * stride - (kw - 1) // 2
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
        ho, wo, kh, kw).reshape(ho, wo, k)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
        ho, wo, kh, kw).reshape(ho, wo, k)
    o = off.reshape(b, ho, wo, k, 2)
    y0 = torch.floor(base_y + o[..., 0])
    x0 = torch.floor(base_x + o[..., 1])
    corners = sum(int((((y0 + dy) >= 0) & ((y0 + dy) < h) & ((x0 + dx) >= 0)
                       & ((x0 + dx) < w)).sum())
                  for dy in (0, 1) for dx in (0, 1))
    n_out = b * ho * wo * k * cin
    n_mask = b * ho * wo * k if modulated else 0
    nbytes = 4 * (x.numel() + off.numel() + n_mask + n_out)
    return nbytes, 2 * cin * corners + (n_out if modulated else 0)


def _model_vs_cpu(torch, dev, cfg, tag: str = '') -> None:
    """The card's fp32 model outputs against the CPU path (the plain
    versions, which tests/ hold against the JAX package) at 96x128, seed
    0, each within its tolerance relative to max|ref|."""
    from stmask_torch.inference.pipeline import normalize_pad
    from stmask_torch.models import build_model
    small = cfg.replace(img_h=96, img_w=128)
    x = torch.from_numpy(_synthetic_clip(96, 128, 1, seed=9)[0])
    x = normalize_pad(small, x)[None]
    with torch.inference_mode():
        ref = build_model(small, torch.device('cpu'), seed=0)(x)
        got = build_model(small, dev, seed=0)(x.to(dev))
    tol = dict(loc=2e-3, conf=1e-4, centerness=1e-4, mask_coeff=2e-3,
               track=1e-3, proto=2e-3, T2S_feat=2e-3, fpn_feat=2e-3)
    if not cfg.temporal_fusion_module:
        del tol['fpn_feat']                    # no TF: no tracker features
    assert set(ref) == set(got) == set(tol), (set(ref), set(tol))
    for key, atol in tol.items():
        d = float((got[key].cpu() - ref[key]).abs().max())
        scale = float(ref[key].abs().max())
        print(f'[check] {tag}card vs CPU {key}: max|diff| {d:.3e} '
              f'(max|ref| {scale:.3e}, atol {atol} relative to max|ref|)')
        assert d <= atol * max(1.0, scale), key


def _bf16_model_vs_cpu(torch, dev, cfg, tag: str = '') -> None:
    """The bf16 model on the card against the CPU path at 96x128: each
    output within twice the CPU's own bf16-vs-fp32 gap."""
    from stmask_torch.inference.pipeline import cast_model, normalize_pad
    from stmask_torch.models import build_model
    small = cfg.replace(img_h=96, img_w=128)
    x = normalize_pad(small, torch.from_numpy(
        _synthetic_clip(96, 128, 1, seed=9)))
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
        print(f'[check] {tag}bf16 card vs CPU {key}: max|diff| {d:.3e} '
              f'(limit twice the CPU bf16-vs-fp32 gap {gap:.3e})')
        assert d <= 2 * gap, (key, d, gap)


def _train_step_vs_cpu(torch, dev, cfg, tag: str = '', p3: bool = False,
                       keys=None, prepare=None, hold: bool = True) -> dict:
    """One training step at 96x128, full depth, on the card against the
    CPU path.  Losses rtol 2e-3; gradients: relative L2 error 2e-3 over all
    parameters and 2e-2 per parameter (cuDNN and CPU convolutions sum in
    another order, the fused conv is 3xTF32 and K4 adds with atomics, so a
    ReLU whose input lies within rounding of 0 can switch on one side).
    ``keys``: the loss keys the step must give, each finite.  ``prepare``:
    called on each device's model before its step.  ``hold`` False prints
    the comparison without holding it (a diagnostic run).  Returns each
    parameter's relative error."""
    from stmask_torch.data.transforms import prepare_batch
    from stmask_torch.models import build_model
    from stmask_torch.train.train_step import build_train_step
    small = cfg.replace(img_h=96, img_w=128)
    host = _train_batch(small, 99, clips=1, p3=p3)
    res = {}
    for d_ in (torch.device('cpu'), dev):
        mdl = build_model(small, d_, seed=0)
        if prepare is not None:
            prepare(mdl)
        st_, in_ = build_train_step(small, mdl, d_)
        _, m = st_(in_(), prepare_batch(small, host, d_))
        # a parameter outside every loss (the centerness banks under the
        # sigmoid focal loss) has no gradient: zero, as JAX gives it
        res[d_.type] = ({k: float(v) for k, v in m.items()},
                        {n: (torch.zeros_like(p) if p.grad is None
                             else p.grad).detach().cpu().double()
                         for n, p in mdl.named_parameters()})
        del mdl, st_, in_
    (cm, cg), (gm, gg) = res['cpu'], res['cuda']
    assert set(cm) == set(gm), (set(cm), set(gm))
    if keys is not None:
        assert set(cm) == set(keys) | {'total', 'gnorm', 'lr'}, set(cm)
        assert all(np.isfinite(v) for v in gm.values()), gm
    for k in cm:
        print(f'[check] {tag}train card vs CPU {k}: {gm[k]:.6f} vs '
              f'{cm[k]:.6f}')
        assert not hold or abs(gm[k] - cm[k]) <= 2e-3 * abs(cm[k]) + 1e-7, k
    rel = {n: float((gg[n] - cg[n]).norm() / cg[n].norm().clamp(min=1e-30))
           for n in cg}
    tot = float(sum((gg[n] - cg[n]).norm() ** 2 for n in cg) ** 0.5
                / sum(cg[n].norm() ** 2 for n in cg) ** 0.5)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    print(f'[check] {tag}train card vs CPU gradients: relative L2 error '
          f'over {len(cg)} parameters {tot:.3e} (limit 2e-3); worst '
          f'{[(n, round(v, 6)) for n, v in worst]} (limit 2e-2 each)'
          + ('' if hold else '; a diagnostic run, not held'), flush=True)
    # where each of the worst differs: the share of its squared difference
    # in its largest output row (one unit that tips moves one row)
    for n, _ in worst:
        d2 = (gg[n] - cg[n]).reshape(len(cg[n]), -1).pow(2).sum(dim=1)
        print(f'[check] {tag}  {n}: largest row {int(d2.argmax())} holds '
              f'{float(d2.max() / d2.sum().clamp(min=1e-300)):.3f} of the '
              'squared difference', flush=True)
    assert not hold or (tot <= 2e-3 and worst[0][1] <= 2e-2), (tot, worst)
    return rel


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

def _train_batch(cfg, seed: int, clips: int = TRAIN_CLIPS,
                 p3: bool = False) -> dict:
    """A training batch as ClipLoader(image_u8=True) yields it: uint8
    frames [clips, 2, img_h, img_w, 3] from _synthetic_clip; 2-4 boxes a
    frame, one id persisting, one vanishing after the ref frame, one new in
    the next frame and 0-2 more persisting; box masks at prototype
    resolution packed with np.packbits; the crowd arrays present, empty.
    ``p3`` adds the semantic-seg loss's gt, ``masks_p3``: every other
    prototype pixel (no loader makes it, in the JAX package alike)."""
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
    if p3:
        batch['masks_p3'] = np.ascontiguousarray(
            batch['masks_proto'][..., ::2, ::2])
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


def _col2im_cost(torch, x, off, stride, radius: int = 2, kh: int = 3,
                 kw: int = 3, modulated: bool = True):
    """(bytes, flops) of K4 for these inputs: dcols, x, offset and (v2)
    mask read once, dx, d_offset and (v2) d_mask written once; per channel,
    2 flops for each in-image corner pair with a weight or a weight
    derivative (the dot product S) and 2 more where the corner gets a dx
    update."""
    from stmask_torch.kernels.deform_col2im import _hat
    b, h, w, cin = x.shape
    _, ho, wo, _ = off.shape
    dev = x.device
    k = kh * kw
    ky = torch.arange(kh, device=dev)
    kx = torch.arange(kw, device=dev)
    oy = torch.arange(ho, device=dev) * stride - (kh - 1) // 2
    ox = torch.arange(wo, device=dev) * stride - (kw - 1) // 2
    by = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
        ho, wo, kh, kw).reshape(1, ho, wo, k)
    bx = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
        ho, wo, kh, kw).reshape(1, ho, wo, k)
    o = off.reshape(b, ho, wo, k, 2)
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
    m = b * ho * wo * k
    nbytes = 4 * (m * cin + 2 * x.numel() + 2 * off.numel()
                  + (2 * m if modulated else 0))
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
    from stmask_torch.inference.pipeline import build_video_step_batched
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
    assert launches['correlation_bf16'] == _lane_count(
        'eval CLI', 'correlation_bf16', steps, EVAL_LANES), launches
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

    # the card against the CPU path at 96x128: the bf16 model's outputs;
    # then one bf16 batched chunk (2 lanes x 2 frames, a new video in lane
    # 1 at step 1)
    _bf16_model_vs_cpu(torch, dev, cfg)
    small = cfg.replace(img_h=96, img_w=128)
    clip = _synthetic_clip(96, 128, 4, seed=9)
    cpu = torch.device('cpu')
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
                prof=prof, ann=ann, prefix=prefix)


def _train_cli(torch, dev, smi: str, name: str, tmp: str,
               step_alone_ms: float) -> dict:
    """Phase 8: the training CLI (``python -m stmask_torch.train``) on a
    synthetic YouTube-VIS set of JPEG frames at 1280x720: 12 steps of 4
    clips with validation after each epoch (8 steps) on 2 videos, then
    ``--resume latest`` for 4 more.  The CLI's step dispatches are timed
    (and a window of them profiled) through a wrapper of the loop's
    ``build_train_step``; its validation is checked through a wrapper of
    ``validate``: only bf16 kernels, and the training model unchanged."""
    from torch.profiler import ProfilerActivity, profile

    from stmask_torch.config import get_config
    from stmask_torch.data.synthetic import write_ytvis_set
    from stmask_torch.kernels import KERNELS
    from stmask_torch.train import __main__ as cli
    from stmask_torch.train import loop

    n_vid, n_fr, h, w = TRAIN_CLI_SET
    cfg = get_config('STMask_plus_resnet50')
    t0 = time.perf_counter()
    ann, prefix = write_ytvis_set(f'{tmp}/train', n_vid, n_fr, h, w,
                                  seed=11, ext='.jpg')
    # the eval path writes masks at the model's input size, so the
    # validation's gt is drawn there (the same frames)
    vann, vprefix = write_ytvis_set(f'{tmp}/valid', n_vid, n_fr, h, w,
                                    seed=11, ext='.jpg',
                                    gt_hw=(cfg.img_h, cfg.img_w))
    print(f'[train_cli] wrote {n_vid} videos x {n_fr} JPEG frames at '
          f'{w}x{h} (twice: gt at the frame size and at the model\'s) in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    dispatch, prof_box, checks = [], {}, []
    build_train_step, validate = loop.build_train_step, cli.validate

    def timed_build(cfg_, model, device):
        step, init = build_train_step(cfg_, model, device)

        def timed_step(state, batch):
            i = len(dispatch)
            if i in TRAIN_CLI_PROFILED:
                torch.cuda.synchronize()
                if i == TRAIN_CLI_PROFILED[0]:
                    prof = profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
                    prof.__enter__()
                    prof_box.update(prof=prof, t0=time.perf_counter())
                else:
                    prof_box['wall'] = time.perf_counter() - prof_box['t0']
                    prof_box['prof'].__exit__(None, None, None)
            dispatch.append(time.perf_counter())
            return step(state, batch)
        return timed_step, init

    def checked_validate(args, cfg_, model, epoch, iteration):
        torch.cuda.synchronize()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        counts = {n: k.launches for n, k in KERNELS.items()}
        stats = validate(args, cfg_, model, epoch, iteration)
        torch.cuda.synchronize()
        launched = {n: k.launches - counts[n] for n, k in KERNELS.items()}
        assert launched['deform_conv_bf16'] > 0 and \
            launched['correlation_bf16'] > 0, launched
        assert all(v == 0 for n, v in launched.items()
                   if not n.endswith('bf16')), launched
        after = model.state_dict()
        for k, v in before.items():
            assert after[k].dtype == v.dtype and torch.equal(after[k], v), k
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert model.training
        checks.append(dict(epoch=epoch, iteration=iteration,
                           launches=launched, mAP=stats['mAP'],
                           seconds=stats['seconds']))
        return stats

    def argv(max_iter: int, *extra):
        return ['--ann_file', ann, '--img_prefix', prefix, '--batch_size',
                str(TRAIN_CLIPS), '--max_iter', str(max_iter),
                '--validation_epoch', '1', '--valid_ann_file', vann,
                '--valid_img_prefix', vprefix, '--valid_max_videos', '2',
                '--save_folder', f'{tmp}/weights',
                '--log_folder', f'{tmp}/logs', *extra]
    loop.build_train_step, cli.validate = timed_build, checked_validate
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = cli.run(argv(TRAIN_CLI_STEPS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated()
        saved = sorted(os.listdir(f'{tmp}/weights'))
        for k in KERNELS.values():
            k.launches = 0
        resumed = cli.run(argv(TRAIN_CLI_STEPS + TRAIN_CLI_RESUMED,
                               '--resume', 'latest'))
        torch.cuda.synchronize()
        resumed_launches = {n: k.launches for n, k in KERNELS.items()}
    finally:
        loop.build_train_step, cli.validate = build_train_step, validate

    epoch_size = len(out['loader'].index) // TRAIN_CLIPS
    n_epochs = -(-TRAIN_CLI_STEPS // epoch_size)
    st, st2 = out['state'], resumed['state']
    print(f'[train_cli] launches {launches} over {TRAIN_CLI_STEPS} steps and '
          f'the validation; after --resume {resumed_launches} over '
          f'{TRAIN_CLI_RESUMED} steps; checkpoints {saved}, then '
          f'{sorted(os.listdir(f"{tmp}/weights"))}', flush=True)
    assert st.step == TRAIN_CLI_STEPS == int(st.count), (st.step, st.count)
    assert st2.step == TRAIN_CLI_STEPS + TRAIN_CLI_RESUMED == int(st2.count)
    assert saved == [f'{cfg.name}_{n_epochs}_{TRAIN_CLI_STEPS}.pth',
                     'valid_results.json'], saved
    assert f'{cfg.name}_{n_epochs}_{st2.step}.pth' in os.listdir(
        f'{tmp}/weights')
    for n_, per in TRAIN_LAUNCHES.items():
        assert launches[n_] == per * TRAIN_CLI_STEPS, (n_, launches)
        assert resumed_launches[n_] == per * TRAIN_CLI_RESUMED, \
            (n_, resumed_launches)
    bf16 = {n_: v for n_, v in launches.items() if n_.endswith('bf16')}
    assert bf16 == {n_: sum(c['launches'][n_] for c in checks)
                    for n_ in bf16}, (bf16, checks)
    assert len(checks) == TRAIN_CLI_STEPS // epoch_size, checks
    entries = [json.loads(ln) for ln in open(f'{tmp}/logs/{cfg.name}.log')]
    trained = [(e['data']['epoch'], e['data']['iter'], e['data']['total'])
               for e in entries if e['type'] == 'train']
    assert [it for _, it, _ in trained] == list(
        range(1, TRAIN_CLI_STEPS + TRAIN_CLI_RESUMED + 1)), trained
    assert all(np.isfinite(tot) for _, _, tot in trained), trained
    assert [e['type'] for e in entries].count('validation') == len(checks)

    a, b = TRAIN_CLI_TIMED
    gaps = sorted((dispatch[i + 1] - dispatch[i]) * 1e3 for i in range(a, b - 1))
    cli_med = (gaps[(len(gaps) - 1) // 2] + gaps[len(gaps) // 2]) / 2
    timing = out['loader'].timing
    per_batch = {k: timing[k] * 1e3 / timing['batches']
                 for k in ('decode', 'preprocess', 'collate')}
    rows = []
    for e in prof_box['prof'].key_averages():
        us = getattr(e, 'self_device_time_total', None)
        if us is None:
            us = getattr(e, 'self_cuda_time_total', 0)
        if us > 0 and str(e.device_type).endswith('CUDA'):
            rows.append((e.key, e.count, us))
    n_prof = TRAIN_CLI_PROFILED[1] - TRAIN_CLI_PROFILED[0]
    busy = sum(us for _, _, us in rows) / 1e3 / n_prof if rows else None
    prof_ms = prof_box['wall'] * 1e3 / n_prof
    print(f'[train_cli] losses {[round(t, 3) for _, _, t in trained]}; '
          f'validation {checks}', flush=True)
    print(f'[train_cli] STMask_plus_resnet50 {cfg.img_h}x{cfg.img_w} fp32 '
          f'(TF32 off), {TRAIN_CLIPS} clips a step from {n_vid} videos x '
          f'{n_fr} JPEG frames at {w}x{h} (ClipLoader, 8 workers, uint8 '
          f'frames and packed masks, put on a side stream): median '
          f'{cli_med:.3f} ms/step over the dispatch intervals of steps '
          f'{a}-{b - 1} ({2 * TRAIN_CLIPS * 1e3 / cli_med:.2f} frames/s), '
          f'all {[round(g, 3) for g in gaps]}; the step alone (phase 6) '
          f'{step_alone_ms:.3f} ms/step: CLI / alone '
          f'{cli_med / step_alone_ms:.4f}; peak memory {peak / 2**20:.1f} '
          f'MiB ({name}, {smi}); {TRAIN_CLI_STEPS} steps + validation in '
          f'{wall:.1f} s', flush=True)
    print(f'[train_cli] data path, worker ms a batch of {TRAIN_CLIPS} clips '
          f'(8 frames decoded, resized, masks rasterised) over '
          f'{int(timing["batches"])} batches: decode '
          f'{per_batch["decode"]:.3f}, preprocess '
          f'{per_batch["preprocess"]:.3f}; collate {per_batch["collate"]:.3f}'
          f' (in the prefetch thread)', flush=True)
    if busy is not None:
        print(f'[train_cli] profiled steps {TRAIN_CLI_PROFILED[0]}-'
              f'{TRAIN_CLI_PROFILED[1] - 1} (torch.profiler on, the window '
              f'opened and closed by a synchronize): {prof_ms:.3f} ms/step '
              f'wall, device busy {busy:.3f} ms/step, idle share '
              f'{1 - busy / prof_ms:.3f} (against the unprofiled median '
              f'{cli_med:.3f} ms/step: {1 - busy / cli_med:.3f})',
              flush=True)
        for key, cnt, us in sorted(rows, key=lambda r: -r[2])[:8]:
            print(f'[train_cli]   {us / n_prof / 1e3:8.4f} ms/step '
                  f'{cnt / n_prof:6.1f}x  {key[:100]}')
    else:
        print('[train_cli] torch.profiler recorded no device time: idle '
              'share not measured', flush=True)
    return dict(launches=launches, resumed=resumed_launches, checks=checks,
                ms_per_step=cli_med, peak=peak, busy=busy, idle=(
                    None if busy is None else 1 - busy / prof_ms),
                data_ms=per_batch, ann=ann, prefix=prefix)


def _fcb_inputs(torch, dev, h, w, kh, kw, frames, seed):
    """One FCB site's x [frames, h, w, 256], offsets and weight [256, kh,
    kw, 256], as a DCN site's without the mask and bias."""
    x, off, _ = _dcn_inputs(torch, dev, h, w, 256, 1, seed, kh, kw, frames)
    return x, off, _dcn_weight(torch, dev, kh, kw, 256, 256, seed + 10000)[0]


def _fcb_checks(torch, dev, err: dict) -> None:
    """Phase 9a: the kernels of FCB's training and eval at its 15 sites
    against their plain versions: the fused conv in fp32 (1 frame, an eval
    step) at FUSED_ATOL; in bf16 with bf16 offsets (ada) and with fp32
    offsets (ali, the third entry) at 8 frames (an eval CLI step) at
    BF16_REL_ATOL.  That tolerance is wider than what rounding the offsets
    to bf16 moves, so the values that differ from the plain version at the
    fp32 offsets are also counted: at most 1% for the fp32-offset entry,
    more than 10% for the bf16 entry at the rounded offsets.  deform_wgrad (WGRAD_RTOL) and K4 (1e-5 of max|ref|) at 8
    frames (a training step of 4 clips) on offsets clamped to the window,
    d_w and d_offset bit for bit over two launches.  The fused fp32 conv
    is also held at 8 frames (the training forward)."""
    from stmask_torch.kernels import deform_col2im as K4
    from stmask_torch.kernels import deform_conv as KD
    from stmask_torch.kernels import deform_wgrad as KW
    for i, (h, w, kh, kw) in enumerate(FCB_SITES):
        site = f'{h}x{w} {kh}x{kw}'
        x, off, wt = _fcb_inputs(torch, dev, h, w, kh, kw, 1, 800 + i)
        got = KD.deform_conv_cuda(x, off, wt, None, None)
        want = KD.deform_conv_reference(x, off, wt, None, None)
        torch.cuda.synchronize()
        d = float((got - want).abs().max())
        err['deform_conv'] = max(err['deform_conv'], d)
        assert d <= FUSED_ATOL, (site, d)
        x, off, wt = _fcb_inputs(torch, dev, h, w, kh, kw, 2 * TRAIN_CLIPS,
                                 850 + i)
        got = KD.deform_conv_cuda(x, off, wt, None, None)
        want = KD.deform_conv_reference(x, off, wt, None, None)
        torch.cuda.synchronize()
        d8 = float((got - want).abs().max())
        err['deform_conv'] = max(err['deform_conv'], d8)
        assert d8 <= FUSED_ATOL, (site, d8)
        xb, wb = x.bfloat16(), wt.bfloat16()
        line = (f'[fcb] {site} x 256 -> 256 v1: fused fp32 max|diff| {d:.3e} '
                f'(1 frame), {d8:.3e} (8 frames)')
        outs = {}
        for key, o in (('deform_conv_bf16', off.bfloat16()),
                       ('deform_conv_bf16_f32off', off)):
            route = _conv_route(KD, (xb, o, wb, None, None))
            assert route == 'fast', (site, key, route)
            got = KD.deform_conv_cuda(xb, o, wb, None, None)
            again = KD.deform_conv_cuda(xb, o, wb, None, None)
            want = KD.deform_conv_reference(xb, o, wb, None, None)
            torch.cuda.synchronize()
            d = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            err[key] = max(err[key], d)
            assert got.dtype == torch.bfloat16
            assert torch.equal(got, again), (site, key)
            assert d <= BF16_REL_ATOL * scale, (site, key, d, scale)
            line += (f'; {key} (8 frames, {route} route) {d:.3e} of '
                     f'max|ref| {scale:.3e}, bit-identical twice')
            outs[key] = got
        share, control = (float((outs[k] != want).float().mean()) for k in (
            'deform_conv_bf16_f32off', 'deform_conv_bf16'))
        assert not torch.equal(outs['deform_conv_bf16'],
                               outs['deform_conv_bf16_f32off']), site
        assert share <= 0.01 and control > 0.1, (site, share, control)
        line += (f'; values off the plain version at fp32 offsets: '
                 f'{share:.5f} (fp32-offset entry), {control:.5f} (bf16 '
                 f'entry at the rounded offsets)')
        del outs
        off = off.clamp(-2, 2)
        gen = torch.Generator(device=dev).manual_seed(870 + i)
        gg = torch.randn(x.shape[0] * h * w, 256, device=dev, generator=gen)
        got = KW.deform_wgrad_cuda(gg, x, off, None, kh, kw)
        again = KW.deform_wgrad_cuda(gg, x, off, None, kh, kw)
        want = KW.deform_wgrad_reference(gg, x, off, None, kh, kw)
        torch.cuda.synchronize()
        dw = float((got - want).abs().max()) / float(want.abs().max())
        err['deform_wgrad'] = max(err['deform_wgrad'], dw)
        assert dw <= WGRAD_RTOL, (site, dw)
        assert torch.equal(got, again), f'{site}: d_w varies'
        del got, again, want
        dcols = torch.randn(x.shape[0] * h * w, kh * kw * 256, device=dev,
                            generator=gen)
        got = K4.deform_col2im_cuda(dcols, x, off, None, kh, kw)
        again = K4.deform_col2im_cuda(dcols, x, off, None, kh, kw)
        want = K4.deform_col2im_reference(dcols, x, off, None, kh, kw)
        torch.cuda.synchronize()
        assert got[2] is None and want[2] is None
        worst = 0.0
        for nm, a, b in zip(('dx', 'd_offset'), got[:2], want[:2]):
            scale = max(float(b.abs().max()), 1.0)
            dd = float((a - b).abs().max()) / scale
            worst = max(worst, dd)
            assert dd <= 1e-5, (site, nm, dd)
        assert torch.equal(got[1], again[1]), f'{site}: d_offset varies'
        err['deform_col2im'] = max(err['deform_col2im'], worst)
        print(f'{line}; deform_wgrad (8 frames) {dw:.3e} of max|ref|, '
              f'bit-identical over two launches; K4 (8 frames, radius 2) '
              f'{worst:.3e} of max|ref|, d_offset bit-identical', flush=True)
        del x, off, wt, xb, wb, gg, dcols, got, again, want


def _fcb_eval_step(torch, dev, smi: str, name: str) -> dict:
    """Phase 9b: the eval video step of STMask_plus_resnet50_ada (fp32,
    one stream) over phase 4's two synthetic videos: launch counts (the
    fused conv at the 7 DCN and 15 FCB sites a frame), the results JSON,
    the card against the CPU path at 96x128, a profile of steady frames."""
    from stmask_torch.config import get_config
    from stmask_torch.models import build_model
    from stmask_torch.models.heads import FeatureAlign

    cfg = get_config('STMask_plus_resnet50_ada')
    model = build_model(cfg, dev, seed=0)
    assert sum(isinstance(m, FeatureAlign) for m in model.modules()) == 3
    clips = [_synthetic_clip(cfg.img_h, cfg.img_w, FRAMES_PER_VIDEO, seed=v)
             for v in range(N_VIDEOS)]
    r = _run_eval_step(torch, dev, cfg, model, clips)
    n_frames = N_VIDEOS * FRAMES_PER_VIDEO
    print(f'[fcb eval] launches {r["launches"]} over {n_frames} frames',
          flush=True)
    want = dict.fromkeys(r['launches'], 0)
    want.update(deform_conv=(_dcn_sites(cfg) + FCB_PER_FRAME) * n_frames,
                correlation=n_frames)
    assert r['launches'] == want, (r['launches'], want)
    print(f'[fcb eval] STMask_plus_resnet50_ada {cfg.img_h}x{cfg.img_w} fp32 '
          f'(TF32 off): {_step_summary(r)} ({name}, {smi})', flush=True)
    _print_profile(r['rows'])
    _model_vs_cpu(torch, dev, cfg, '_ada ')
    return dict(launches=r['launches'], ms=r['ms'], peak=r['peak'],
                busy=r['busy'])


def _fcb_eval_cli(torch, dev, smi: str, name: str, ann: str, prefix: str,
                  tmp: str) -> dict:
    """Phase 9c: the eval CLI's default path (bf16, 8 lanes x 4-frame
    chunks) with --config STMask_plus_resnet50_ali over phase 7's set:
    the bf16 fused conv at the 7 DCN sites and its fp32-offset entry at
    the 15 FCB sites a step, frames/s end to end and device-only; the bf16
    model on the card against the CPU path at 96x128."""
    import math

    from stmask_torch import eval as cli
    from stmask_torch.config import get_config
    from stmask_torch.kernels import KERNELS

    cfg = get_config('STMask_plus_resnet50_ali')
    base = ['--ann_file', ann, '--img_prefix', prefix, '--eval_metrics',
            '--config', cfg.name]
    out_json = f'{tmp}/results_ali.json'
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k.launches = 0
    stats = cli.evaluate(base + ['--mask_det_file', out_json])
    launches = {n: k.launches for n, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    steps = (stats['n_chunks'] + 1) * EVAL_CHUNK
    print(f'[fcb cli] launches {launches} over {stats["n_chunks"]} chunks '
          f'and the warm-up chunk ({steps} steps of {EVAL_LANES} lanes)',
          flush=True)
    want = dict.fromkeys(KERNELS, 0)
    want.update(deform_conv_bf16=_dcn_sites(cfg) * steps,
                deform_conv_bf16_f32off=FCB_PER_FRAME * steps,
                correlation_bf16=_lane_count('_ali eval CLI',
                                             'correlation_bf16', steps,
                                             EVAL_LANES))
    assert launches == want, (launches, want)
    for key in ('mAP', 'AP50', 'AP75', 'AR'):
        assert math.isfinite(stats[key]), stats
    with open(out_json) as fh:
        assert json.load(fh), 'no track in the results JSON'
    timed = cli.evaluate(base + ['--mask_det_file',
                                 f'{tmp}/results_ali_timed.json',
                                 '--time_device'])
    print(f'[fcb cli] STMask_plus_resnet50_ali bf16, {EVAL_LANES} streams x '
          f'{EVAL_CHUNK}-frame chunks: {stats["e2e_fps"]:.2f} frames/s end '
          f'to end, {timed["device_fps"]:.2f} frames/s device-only '
          f'({timed["device_ms_per_chunk"]:.3f} ms a chunk), peak memory '
          f'{peak / 2**20:.1f} MiB, mAP {stats["mAP"]:.6f} ({name}, {smi})',
          flush=True)

    n0 = KERNELS['deform_conv_bf16_f32off'].launches
    _bf16_model_vs_cpu(torch, dev, cfg, '_ali ')
    assert KERNELS['deform_conv_bf16_f32off'].launches - n0 == FCB_PER_FRAME
    return dict(stats=stats, timed=timed, launches=launches, peak=peak)


def _fcb_train(torch, dev, smi: str, name: str) -> dict:
    """Phase 9d: the training step of STMask_plus_resnet50_ada (4 clips = 8
    frames at 360x640, phase 6's batches): launch counts a step (the fused
    conv, deform_wgrad and K4 at the 7 DCN and 15 FCB sites), finite
    losses, gradients on every conv_offset and conv_adaption; ms/step,
    peak memory and a profile; the card against the CPU at 96x128; then
    ALI_TRAIN_STEPS _ali steps with the same counts a step."""
    from stmask_torch.config import get_config
    from stmask_torch.data.transforms import prepare_batch
    from stmask_torch.kernels import KERNELS
    from stmask_torch.models import build_model
    from stmask_torch.train.train_step import build_train_step

    def run(cfg_name, n_steps):
        cfg = get_config(cfg_name)
        model = build_model(cfg, dev, seed=0)
        step, init = build_train_step(cfg, model, dev)
        batches = [prepare_batch(cfg, _train_batch(cfg, 10 + i), dev)
                   for i in range(n_steps)]
        state = init()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for k in KERNELS.values():
            k.launches = 0
        ms, metrics = [], []
        for b_ in batches:
            t0 = time.perf_counter()
            state, m = step(state, b_)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
        launches = {n: k.launches for n, k in KERNELS.items()}
        peak = (torch.cuda.max_memory_allocated(), base)
        print(f'[fcb train] {cfg_name}: launches {launches} over {n_steps} '
              f'steps; losses {metrics}', flush=True)
        want = dict.fromkeys(KERNELS, 0)
        want.update({n_: per * n_steps
                     for n_, per in FCB_TRAIN_LAUNCHES.items()})
        assert launches == want, (launches, want)
        for m in metrics:
            assert all(np.isfinite(v) for v in m.values()), m
        grads = {n: float(p.grad.abs().max())
                 for n, p in model.named_parameters()
                 if '.conv_offset.' in n or '.conv_adaption.' in n}
        assert len(grads) == (6 if cfg.use_pred_offset else 3), grads
        assert min(grads.values()) > 0, grads
        return model, step, state, batches, ms, peak, grads, launches

    model, step, state, batches, step_ms, (peak, base), grads, launches = run(
        'STMask_plus_resnet50_ada', TRAIN_STEPS)
    steady = sorted(step_ms[TRAIN_WARMUP:])
    med = (steady[len(steady) // 2 - 1] + steady[len(steady) // 2]) / 2
    rows = _device_events(lambda: step(state, batches[1]), 1)
    busy = sum(us for _, _, us in rows) / 1e3 if rows else None
    print(f'[fcb train] STMask_plus_resnet50_ada 360x640 fp32 (TF32 off), '
          f'{TRAIN_CLIPS} clips = {2 * TRAIN_CLIPS} frames a step: median '
          f'{med:.3f} ms/step over {len(steady)} steps after {TRAIN_WARMUP} '
          f'warm-up, all steps {[round(t, 3) for t in step_ms]}; peak memory '
          f'{peak / 2**20:.1f} MiB, {(peak - base) / 2**20:.1f} MiB above '
          f'the {base / 2**20:.1f} MiB allocated at the first step\'s start '
          f'(the model, its momentum, the batches and what earlier phases '
          f'hold); FCB gradients max|g| {grads}; '
          + (f'device busy {busy:.3f} ms a step (idle share '
             f'{1 - busy / med:.3f}), {sum(c for _, c, _ in rows)} launches'
             if rows else 'device busy not measured')
          + f' ({name}, {smi})', flush=True)
    for key, cnt, us in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f'[profile]   {us / 1e3:8.4f} ms/step {cnt:6d}x  {key[:100]}')
    del model, step, state, batches

    # the card against the CPU path: one _ada step at 96x128, full depth
    rel = _train_step_vs_cpu(torch, dev, get_config(
        'STMask_plus_resnet50_ada'), '_ada ')
    fcb = {n: v for n, v in rel.items()
           if '.conv_offset.' in n or '.conv_adaption.' in n}
    print(f'[check] _ada train card vs CPU, FCB gradients: relative L2 '
          f'error {fcb} (limit 2e-2 each)', flush=True)
    assert len(fcb) == 6
    ali_ms = run('STMask_plus_resnet50_ali', ALI_TRAIN_STEPS)[4]
    print(f'[fcb train] STMask_plus_resnet50_ali: {ALI_TRAIN_STEPS} steps '
          f'with finite losses, all steps {[round(t, 3) for t in ali_ms]} '
          f'ms ({name}, {smi})', flush=True)
    return dict(ms=med, peak=peak, base=base, busy=busy, launches=launches,
                rel=rel)


def _fcb_times(torch, dev, smi: str) -> dict:
    """Phase 9e: the kernels' times at FCB's 15 sites beside their plain
    versions and bounds: the fused conv in fp32 at 1 frame (an eval step),
    in bf16 with bf16 and with fp32 offsets at 8 frames (an eval CLI
    step); deform_wgrad, the dcols SGEMM and K4 at 8 frames (a training
    step).  Bounds as in phases 5 and 6, without the mask."""
    from stmask_torch.kernels import deform_col2im as K4
    from stmask_torch.kernels import deform_conv as KD
    from stmask_torch.kernels import deform_wgrad as KW
    acc = {k: {} for k in ('deform_conv', 'deform_conv_train',
                           'deform_conv_bf16', 'deform_conv_bf16_f32off',
                           'deform_wgrad', 'deform_col2im')}
    sgemm = 0.0
    frames = 2 * TRAIN_CLIPS
    for i, (h, w, kh, kw) in enumerate(FCB_SITES):
        k = kh * kw
        site = f'{h}x{w} {kh}x{kw}'
        x, off, wt = _fcb_inputs(torch, dev, h, w, kh, kw, 1, 900 + i)
        _, flops = _dcn_cost(torch, x, off, 1, kh, kw, modulated=False)
        nbytes = 4 * (x.numel() + off.numel() + wt.numel() + h * w * 256)
        line = []
        for key, n_fr in (('deform_conv', 1), ('deform_conv_train', frames)):
            if n_fr > 1:   # the training forward's 8 frames
                x, off, wt = _fcb_inputs(torch, dev, h, w, kh, kw, n_fr,
                                         920 + i)
                _, flops = _dcn_cost(torch, x, off, 1, kh, kw,
                                     modulated=False)
                nbytes = 4 * (x.numel() + off.numel() + wt.numel()
                              + n_fr * h * w * 256)
            ms = _device_ms(lambda: KD.deform_conv_cuda(x, off, wt, None,
                                                        None), 100 // n_fr)
            call = _time_ms(lambda: KD.deform_conv_cuda(x, off, wt, None,
                                                        None), 100 // n_fr)
            plain = _time_ms(lambda: KD.deform_conv_reference(
                x, off, wt, None, None), 2, warmup=1)
            bound, by = _tally(acc[key], ms, call, plain, nbytes, flops,
                               tf32_flops=3 * 2 * n_fr * h * w * 256 * k
                               * 256)
            line.append(f'fused fp32 ({n_fr} frame{"s" * (n_fr > 1)}) '
                        f'{ms:.5f} ms, call {call:.5f}, plain {plain:.5f}, '
                        f'bound {bound:.5f} ({by})')
        xb, wb = x.bfloat16(), wt.bfloat16()
        mm = 2 * frames * h * w * 256 * k * 256
        fp32_8 = ms     # the fp32 sibling at these 8 frames, same inputs
        for key, o in (('deform_conv_bf16', off.bfloat16()),
                       ('deform_conv_bf16_f32off', off)):
            r = _bf16_conv_time(torch, KD, (xb, o, wb, None, None, 1, 1),
                                flops, 50)
            assert r['route'] == 'fast', (site, key, r['route'])
            _acc_add(acc[key], r, fp32_ms=fp32_8)
            line.append(f'{key} (8 frames) {_bf16_conv_line(r)}; fp32 '
                        f'sibling {fp32_8:.5f} ms')
        off = off.clamp(-2, 2)
        gen = torch.Generator(device=dev).manual_seed(940 + i)
        gg = torch.randn(frames * h * w, 256, device=dev, generator=gen)
        ms = _device_ms(lambda: KW.deform_wgrad_cuda(gg, x, off, None, kh,
                                                     kw), 50)
        call = _time_ms(lambda: KW.deform_wgrad_cuda(gg, x, off, None, kh,
                                                     kw), 50)
        plain = _time_ms(lambda: KW.deform_wgrad_reference(
            gg, x, off, None, kh, kw), 2, warmup=1)
        nb = 4 * (x.numel() + off.numel() + gg.numel() + 256 * k * 256)
        bound, by = _tally(acc['deform_wgrad'], ms, call, plain, nb, flops,
                           tf32_flops=3 * mm)
        line.append(f'deform_wgrad (8 frames) {ms:.5f} ms, call {call:.5f}, '
                    f'plain {plain:.5f}, bound {bound:.5f} ({by})')
        w2 = wt.reshape(256, k * 256)
        s_ms = _device_ms(lambda: gg @ w2, 50)
        sgemm += s_ms
        dcols = gg @ w2
        nb, fl = _col2im_cost(torch, x, off, 1, kh=kh, kw=kw,
                              modulated=False)
        ms = _device_ms(lambda: K4.deform_col2im_cuda(dcols, x, off, None, kh,
                                                      kw), 50)
        call = _time_ms(lambda: K4.deform_col2im_cuda(dcols, x, off, None,
                                                      kh, kw), 50)
        plain = _time_ms(lambda: K4.deform_col2im_reference(
            dcols, x, off, None, kh, kw), 2, warmup=1)
        bound, by = _tally(acc['deform_col2im'], ms, call, plain, nb, fl)
        line.append(f'the dcols SGEMM (8 frames) {s_ms:.5f} ms; K4 (8 '
                    f'frames) {ms:.5f} ms, call {call:.5f}, plain '
                    f'{plain:.5f}, bound {bound:.5f} ({by}); plan '
                    f'{K4.col2im_plan(frames, h, w, 256, kh, kw)}')
        print(f'[fcb time] {site}: ' + '; '.join(line), flush=True)
        del x, off, wt, xb, wb, gg, dcols
    for key, a in acc.items():
        extra = ''
        if 'l2_bytes' in a:
            extra = (f'; asked of L2 {a["l2_bytes"] / 1e6:.1f} MB, '
                     f'{a["l2_bytes"] / (a["ms"] * 1e-3) / 1e12:.3f} TB/s; '
                     f'cuBLAS bf16 GEMM over the gathered columns (not the '
                     f'same function) {a["library_ms"]:.5f} ms; fp32 '
                     f'sibling (same inputs) {a["fp32_ms"]:.5f} ms')
        print(f'[fcb time] 15 sites summed, {key}: {a["ms"]:.5f} ms '
              f'(device), per call {a["call_ms"]:.5f} ms, plain '
              f'{a["plain_ms"]:.5f} ms, bound {a["bound_ms"]:.5f} ms '
              f'({_by_of(a)}){extra} ({smi})', flush=True)
    print(f'[fcb time] 15 sites summed, the dcols SGEMM g @ w2 (cuBLAS, 8 '
          f'frames): {sgemm:.5f} ms (device) ({smi})', flush=True)
    return dict(acc=acc, sgemm=sgemm)


def _greedy_boxes(torch, dev, g: int, k: int, seed: int):
    """Phase 10a's boxes [g, k, 4] at 640 (max(pad_w, pad_h)), as
    greedy_nms_per_class forms them, and valid [g, k]: random boxes, and
    in every third group a chain (box i overlaps i + 1 at IoU 0.6 and
    i + 2 at 0.33, so i suppresses i + 1, which then cannot suppress
    i + 2); 10% invalid slots, group 0 all invalid."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo = torch.rand(g, k, 2, device=dev, generator=gen) * 0.7
    wh = 0.05 + torch.rand(g, k, 2, device=dev, generator=gen) * 0.25
    boxes = torch.cat([lo, lo + wh], dim=-1) * 640.0
    step = torch.arange(k, device=dev, dtype=torch.float32) * 4.0
    boxes[1::3] = torch.stack([step, step * 0 + 10, step + 15,
                               step * 0 + 40], dim=-1)
    valid = torch.rand(g, k, device=dev, generator=gen) < 0.9
    valid[0] = False
    return boxes, valid


def _near_threshold_boxes(g: int, k: int, seed: int):
    """Boxes [g, k, 4] (fp32 pixels, numpy) and valid [g, k] whose +1-pixel
    IoUs lie within a few ulps of 0.5 for many pairs: chains of four boxes
    with one top-left corner and one height whose widths halve (each
    neighbour pair nested at IoU ~0.5), each right edge moved by -4..4
    ulps, the slots of a group shuffled.  A contracted FMA or another order
    of operations flips some of these verdicts."""
    rng = np.random.RandomState(seed)
    boxes = np.empty((g, k, 4), np.float32)
    for gi in range(g):
        rows = []
        while len(rows) < k:
            x1, y1 = rng.uniform(0, 300, 2).astype(np.float32)
            w = np.float32(rng.choice([64, 96, 128, 160, 200, 256]))
            y2 = np.float32(y1 + np.float32(rng.uniform(10, 200)) - 1)
            for step in range(4):
                x2 = np.float32(x1 + w / 2 ** step - 1)
                x2 = np.float32(x2 + rng.randint(-4, 5) * np.spacing(x2))
                rows.append((x1, y1, x2, y2))
        boxes[gi] = np.array(rows[:k], np.float32)[rng.permutation(k)]
    return boxes, rng.rand(g, k) < 0.95


def _degenerate_boxes(g: int, k: int, seed: int):
    """Boxes [g, k, 4] (fp32 pixels, numpy) and valid [g, k] of the
    degenerate kinds, mixed: zero width and height under the +1 convention
    (x2 = x1 - 1), one-pixel boxes (x2 = x1), points, identical boxes,
    boxes fully nested in others, boxes of negative area."""
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0, 400, (g, k, 2)).astype(np.float32)
    wh = rng.uniform(1, 120, (g, k, 2)).astype(np.float32)
    kind = rng.randint(0, 6, (g, k))
    wh[kind == 0] = -1.0                              # zero area
    wh[kind == 1] = 0.0                               # one pixel
    wh[kind == 2, 0] = 0.0                            # one column
    wh[kind == 5] = -rng.uniform(2, 20, ((kind == 5).sum(), 2))
    boxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    for gi in range(g):                               # identical, nested
        src = rng.randint(0, k, k)
        dup = kind[gi] == 3
        boxes[gi, dup] = boxes[gi, src[dup]]
        nest = kind[gi] == 4
        inner = boxes[gi, src[nest]].copy()
        inner[:, 2:] = inner[:, :2] + (inner[:, 2:] - inner[:, :2]) * 0.5
        boxes[gi, nest] = inner
    return boxes, rng.rand(g, k) < 0.9


def _greedy_inputs(torch, dev, g: int, k: int, seed: int):
    """Phase 10a's IoU matrix: _plus_one_iou of _greedy_boxes, and
    valid."""
    from stmask_torch.ops.nms import _plus_one_iou
    boxes, valid = _greedy_boxes(torch, dev, g, k, seed)
    return _plus_one_iou(boxes).contiguous(), valid


def _greedy_split(torch, dev, smi: str) -> dict:
    """Phase 10a's split of the greedy path's time at [40, 200] and [320,
    200] (kernels/split.py): the caller's IoU formation (_plus_one_iou on
    the card, its launches counted under torch.profiler), then B5's entry
    that reads the matrix, whole, without its suppression rows and
    without its scan."""
    from stmask_torch.kernels import greedy_nms as KG
    from stmask_torch.kernels import split as KS
    from stmask_torch.ops.nms import _plus_one_iou
    KS.build_variants(KS.GREEDY)
    out = {}
    for g, k in (GREEDY_PATH_SHAPE, (320, 200)):
        boxes, valid = _greedy_boxes(torch, dev, g, k, seed=1)
        iou = _plus_one_iou(boxes).contiguous()
        # a profiler session after earlier ones misses its first launches:
        # count over 10 calls
        n_iou = round(sum(c for _, c, _ in _device_events(
            lambda: [_plus_one_iou(boxes) for _ in range(10)], 1)) / 10)
        iou_ms = _device_ms(lambda: _plus_one_iou(boxes), 40)
        site = f'[G {g}, K {k}]'
        r = KS.split(KS.GREEDY, KG, [(site, (iou, valid, 0.5))],
                     KG.greedy_nms_cuda, lambda fn: _device_ms(fn, 200),
                     'general')[site]
        print(f'[B5 split] {site}: IoU formation (_plus_one_iou, {n_iou} '
              f'kernels) {iou_ms:.5f} ms (device); B5 (matrix entry) whole '
              f'{r["whole"]:.5f} ms, without the suppression rows '
              f'{r["no suppression rows"]:.5f} (rows '
              f'{r["whole"] - r["no suppression rows"]:+.5f}), without the '
              f'scan {r["no scan"]:.5f} (scan '
              f'{r["whole"] - r["no scan"]:+.5f}); IoU formation + B5 '
              f'{iou_ms + r["whole"]:.5f} ms ({smi})', flush=True)
        out[(g, k)] = dict(iou_ms=iou_ms, iou_kernels=n_iou, matrix=r,
                           before_ms=iou_ms + r['whole'])
    return out


def _corr_split(torch, dev, smi: str, routes) -> dict:
    """K1 bf16's split (kernels/split.py, CORR) at one step of the eval
    CLI, [8, 24, 40, 256] bf16, patch 11, on each route of ``routes``."""
    from stmask_torch.kernels import correlation as K1
    from stmask_torch.kernels import split as KS
    KS.build_variants(KS.CORR)
    g = torch.Generator(device=dev).manual_seed(40)
    shape = (EVAL_LANES, 24, 40, 256)
    x1 = torch.randn(shape, device=dev, generator=g).bfloat16()
    x2 = torch.randn(shape, device=dev, generator=g).bfloat16()
    sites = [(f'[{EVAL_LANES},24,40,256] P 11', (x1, x2, 11))]
    out = {}
    for route in routes:
        out[route] = KS.split(KS.CORR, K1, sites, K1.correlate_cuda,
                              lambda fn: _device_ms(fn, 200), route)
        KS.print_split(KS.CORR, route, out[route], smi, EVAL_LANES)
    return out


def _boxes_args(torch, dev, boxes, valid):
    """The boxes entry's arguments for [G, K, 4] pixel boxes: the flat
    boxes [G * K, 4] in reversed slot order, idx [G, K] reversed into them
    (so that the gather matters), valid, scale 1 and thr 0.5."""
    g, k, _ = boxes.shape
    boxes = torch.as_tensor(boxes).to(dev)
    return (boxes.flip(1).reshape(-1, 4).contiguous(),
            torch.arange(g * k, device=dev).reshape(g, k).flip(1),
            torch.as_tensor(valid).to(dev), 1.0, 0.5)


def _greedy_checks(torch, dev, smi: str, err: dict) -> dict:
    """Phase 10a: B5's two entries against their plain versions, bit for
    bit, at GREEDY_SHAPES (and the same over two launches): the matrix
    entry on _greedy_inputs, the boxes entry on their boxes (normalized,
    scaled by 640 in the kernel), on boxes with many IoUs within a few
    ulps of 0.5 and on degenerate boxes; then the split of the greedy
    path's time before the boxes entry (_greedy_split) and the boxes
    entry's; then each entry's times at the path's shape [40, 200] and at
    [320, 200] beside the plain versions and the bounds."""
    from stmask_torch.kernels import greedy_nms as KG
    from stmask_torch.kernels import split as KS
    for g, k in GREEDY_SHAPES:
        iou, valid = _greedy_inputs(torch, dev, g, k, seed=g + k)
        n0 = KG.KERNEL.launches
        got = KG.greedy_nms_cuda(iou, valid, 0.5)
        again = KG.greedy_nms_cuda(iou, valid, 0.5)
        want = KG.greedy_nms_mask_reference(iou, valid, 0.5)
        torch.cuda.synchronize()
        assert KG.KERNEL.launches == n0 + 2
        n_diff = int((got != want).sum())
        print(f'[B5] greedy_nms [G {g}, K {k}]: {n_diff} keep flags differ '
              f'from the plain version (must be 0), {int(got.sum())} of '
              f'{int(valid.sum())} valid kept; bit-identical over two '
              'launches', flush=True)
        assert n_diff == 0 and torch.equal(got, again), (g, k)
        assert not got[0].any()
        err['greedy_nms'] = max(err['greedy_nms'], float(n_diff))
    cases = []
    for g, k in GREEDY_SHAPES:
        boxes, valid = _greedy_boxes(torch, dev, g, k, seed=g + k)
        cases.append((f'[G {g}, K {k}]', (
            boxes.reshape(-1, 4) / 640.0,
            torch.arange(g * k, device=dev).reshape(g, k), valid, 640.0,
            0.5)))
    for g, k in ((40, 200), (320, 200), (7, 1024)):
        for kind, make in (('near 0.5', _near_threshold_boxes),
                           ('degenerate', _degenerate_boxes)):
            cases.append((f'[G {g}, K {k}] {kind}', _boxes_args(
                torch, dev, *make(g, k, seed=g + k))))
    for label, args in cases:
        n0 = KG.KERNEL_BOXES.launches
        got = KG.greedy_nms_boxes_cuda(*args)
        again = KG.greedy_nms_boxes_cuda(*args)
        want = KG.greedy_nms_plus_one_reference(*args)
        torch.cuda.synchronize()
        assert KG.KERNEL_BOXES.launches == n0 + 2
        n_diff = int((got != want).sum())
        print(f'[B5 boxes] greedy_nms_boxes {label}: {n_diff} keep flags '
              f'differ from the plain version (must be 0), {int(got.sum())} '
              f'of {int(args[2].sum())} valid kept; bit-identical over two '
              'launches', flush=True)
        assert n_diff == 0 and torch.equal(got, again), label
        err['greedy_nms_boxes'] = max(err['greedy_nms_boxes'], float(n_diff))

    before = _greedy_split(torch, dev, smi)
    KS.build_variants(KS.GREEDY_BOXES)
    times = {}
    for g, k in (GREEDY_PATH_SHAPE, (320, 200)):
        iou, valid = _greedy_inputs(torch, dev, g, k, seed=1)
        ms = _device_ms(lambda: KG.greedy_nms_cuda(iou, valid, 0.5), 200)
        call = _time_ms(lambda: KG.greedy_nms_cuda(iou, valid, 0.5), 500)
        plain = _time_ms(lambda: KG.greedy_nms_mask_reference(
            iou, valid, 0.5), 3, warmup=1)
        # the IoU matrix's strict upper triangle (the only entries greedy
        # NMS reads) and valid read once, keep written once; one fp32
        # comparison for every pair above the diagonal
        nbytes = 4 * g * k * (k - 1) // 2 + 2 * valid.numel()
        bound, by = _bound_ms(nbytes, g * k * (k - 1) / 2)
        times[(g, k)] = dict(ms=ms, call_ms=call, plain_ms=plain,
                             bound_ms=bound, bound_by=by)
        print(f'[time] greedy_nms [G {g}, K {k}]: kernel {ms:.5f} ms '
              f'(device), per wrapper call {call:.5f} ms, plain {plain:.5f} '
              f'ms, bound {bound:.5f} ms ({by}; {nbytes} B) ({smi})',
              flush=True)
        # the boxes entry on the same boxes, normalized and scaled by 640
        # in the kernel as greedy_nms_per_class hands them over
        boxes, valid = _greedy_boxes(torch, dev, g, k, seed=1)
        args = (boxes.reshape(-1, 4) / 640.0,
                torch.arange(g * k, device=dev).reshape(g, k), valid, 640.0,
                0.5)
        site = f'[G {g}, K {k}]'
        split = KS.split(KS.GREEDY_BOXES, KG, [(site, args)],
                         KG.greedy_nms_boxes_cuda,
                         lambda fn: _device_ms(fn, 200), 'general')[site]
        b_ms = split['whole']
        b_call = _time_ms(lambda: KG.greedy_nms_boxes_cuda(*args), 500)
        b_plain = _time_ms(lambda: KG.greedy_nms_plus_one_reference(*args),
                           3, warmup=1)
        # the group's boxes (16 B), indices (8 B) and valid flags read once,
        # keep written once; ~15 fp32 operations and one division for each
        # IoU above the diagonal, at the fp32 peak
        b_bytes = g * k * (16 + 8 + 1 + 1)
        b_bound, b_by = _bound_ms(b_bytes, 16 * g * k * (k - 1) / 2)
        bef = before[(g, k)]
        times[(g, k)].update(
            boxes_ms=b_ms, boxes_call_ms=b_call, boxes_plain_ms=b_plain,
            boxes_bound_ms=b_bound, boxes_bound_by=b_by,
            boxes_split=split, before_ms=bef['before_ms'],
            iou_ms=bef['iou_ms'], iou_kernels=bef['iou_kernels'])
        print(f'[time] greedy_nms_boxes {site}: kernel {b_ms:.5f} ms '
              f'(device), per wrapper call {b_call:.5f} ms, plain '
              f'{b_plain:.5f} ms, bound {b_bound:.5f} ms ({b_by}; {b_bytes} '
              f'B); before (IoU formation {bef["iou_ms"]:.5f} + matrix entry '
              f'{bef["matrix"]["whole"]:.5f}) {bef["before_ms"]:.5f} ms, '
              f'{bef["before_ms"] / b_ms:.1f}x; split: without the IoUs and '
              f'rows {split["no IoUs or suppression rows"]:.5f} '
              f'({b_ms - split["no IoUs or suppression rows"]:+.5f}), '
              f'without the scan {split["no scan"]:.5f} '
              f'({b_ms - split["no scan"]:+.5f}), without the box reads '
              f'{split["no box reads"]:.5f} '
              f'({b_ms - split["no box reads"]:+.5f}) ({smi})', flush=True)
    return times


def _nms_vs_cpu(torch, dev, cfg, method: str, miou: bool) -> None:
    """detect_frame on the card against the CPU path on the same inputs:
    one 96x128 frame's eval outputs of the card's model (seed 0), decoded
    and suppressed on each side: validity and classes equal, boxes and
    scores within 1e-6 (each side decodes)."""
    from stmask_torch.inference.candidates import detect_frame
    from stmask_torch.inference.pipeline import normalize_pad
    from stmask_torch.models import build_model
    from stmask_torch.ops.anchors import all_priors
    small = cfg.replace(img_h=96, img_w=128, eval_nms_method=method,
                        nms_as_miou=miou)
    x = normalize_pad(small, torch.from_numpy(
        _synthetic_clip(96, 128, 1, seed=9)[0]))[None].to(dev)
    with torch.inference_mode():
        preds = build_model(small, dev, seed=0)(x)
    keys = ('loc', 'conf', 'mask_coeff', 'track', 'centerness')
    priors = torch.as_tensor(all_priors(small))
    got = detect_frame(small, {k: preds[k][0] for k in keys}, priors.to(dev),
                       proto=preds['proto'][0])
    want = detect_frame(small, {k: preds[k][0].cpu() for k in keys}, priors,
                        proto=preds['proto'][0].cpu())
    got = type(got)(*(t.cpu() for t in got))
    same = bool(torch.equal(got.valid, want.valid)
                and torch.equal(got.cls[want.valid], want.cls[want.valid]))
    diffs = torch.cat([(got.box - want.box)[want.valid].flatten(),
                       (got.score - want.score)[want.valid]]).abs()
    d = float(diffs.max()) if diffs.numel() else 0.0
    print(f'[check] {small.name} detect_frame {method}'
          f'{" + nms_as_miou" if miou else ""} card vs CPU at 96x128: '
          f'{int(want.valid.sum())} detections, validity and classes '
          f'{"equal" if same else "DIFFER"}, max|box, score diff| {d:.3e} '
          '(atol 1e-6; at least 5 detections)', flush=True)
    assert int(want.valid.sum()) >= 5, (method, miou)
    assert same and d <= 1e-6, (method, miou, d)


def _run_eval_step(torch, dev, cfg, model, clips) -> dict:
    """The fp32 eval video step (one stream) over ``clips`` with every
    launch count set to 0 just before and read just after: launches, the
    median ms/frame after WARMUP_FRAMES, the results JSON's tracks, the
    peak memory above what was held before; then a torch.profiler window
    over four steady frames of the first clip (device busy ms a frame,
    launches a frame, the rows)."""
    from stmask_torch.inference import (build_video_step, postprocess_frame,
                                        results2json_videoseg)
    from stmask_torch.kernels import KERNELS
    step, init_state = build_video_step(cfg, model, uint8_input=True,
                                        device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for k in KERNELS.values():
        k.launches = 0
    frame_ms, results = [], []
    for v, clip in enumerate(clips):
        state = init_state()
        for f, frame in enumerate(clip):
            t0 = time.perf_counter()
            state, out = step(state, frame, f == 0)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            for t in out:
                if t.is_floating_point():
                    assert bool(torch.isfinite(t).all()), (v, f)
            results.append(postprocess_frame(
                cfg, out, {'video_id': v + 1, 'frame_id': f,
                           'img_shape': (cfg.img_h, cfg.img_w)}))
    launches = {n: k.launches for n, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated() - base
    tracks = results2json_videoseg(results)
    json.dumps(tracks)
    assert tracks, 'no track in the results JSON'
    steady = sorted(frame_ms[WARMUP_FRAMES:])
    med = steady[len(steady) // 2]

    state = init_state()
    for f in range(2):
        state, _ = step(state, clips[0][f], f == 0)

    def frames():
        nonlocal state
        for f in range(2, 6):
            state, _ = step(state, clips[0][f], False)

    rows = _device_events(frames, 1)
    busy = sum(us for _, _, us in rows) / 4 / 1e3 if rows else None
    n_kern = sum(c for _, c, _ in rows) / 4 if rows else None
    return dict(launches=launches, ms=med, frame_ms=frame_ms,
                tracks=len(tracks), peak=peak, base=base, rows=rows,
                busy=busy, launches_per_frame=n_kern)


def _step_summary(r: dict) -> str:
    """One line of ``_run_eval_step``'s numbers."""
    return (f'median {r["ms"]:.3f} ms/frame after {WARMUP_FRAMES} warm-up '
            f'frames, all frames {[round(t, 3) for t in r["frame_ms"]]}; '
            f'{r["tracks"]} tracks; peak memory {r["peak"] / 2**20:.1f} MiB '
            f'above the {r["base"] / 2**20:.1f} MiB held at the start; '
            + (f'device busy {r["busy"]:.3f} ms a steady frame (idle share '
               f'{1 - r["busy"] / r["ms"]:.3f}), '
               f'{r["launches_per_frame"]:.0f} launches a frame'
               if r['rows'] else 'device busy not measured'))


def _print_profile(rows, n: int = 8) -> None:
    for key, cnt, us in sorted(rows, key=lambda x: -x[2])[:n]:
        print(f'[profile]   {us / 4 / 1e3:8.4f} ms/frame {cnt / 4:6.1f}x  '
              f'{key[:100]}')


def _mapstar_eval(torch, dev, smi: str, name: str, cc_ms: float) -> dict:
    """Phase 10b: the flagship's fp32 eval step (phase 4's two videos, one
    stream) under each NMS family of NMS_METHODS, beside phase 4's cc
    median ``cc_ms``: ms/frame and launches (B5's boxes entry once a frame
    under greedy, never otherwise; its matrix entry never) and detect_frame
    alone (cc's too); the greedy step exported (_greedy_export); then each
    family's detect_frame, and cc's, on the card against the CPU path at
    96x128."""
    from stmask_torch.config import get_config
    from stmask_torch.models import build_model
    base = get_config('STMask_plus_resnet50')
    model = build_model(base, dev, seed=0)
    clips = [_synthetic_clip(base.img_h, base.img_w, FRAMES_PER_VIDEO, seed=v)
             for v in range(N_VIDEOS)]
    n_frames = N_VIDEOS * FRAMES_PER_VIDEO
    from stmask_torch.inference.candidates import detect_frame
    from stmask_torch.inference.pipeline import normalize_pad
    from stmask_torch.ops.anchors import all_priors
    priors = torch.as_tensor(all_priors(base), device=dev)
    with torch.inference_mode():
        preds = model(normalize_pad(base, torch.as_tensor(clips[0][6]).to(
            dev))[None])
    one = {k: preds[k][0] for k in ('loc', 'conf', 'mask_coeff', 'track',
                                    'centerness')}

    def detect_ms(cfg) -> float:
        """detect_frame alone: the median of 9 synchronized calls (host
        clock)."""
        times = []
        with torch.inference_mode():
            for _ in range(9):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                detect_frame(cfg, one, priors, proto=preds['proto'][0])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[4]

    res = {'cc': dict(ms=cc_ms, detect_ms=detect_ms(base))}
    print(f'[mAP*] STMask_plus_resnet50 cc: phase 4\'s median {cc_ms:.3f} '
          f'ms/frame; detect_frame alone {res["cc"]["detect_ms"]:.3f} ms '
          f'(median of 9, synchronized) ({name}, {smi})', flush=True)
    for method, miou in NMS_METHODS:
        cfg = base.replace(eval_nms_method=method, nms_as_miou=miou)
        r = _run_eval_step(torch, dev, cfg, model, clips)
        tag = method + (' + nms_as_miou' if miou else '')
        detect = detect_ms(cfg)
        want = dict.fromkeys(r['launches'], 0)
        want.update(deform_conv=_dcn_sites(cfg) * n_frames,
                    correlation=n_frames,
                    greedy_nms_boxes=n_frames if method == 'greedy' else 0)
        print(f'[mAP*] STMask_plus_resnet50 {tag}: launches {r["launches"]} '
              f'over {n_frames} frames', flush=True)
        assert r['launches'] == want, (tag, r['launches'], want)
        print(f'[mAP*] STMask_plus_resnet50 {cfg.img_h}x{cfg.img_w} fp32, '
              f'{tag}: {_step_summary(r)}; detect_frame alone '
              f'{detect:.3f} ms (median of 9, synchronized) ({name}, '
              f'{smi})', flush=True)
        res[tag] = dict(ms=r['ms'], launches=r['launches'],
                        detect_ms=detect, busy=r['busy'],
                        launches_per_frame=r['launches_per_frame'])
        if method == 'greedy':
            res['export'] = _greedy_export(torch, dev, smi, name, cfg, model,
                                           clips)
    del model
    for method, miou in (('cc', False),) + NMS_METHODS:
        _nms_vs_cpu(torch, dev, base, method, miou)
    return res


def _greedy_export(torch, dev, smi: str, name: str, cfg, model,
                   clips) -> dict:
    """Phase 10b: the fp32 video step under greedy NMS exported with
    torch.export (export.export_video_step), its program holding B5's
    boxes op (stmask::greedy_nms_plus_one_keep) and not the matrix op, run
    in this process over ``clips`` against the live greedy step (keep and
    obj_id equal, box / score / mask within EXPORT_ATOL): the boxes entry
    once a frame, the matrix entry never."""
    from stmask_torch.export import ExportedStep, export_video_step
    from stmask_torch.inference import build_video_step
    from stmask_torch.kernels import KERNELS
    t0 = time.perf_counter()
    program, meta = export_video_step(cfg, model, device=dev)
    export_s = time.perf_counter() - t0
    targets = [str(n_.target) for n_ in program.graph.nodes
               if n_.op == 'call_function']
    n_op = targets.count('stmask.greedy_nms_plus_one_keep.default')
    assert n_op == 1 and 'stmask.greedy_nms_keep.default' not in targets, \
        targets
    step = ExportedStep(program, meta, dev)
    live, init = build_video_step(cfg, model, uint8_input=True, device=dev)
    worst = 0.0
    launches = dict.fromkeys(KERNELS, 0)      # the artifact's launches only
    for clip in clips:
        sa, sl = step.init_state(), init()
        for f, frame in enumerate(clip):
            n0 = {n: k_.launches for n, k_ in KERNELS.items()}
            sa, got = step(sa, frame, f == 0)
            for n, k_ in KERNELS.items():
                launches[n] += k_.launches - n0[n]
            sl, want = live(sl, frame, f == 0)
            for fld in ('keep', 'obj_id'):
                assert torch.equal(getattr(got, fld), getattr(want, fld)), fld
            for fld in ('box', 'score', 'mask'):
                worst = max(worst, float((getattr(got, fld).float()
                                          - getattr(want, fld).float())
                                         .abs().max()))
    n_frames = sum(len(c) for c in clips)
    want_l = dict.fromkeys(launches, 0)
    want_l.update(deform_conv=_dcn_sites(cfg) * n_frames,
                  correlation=n_frames, greedy_nms_boxes=n_frames)
    print(f'[mAP* export] {cfg.name} fp32 greedy step exported in '
          f'{export_s:.1f} s: one stmask::greedy_nms_plus_one_keep node, no '
          f'stmask::greedy_nms_keep; over {n_frames} frames against the live '
          f'greedy step: keep and obj_id equal, box / score / mask max|diff| '
          f'{worst:.3e} (atol {EXPORT_ATOL}); launches {launches} ({name}, '
          f'{smi})', flush=True)
    assert launches == want_l, (launches, want_l)
    assert worst <= EXPORT_ATOL, worst
    return dict(export_s=export_s, launches=launches, worst=worst)


def _legacy_eval_step(torch, dev, smi: str, name: str) -> dict:
    """Phase 10c: YOLACT_legacy_resnet50 at full depth and width (R50
    without DCN, the legacy head, 360x640, 41 classes, init_random seed 0),
    the fp32 eval step over phase 4's videos, one stream: launches (no
    deformable conv, no correlation), ms/frame, a profile of steady frames;
    the model on the card against the CPU path at 96x128."""
    from stmask_torch.config import get_config
    from stmask_torch.models import build_model
    from stmask_torch.models.legacy_head import PredictionModule
    cfg = get_config('YOLACT_legacy_resnet50')
    model = build_model(cfg, dev, seed=0)
    assert isinstance(model.prediction_layers[0], PredictionModule)
    assert not hasattr(model, 'TemporalNet')
    clips = [_synthetic_clip(cfg.img_h, cfg.img_w, FRAMES_PER_VIDEO, seed=v)
             for v in range(N_VIDEOS)]
    r = _run_eval_step(torch, dev, cfg, model, clips)
    n_frames = N_VIDEOS * FRAMES_PER_VIDEO
    print(f'[legacy] launches {r["launches"]} over {n_frames} frames',
          flush=True)
    assert r['launches'] == dict.fromkeys(r['launches'], 0), r['launches']
    print(f'[legacy] YOLACT_legacy_resnet50 {cfg.img_h}x{cfg.img_w} fp32 '
          f'(TF32 off), one stream: {_step_summary(r)} ({name}, {smi})',
          flush=True)
    _print_profile(r['rows'])
    del model
    _model_vs_cpu(torch, dev, cfg, 'legacy ')
    return dict(ms=r['ms'], launches=r['launches'], busy=r['busy'],
                launches_per_frame=r['launches_per_frame'], peak=r['peak'])


def _legacy_eval_cli(torch, dev, smi: str, name: str, ann: str, prefix: str,
                     tmp: str) -> dict:
    """Phase 10c: the eval CLI's defaults (bf16, 8 lanes x 4-frame chunks)
    with --config YOLACT_legacy_resnet50 --nms greedy over phase 7's set:
    B5's boxes entry once a step over the 8 lanes (4 a chunk), no other
    kernel;
    frames/s end to end and device-only."""
    import math

    from stmask_torch import eval as cli
    from stmask_torch.kernels import KERNELS
    base = ['--ann_file', ann, '--img_prefix', prefix, '--eval_metrics',
            '--config', 'YOLACT_legacy_resnet50', '--nms', 'greedy']
    out_json = f'{tmp}/results_legacy.json'
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k.launches = 0
    stats = cli.evaluate(base + ['--mask_det_file', out_json])
    launches = {n: k.launches for n, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    chunks = stats['n_chunks'] + 1                 # and the warm-up chunk
    print(f'[legacy cli] launches {launches} over {stats["n_chunks"]} chunks '
          f'and the warm-up chunk', flush=True)
    want = dict.fromkeys(KERNELS, 0)
    want['greedy_nms_boxes'] = _lane_count(
        'legacy eval CLI --nms greedy', 'greedy_nms_boxes',
        EVAL_CHUNK * chunks, EVAL_LANES)
    assert launches == want, (launches, want)
    for key in ('mAP', 'AP50', 'AP75', 'AR'):
        assert math.isfinite(stats[key]), stats
    with open(out_json) as fh:
        n_tracks = len(json.load(fh))
    assert n_tracks, 'no track in the results JSON'
    timed = cli.evaluate(base + ['--mask_det_file',
                                 f'{tmp}/results_legacy_timed.json',
                                 '--time_device'])
    print(f'[legacy cli] YOLACT_legacy_resnet50 --nms greedy bf16, '
          f'{EVAL_LANES} streams x {EVAL_CHUNK}-frame chunks: '
          f'{stats["e2e_fps"]:.2f} frames/s end to end, '
          f'{timed["device_fps"]:.2f} frames/s device-only '
          f'({timed["device_ms_per_chunk"]:.3f} ms a chunk), greedy_nms_boxes '
          f'{EVAL_CHUNK} launches a chunk (once a step for all {EVAL_LANES} '
          f'lanes), peak memory '
          f'{peak / 2**20:.1f} MiB, {n_tracks} tracks, mAP '
          f'{stats["mAP"]:.6f} ({name}, {smi})', flush=True)
    return dict(stats=stats, timed=timed, launches=launches, peak=peak,
                tracks=n_tracks)


def _extra_eval(torch, dev, smi: str, name: str) -> dict:
    """Phase 11a: the fp32 eval step (one stream) of STMask_resnet50_gn and
    STMask_darknet53 at full depth and width over phase 4's videos: K1 once
    a frame, no deformable conv; ms/frame, busy ms and idle share, launches
    a frame, peak memory; the model on the card against the CPU at 96x128.
    Then STMask_vgg16: its forward alone at full width, the card against
    the CPU, and the video step's ValueError (18180 anchors against 15345
    priors: ROADMAP C.8)."""
    from stmask_torch.config import get_config
    from stmask_torch.inference import build_video_step
    from stmask_torch.inference.pipeline import normalize_pad
    from stmask_torch.models import build_model
    res = {}
    n_frames = N_VIDEOS * FRAMES_PER_VIDEO
    for preset in EXTRA_EVAL:
        cfg = get_config(preset)
        model = build_model(cfg, dev, seed=0)
        clips = [_synthetic_clip(cfg.img_h, cfg.img_w, FRAMES_PER_VIDEO,
                                 seed=v) for v in range(N_VIDEOS)]
        r = _run_eval_step(torch, dev, cfg, model, clips)
        print(f'[extra eval] {preset}: launches {r["launches"]} over '
              f'{n_frames} frames', flush=True)
        want = dict.fromkeys(r['launches'], 0)
        want['correlation'] = n_frames
        assert r['launches'] == want, (preset, r['launches'])
        print(f'[extra eval] {preset} {cfg.img_h}x{cfg.img_w} fp32 (TF32 '
              f'off), one stream: {_step_summary(r)} ({name}, {smi})',
              flush=True)
        _print_profile(r['rows'], 5)
        del model
        _model_vs_cpu(torch, dev, cfg, f'{preset} ')
        res[preset] = r

    cfg = get_config('STMask_vgg16')
    model = build_model(cfg, dev, seed=0)
    x = normalize_pad(cfg, torch.as_tensor(_synthetic_clip(
        cfg.img_h, cfg.img_w, 1, seed=0)[0]).to(dev))[None]
    with torch.inference_mode():
        out = model(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            out = model(x)
        torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3 / 5
    for k, v in out.items():
        assert bool(torch.isfinite(v.float()).all()), k
    step, init = build_video_step(cfg, model, device=dev)
    try:
        step(init(), x[0], True)
        raise AssertionError('STMask_vgg16: the video step did not raise')
    except ValueError as e:
        msg = str(e)
    assert (f'{VGG_COUNTS[0]} anchors' in msg
            and f'{VGG_COUNTS[1]} priors' in msg), msg
    print(f'[extra eval] STMask_vgg16 {cfg.img_h}x{cfg.img_w} fp32: the '
          f'forward alone {fwd_ms:.3f} ms (mean of 5, synchronized), '
          f'{out["loc"].shape[1]} anchors; the video step raised: {msg} '
          f'({name}, {smi})', flush=True)
    del model, step
    _model_vs_cpu(torch, dev, cfg, 'STMask_vgg16 ')
    res['STMask_vgg16'] = dict(forward_ms=fwd_ms)
    return res


def _extra_train(torch, dev, smi: str, name: str) -> dict:
    """Phase 11b: the training step of STMask_resnet50_gn (GroupNorm
    trained; K1 and K3 once a step) and YOLACT_legacy_resnet50 (keys B, C,
    M; no kernel of the port) over phase 6's batches (4 clips = 8 frames
    at 360x640): launches a step, finite losses, ms/step, busy ms, peak
    memory; each against the CPU at 96x128."""
    from stmask_torch.config import get_config
    from stmask_torch.data.transforms import prepare_batch
    from stmask_torch.kernels import KERNELS
    from stmask_torch.models import build_model
    from stmask_torch.train.train_step import build_train_step
    res = {}
    for preset in EXTRA_TRAIN:
        cfg = get_config(preset)
        model = build_model(cfg, dev, seed=0)
        step, init = build_train_step(cfg, model, dev)
        batches = [prepare_batch(cfg, _train_batch(cfg, 10 + i), dev)
                   for i in range(TRAIN_STEPS)]
        state = init()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for k in KERNELS.values():
            k.launches = 0
        ms, metrics = [], []
        for b_ in batches:
            t0 = time.perf_counter()
            state, m = step(state, b_)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
        launches = {n: k.launches for n, k in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated()
        print(f'[extra train] {preset}: launches {launches} over '
              f'{TRAIN_STEPS} steps; losses {metrics[-1]}', flush=True)
        want = dict.fromkeys(KERNELS, 0)
        if cfg.temporal_fusion_module:
            want.update(correlation=TRAIN_STEPS,
                        correlation_bwd=TRAIN_STEPS)
        assert launches == want, (preset, launches)
        keys = {'B', 'C', 'M'} if cfg.head_type == 'legacy' else \
            {'BIoU', 'C', 'center', 'M', 'T', 'B_shift', 'M_shift'}
        for m in metrics:
            assert set(m) == keys | {'total', 'gnorm', 'lr'}, set(m)
            assert all(np.isfinite(v) for v in m.values()), m
        gn = [n_ for n_, p in model.named_parameters()
              if '.gn' in n_ or 'downsample_gn' in n_]
        assert bool(gn) == ('gn' in preset), gn
        assert all(float(p.grad.abs().max()) > 0
                   for n_, p in model.named_parameters() if n_ in gn)
        steady = sorted(ms[TRAIN_WARMUP:])
        med = (steady[len(steady) // 2 - 1] + steady[len(steady) // 2]) / 2
        rows = _device_events(lambda: step(state, batches[1]), 1)
        busy = sum(us for _, _, us in rows) / 1e3 if rows else None
        print(f'[extra train] {preset} {cfg.img_h}x{cfg.img_w} fp32 (TF32 '
              f'off), {TRAIN_CLIPS} clips = {2 * TRAIN_CLIPS} frames a step: '
              f'median {med:.3f} ms/step over {len(steady)} steps after '
              f'{TRAIN_WARMUP} warm-up, all steps {[round(t, 3) for t in ms]}'
              f'; peak memory {peak / 2**20:.1f} MiB, '
              f'{(peak - base) / 2**20:.1f} MiB above the '
              f'{base / 2**20:.1f} MiB allocated at the first step\'s start; '
              + (f'device busy {busy:.3f} ms a step (idle share '
                 f'{1 - busy / med:.3f}), {sum(c for _, c, _ in rows)} '
                 'launches' if rows else 'device busy not measured')
              + f'; {len(gn)} GroupNorm parameters trained ({name}, {smi})',
              flush=True)
        for key, cnt, us in sorted(rows, key=lambda r: -r[2])[:5]:
            print(f'[profile]   {us / 1e3:8.4f} ms/step {cnt:6d}x  '
                  f'{key[:100]}')
        del model, step, state, batches
        _train_step_vs_cpu(torch, dev, cfg, f'{preset} ')
        res[preset] = dict(ms=med, busy=busy, peak=peak, base=base,
                           launches=launches)
    return res


def _flag_surface(torch, dev, smi: str, name: str) -> dict:
    """Phase 11c: the flagship at 96x128, full depth, under FLAG_SURFACE.
    One training step (a batch with masks_p3) on the card against the CPU:
    every key of FLAG_KEYS present and finite, losses and gradients within
    phase 6's limits.  Then the eval step with the mask-IoU re-scoring:
    each frame's detections, decoded, suppressed and re-scored on the card
    and on the CPU from the card's outputs, and two frames of the video
    step on the card."""
    from stmask_torch.config import get_config
    from stmask_torch.inference import build_video_step
    from stmask_torch.inference.pipeline import detect_and_rescore, normalize_pad
    from stmask_torch.kernels import KERNELS
    from stmask_torch.models import build_model
    from stmask_torch.ops.anchors import all_priors
    cfg = get_config('STMask_plus_resnet50').replace(**FLAG_SURFACE)
    _train_step_vs_cpu(torch, dev, cfg, 'flags ', p3=True, keys=FLAG_KEYS)

    small = cfg.replace(img_h=96, img_w=128)
    clip = _synthetic_clip(96, 128, 2, seed=9)
    cpu = torch.device('cpu')
    card, host = build_model(small, dev, seed=0), build_model(small, cpu,
                                                              seed=0)
    priors = torch.as_tensor(all_priors(small))
    with torch.inference_mode():
        preds = card(normalize_pad(small, torch.from_numpy(clip[0]))[None]
                     .to(dev))
        got = detect_and_rescore(small, card, preds, priors.to(dev))
        want = detect_and_rescore(small, host, {k: v.cpu() for k, v in preds.items()},
                       priors)
    got = type(got)(*(t.cpu() for t in got))
    same = bool(torch.equal(got.valid, want.valid)
                and torch.equal(got.cls[want.valid], want.cls[want.valid]))
    d = float((got.score - want.score)[want.valid].abs().max())
    print(f'[flags] rescored detect card vs CPU at 96x128: '
          f'{int(want.valid.sum())} detections, validity and classes '
          f'{"equal" if same else "DIFFER"}, max|score diff| {d:.3e} (atol '
          '1e-5: the mask-IoU net in cuDNN against the CPU)', flush=True)
    assert int(want.valid.sum()) >= 5 and same and d <= 1e-5, d
    step, init = build_video_step(small, card, uint8_input=True, device=dev)
    for k in KERNELS.values():
        k.launches = 0
    state = init()
    for f, frame in enumerate(clip):
        state, out = step(state, frame, f == 0)
        for t in out:
            if t.is_floating_point():
                assert bool(torch.isfinite(t).all()), f
    assert KERNELS['correlation'].launches == 2
    print(f'[flags] {small.name} + {sorted(FLAG_SURFACE)}: the training '
          'step and the re-scored eval step ran on the card and agree with '
          f'the CPU ({name}, {smi})', flush=True)
    return dict(detections=int(want.valid.sum()), score_diff=d)


def _r101_eval(torch, dev, smi: str, name: str) -> dict:
    """C.7: the fp32 eval step (one stream) of STMask_plus_base (R101 with
    11 DCN sites, FCA, TF) at full width over phase 4's videos: the fused
    conv 11 times and K1 once a frame; the model against the CPU."""
    from stmask_torch.config import get_config
    from stmask_torch.models import build_model
    cfg = get_config('STMask_plus_base')
    assert _dcn_sites(cfg) == R101_DCN_SITES
    model = build_model(cfg, dev, seed=0)
    clips = [_synthetic_clip(cfg.img_h, cfg.img_w, FRAMES_PER_VIDEO, seed=v)
             for v in range(N_VIDEOS)]
    r = _run_eval_step(torch, dev, cfg, model, clips)
    n_frames = N_VIDEOS * FRAMES_PER_VIDEO
    print(f'[r101 eval] launches {r["launches"]} over {n_frames} frames',
          flush=True)
    want = dict.fromkeys(r['launches'], 0)
    want.update(deform_conv=R101_DCN_SITES * n_frames, correlation=n_frames)
    assert r['launches'] == want, r['launches']
    print(f'[r101 eval] STMask_plus_base {cfg.img_h}x{cfg.img_w} fp32 (TF32 '
          f'off), one stream: {_step_summary(r)} ({name}, {smi})',
          flush=True)
    _print_profile(r['rows'], 5)
    del model
    _model_vs_cpu(torch, dev, cfg, 'STMask_plus_base ')
    return r


def _ada_eval_cli(torch, dev, smi: str, name: str, ann: str, prefix: str,
                  tmp: str) -> dict:
    """C.7: the eval CLI's defaults with --config STMask_plus_resnet50_ada
    over phase 7's set, with --time_device: the bf16 fused conv (bf16
    offsets) at the 7 DCN and 15 FCB sites a step, the bf16 K1 once a
    step; frames/s end to end and device-only, peak memory, mAP."""
    import math

    from stmask_torch import eval as cli
    from stmask_torch.kernels import KERNELS
    out_json = f'{tmp}/results_ada.json'
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k.launches = 0
    stats = cli.evaluate(['--ann_file', ann, '--img_prefix', prefix,
                          '--eval_metrics', '--config',
                          'STMask_plus_resnet50_ada', '--mask_det_file',
                          out_json, '--time_device'])
    launches = {n: k.launches for n, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    steps = (stats['n_chunks'] + 1) * EVAL_CHUNK
    print(f'[ada cli] launches {launches} over {stats["n_chunks"]} chunks '
          f'and the warm-up chunk ({steps} steps)', flush=True)
    want = dict.fromkeys(KERNELS, 0)
    want.update(deform_conv_bf16=(7 + FCB_PER_FRAME) * steps,
                correlation_bf16=_lane_count('_ada eval CLI',
                                             'correlation_bf16', steps,
                                             EVAL_LANES))
    assert launches == want, (launches, want)
    for key in ('mAP', 'AP50', 'AP75', 'AR'):
        assert math.isfinite(stats[key]), stats
    with open(out_json) as fh:
        n_tracks = len(json.load(fh))
    assert n_tracks, 'no track in the results JSON'
    print(f'[ada cli] STMask_plus_resnet50_ada bf16, {EVAL_LANES} streams x '
          f'{EVAL_CHUNK}-frame chunks, --time_device: {stats["e2e_fps"]:.2f} '
          f'frames/s end to end, {stats["device_fps"]:.2f} frames/s '
          f'device-only ({stats["device_ms_per_chunk"]:.3f} ms a chunk), '
          f'deform_conv_bf16 {7 + FCB_PER_FRAME} launches a step, peak '
          f'memory {peak / 2**20:.1f} MiB, {n_tracks} tracks, mAP '
          f'{stats["mAP"]:.6f} ({name}, {smi})', flush=True)
    return dict(stats=stats, launches=launches, peak=peak)


def _lane_count(where: str, kernel: str, n: int, lanes: int) -> int:
    """The expected launches ``n`` of ``kernel`` once a step over the lane
    axis, printed beside the lane loop's ``lanes`` x ``n``."""
    print(f'[launches] {where} {kernel}: expected {n} (once a step over the '
          f'lanes; the lane loop launched {lanes * n})', flush=True)
    return n


def _counted(torch, fn, *args):
    """``fn(*args)`` with every kernel's launch count set to 0 just before
    it and read just after it: (result, launches)."""
    from stmask_torch.kernels import KERNELS
    torch.cuda.synchronize()
    for k in KERNELS.values():
        k.launches = 0
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {n: k.launches for n, k in KERNELS.items()}


def _fp32_step_only(launches: dict, sites: int, frames: int, tag: str):
    """The fp32 eval step's launches: the fused conv at each DCN site and K1
    once a frame, and no other kernel."""
    assert launches['deform_conv'] == sites * frames, (tag, launches)
    assert launches['correlation'] == frames, (tag, launches)
    assert sum(v for n, v in launches.items()
               if n not in ('deform_conv', 'correlation')) == 0, \
        (tag, launches)


def _other_modes(torch, dev, smi: str, name: str, ann: str, prefix: str,
                 train_ann: str, train_prefix: str, tmp: str, cc_ms: float,
                 cli_step_ms: float) -> dict:
    """Phase 12: the eval CLI's other modes over phase 7's set (12a
    --video_dir --display over one video, 12b --benchmark, 12c every
    --display* flag over 2 videos), 12d --coco over a synthetic COCO set,
    12e the training CLI with --vis_every over phase 8's set and a direct
    save_train_output, 12f --metrics_only --tensorboard_dir, and
    --video_dir on the card against the CPU at 96x128 (reduced depth)."""
    import dataclasses
    import math

    import cv2

    from stmask_torch import eval as cli
    from stmask_torch.config import REGISTRY, get_config
    from stmask_torch.data.synthetic import write_coco_set, write_ytvis_set
    from stmask_torch.data.transforms import prepare_batch
    from stmask_torch.train import __main__ as train_cli
    from stmask_torch.train import loop
    from stmask_torch.utils import rle
    from stmask_torch.utils.visualization import save_train_output

    cfg = get_config('STMask_plus_resnet50')
    sites = _dcn_sites(cfg)
    n_vid, n_fr, h, w = EVAL_SET
    res = {}

    # 12a: one video's PNG frames as --video_dir, with overlays
    vdir = os.path.join(prefix, 'video001')
    disp = f'{tmp}/video_dir'
    vd, launches = _counted(torch, cli.evaluate, [
        '--video_dir', vdir, '--display', '--display_dir', disp,
        '--mask_det_file', f'{tmp}/video_dir.json'])
    _fp32_step_only(launches, sites, n_fr, '--video_dir')
    assert vd['n_frames'] == n_fr, vd
    assert sorted(os.listdir(disp)) == [f'00000_{f:04d}.png'
                                        for f in range(n_fr)]
    with open(f'{tmp}/video_dir.json') as fh:
        tracks = json.load(fh)
    assert tracks and all(t['video_id'] == 0 and len(t['segmentations'])
                          == n_fr for t in tracks)
    res['video_dir'] = dict(vd, launches=launches)
    print(f'[modes] 12a --video_dir --display, {n_fr} PNG frames at {w}x{h} '
          f'of one video, fp32: {vd["e2e_fps"]:.2f} frames/s end to end '
          f'(decode, resize, step, fetch, postprocess, overlay; the first '
          f'frame included; {vd["seconds"]:.3f} s), {len(tracks)} tracks; '
          f'launches deform_conv {launches["deform_conv"]}, correlation '
          f'{launches["correlation"]} ({name}, {smi})', flush=True)

    # 12b: --benchmark over phase 7's set (fewer than 300 frames: all)
    bench, launches = _counted(torch, cli.evaluate, [
        '--ann_file', ann, '--img_prefix', prefix, '--benchmark',
        '--mask_det_file', f'{tmp}/bench.json'])
    _fp32_step_only(launches, sites, n_vid * n_fr, '--benchmark')
    assert bench['n_frames'] == n_vid * n_fr, bench
    assert not os.path.exists(f'{tmp}/bench.json')
    assert set(bench['stages']) == {'load', 'step', 'postprocess'}
    assert all(st['calls'] == n_vid * n_fr
               for st in bench['stages'].values()), bench
    assert math.isfinite(bench['fps']) and bench['fps'] > 0
    res['benchmark'] = dict(bench, launches=launches)
    print(f'[modes] 12b --benchmark, {n_vid} videos x {n_fr} PNG frames at '
          f'{w}x{h}, fp32, one stream: FPS {bench["fps"]:.3f} after 5 '
          f'warm-up frames ({1e3 / bench["fps"]:.3f} ms a frame end to end, '
          f'beside phase 4\'s step alone {cc_ms:.3f} ms a frame); stages ms a '
          f'frame (host clock; the fetch in postprocess waits for the '
          f'device): ' + ', '.join(f'{k} {st["avg_ms"]:.3f}' for k, st in
                                   bench['stages'].items())
          + f' ({name}, {smi})', flush=True)

    # where 12b's `step` stage spends its host time: one video under
    # torch.profiler, each StageTimer stage a record_function range
    import contextlib

    from torch.profiler import ProfilerActivity, profile, record_function

    from stmask_torch.utils import logger
    env = logger.StageTimer.env

    @contextlib.contextmanager
    def traced_env(timer, stage):
        with record_function(stage), env(timer, stage):
            yield

    logger.StageTimer.env = traced_env
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cli.evaluate(['--ann_file', ann, '--img_prefix', prefix,
                          '--benchmark', '--max_videos', '1'])
            torch.cuda.synchronize()
    finally:
        logger.StageTimer.env = env
    for stage in ('step', 'load', 'postprocess'):
        _print_host_split(f'12b {stage} stage, one video', prof, stage,
                          top=10 if stage == 'step' else 5)

    # 12c: every --display* flag over 2 videos
    disp = f'{tmp}/display'
    shown, launches = _counted(torch, cli.evaluate, [
        '--ann_file', ann, '--img_prefix', prefix, '--display',
        '--display_lincomb', '--display_fpn_outs', '--max_videos', '2',
        '--display_dir', disp, '--mask_det_file', f'{tmp}/display.json'])
    n = 2 * n_fr
    _fp32_step_only(launches, sites, n, '--display')
    overlays = [f for f in os.listdir(disp) if f.endswith('.png')]
    fpn, proto = os.listdir(f'{disp}/fpn'), os.listdir(f'{disp}/proto')
    assert len(overlays) == n and len(fpn) == 5 * n and \
        len(proto) == 3 * n, (len(overlays), len(fpn), len(proto))
    want = {f'P{i + 3}': (4 * -(-cfg.pad_h // (8 << i)),
                          4 * -(-cfg.pad_w // (8 << i))) for i in range(5)}
    want.update(proto_grid=(8 * cfg.pad_h // 4, 4 * cfg.pad_w // 4),
                running_grid=(8 * cfg.pad_h // 4, 4 * cfg.pad_w // 4),
                mask=(cfg.pad_h // 4, cfg.pad_w // 4))
    for sub, files in (('fpn', fpn), ('proto', proto)):
        for f in files:
            key = f[len('00001_0000_'):-len('.png')]
            g = cv2.imread(f'{disp}/{sub}/{f}', cv2.IMREAD_GRAYSCALE)
            assert g.shape == want[key], (f, g.shape, want[key])
    res['display'] = dict(shown, launches=launches)
    print(f'[modes] 12c --display --display_lincomb --display_fpn_outs, 2 '
          f'videos: {len(overlays)} overlays, {len(proto)} proto/ grids, '
          f'{len(fpn)} fpn/ grids of shapes {want}; {shown["e2e_fps"]:.2f} '
          'frames/s end to end with the writing', flush=True)

    # 12d: --coco over 16 images (one-frame videos: every lane starts a
    # new video at every step)
    t0 = time.perf_counter()
    cann, cprefix = write_coco_set(f'{tmp}/coco', *COCO_SET, seed=17,
                                   gt_hw=(cfg.img_h, cfg.img_w))
    wrote = time.perf_counter() - t0
    coco, launches = _counted(torch, cli.evaluate, [
        '--ann_file', cann, '--img_prefix', cprefix, '--coco',
        '--eval_metrics', '--mask_det_file', f'{tmp}/coco.json'])
    steps = (coco['n_chunks'] + 1) * EVAL_CHUNK       # and the warm-up
    assert coco['n_frames'] == COCO_SET[0], coco
    assert launches['deform_conv_bf16'] == sites * steps, launches
    assert launches['correlation_bf16'] == _lane_count(
        '--coco', 'correlation_bf16', steps, EVAL_LANES), launches
    assert sum(v for n_, v in launches.items()
               if not n_.endswith('bf16')) == 0, launches
    for key in ('mAP', 'AP50', 'AP75', 'AR'):
        assert math.isfinite(coco[key]), coco
    res['coco'] = dict(coco, launches=launches)
    print(f'[modes] 12d --coco --eval_metrics, {COCO_SET[0]} PNG images at '
          f'{COCO_SET[2]}x{COCO_SET[1]} (written in {wrote:.1f} s), bf16, '
          f'{EVAL_LANES} streams x {EVAL_CHUNK}-frame chunks: '
          f'{coco["e2e_fps"]:.2f} frames/s end to end over '
          f'{coco["n_chunks"]} chunks, mAP {coco["mAP"]:.6f}; launches '
          f'{launches["deform_conv_bf16"]} deform_conv_bf16 and '
          f'{launches["correlation_bf16"]} correlation_bf16 over '
          f'{coco["n_chunks"]} chunks and the warm-up chunk ({name}, {smi})',
          flush=True)

    # 12e: the training CLI with --vis_every over phase 8's set, each
    # overlay call timed between two synchronizes
    vis_ms = []

    def timed_save(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        save_train_output(*a, **kw)
        torch.cuda.synchronize()
        vis_ms.append((time.perf_counter() - t) * 1e3)

    loop.save_train_output = timed_save
    try:
        out, launches = _counted(torch, train_cli.run, [
            '--ann_file', train_ann, '--img_prefix', train_prefix,
            '--batch_size', str(TRAIN_CLIPS), '--max_iter',
            str(VIS_STEPS), '--validation_epoch', '0', '--vis_every',
            str(VIS_EVERY), '--vis_dir', f'{tmp}/train_vis',
            '--save_folder', f'{tmp}/weights', '--log_folder',
            f'{tmp}/logs'])
    finally:
        loop.save_train_output = save_train_output
    n_vis = VIS_STEPS // VIS_EVERY
    assert len(vis_ms) == n_vis and out['state'].step == VIS_STEPS
    forward = {'deform_conv': sites, 'correlation': 1}   # a train forward
    for n_, per in TRAIN_LAUNCHES.items():
        assert launches[n_] == per * VIS_STEPS + forward.get(n_, 0) * n_vis, \
            (n_, launches)
    files = sorted(os.listdir(f'{tmp}/train_vis'))
    assert len(files) == 3 * n_vis and {f.split('_')[1] for f in files} == {
        str(i) for i in range(VIS_EVERY, VIS_STEPS + 1, VIS_EVERY)} and {
        f.split('_', 3)[3] for f in files} == {'train.png', 'gt.png',
                                               'gt_ref.png'}, files
    # a direct call on the card: the model's state stays bit for bit
    model = out['state'].model
    batch = prepare_batch(cfg, _train_batch(cfg, seed=21), dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    flags = [m.training for m in model.modules()]
    save_train_output(cfg, model, batch, f'{tmp}/direct', 0, 0)
    torch.cuda.synchronize()
    after = model.state_dict()
    assert list(after) == list(before)
    for k, v in before.items():
        assert after[k].dtype == v.dtype and torch.equal(after[k], v), k
    assert [m.training for m in model.modules()] == flags
    assert len(os.listdir(f'{tmp}/direct')) == 3
    res['vis_every'] = dict(launches=launches, overlay_ms=vis_ms,
                            median_ms=sorted(vis_ms)[len(vis_ms) // 2])
    print(f'[modes] 12e training CLI --vis_every {VIS_EVERY}, {VIS_STEPS} '
          f'steps of {TRAIN_CLIPS} clips over phase 8\'s set: {len(files)} '
          f'overlay PNGs; save_train_output {[round(t, 3) for t in vis_ms]} '
          f'ms a call (train forward, match, host drawing, PNG writing; '
          f'synchronized) beside phase 8\'s CLI {cli_step_ms:.3f} ms/step; '
          f'launches {dict((k, v) for k, v in launches.items() if v)}; a '
          f'direct call left all {len(before)} tensors of the model bit for '
          f'bit ({name}, {smi})', flush=True)

    # 12f: --metrics_only --tensorboard_dir over 12c's results
    tb = f'{tmp}/tb'
    cli.evaluate(['--metrics_only', '--ann_file', ann, '--mask_det_file',
                  f'{tmp}/display.json', '--tensorboard_dir', tb])
    try:
        import torch.utils.tensorboard  # noqa: F401
        have_tb = True
    except ImportError:
        have_tb = False
    events = os.listdir(tb) if os.path.isdir(tb) else []
    assert (len(events) == 1 and events[0].endswith('VIS')) if have_tb \
        else not events, events
    res['tensorboard'] = bool(events)
    print(f'[modes] 12f --metrics_only --tensorboard_dir: '
          + (f'wrote {events[0]}' if events else
             'torch.utils.tensorboard does not import here: the JAX '
             'script\'s skip message, no file'), flush=True)

    # --video_dir on the card against the CPU at 96x128, reduced depth
    small_name = 'STMask_plus_resnet50_modes96'
    REGISTRY[small_name] = cfg.replace(
        name=small_name, img_h=96, img_w=128,
        backbone=dataclasses.replace(cfg.backbone, layers=(1, 3, 3, 1)))
    try:
        _, sprefix = write_ytvis_set(f'{tmp}/small', 1, 6, 192, 256,
                                     seed=19)
        got = {}
        for d in ('cuda', 'cpu'):
            cli.evaluate(['--config', small_name, '--video_dir',
                          os.path.join(sprefix, 'video001'), '--device', d,
                          '--mask_det_file', f'{tmp}/small_{d}.json'])
            with open(f'{tmp}/small_{d}.json') as fh:
                got[d] = json.load(fh)
    finally:
        REGISTRY.pop(small_name)
    a, b = got['cuda'], got['cpu']
    assert len(a) == len(b) > 0, (len(a), len(b))
    score_d, shares = 0.0, []
    for ta, tb_ in zip(a, b):
        assert (ta['video_id'], ta['category_id']) == \
            (tb_['video_id'], tb_['category_id']), (ta, tb_)
        score_d = max(score_d, abs(ta['score'] - tb_['score']))
        for sa, sb in zip(ta['segmentations'], tb_['segmentations']):
            assert (sa is None) == (sb is None)
            if sa is not None:
                shares.append(float((rle.decode(sa) == rle.decode(sb)).mean()))
    print(f'[check] --video_dir card vs CPU at 96x128 (layers 1,3,3,1), 6 '
          f'frames: {len(a)} tracks on both, the same order and categories; '
          f'max|score diff| {score_d:.3e} (limit {MODES_SCORE_ATOL}), masks '
          f'equal on at least {min(shares):.5f} of pixels (limit '
          f'{MODES_MASK_SHARE}) over {len(shares)} masks', flush=True)
    assert score_d <= MODES_SCORE_ATOL and min(shares) >= MODES_MASK_SHARE
    return res


# ---- phase 13: data-parallel training and the serving artifact ----------
DP_RANKS, DP_STEPS = 2, 4      # ranks on the one card, steps
# the ranks against one process over the whole batch from the same state
# (the first step, from the seeded weights, and the last, from rank 0's
# state): losses and gnorm rtol 1e-4.  The raw gradient's |diff| / |ref|
# and its worst parameter's max|diff| / max|ref|, each limit between the
# sound readings and the control's (each shard's gradient with its own
# normalizers, averaged: DDP's), card runs on an H100 80GB HBM3 at 700 W:
# first step 2.01e-4 and 7.25e-3 in every run (limits 1e-3, 2e-2; the
# control 1.85e-2, 0.198); last step 9.2e-5 to 1.13e-3 and 2.5e-3 to 1.81e-2
# (limits 4e-3, 5e-2; the control 1.34e-2, 0.380).  One process's step
# run twice parts by 3e-7 (K4's atomics); the script's witness, one
# process with cuDNN deterministic running the network over two 2-clip
# slices with the losses over all 4 clips, gives the ranks' 2.01e-4 and
# 7.25e-3 to the last digit: the split batch alone accounts for it (its
# sums round otherwise, and units near a ReLU or OHEM kink carry that
# into the gradient).  Along two
# trajectories (each step from its own previous one) rtol 5e-2: with
# random weights (M ~1e5, gnorm ~1e4, no clip) the losses of steps 1-3
# moved by up to 4.9e-3 in card runs
DP_LOSS_RTOL = 1e-4
DP_L2_REL = (1e-3, 4e-3)        # first step, last step
DP_PARAM_REL = (2e-2, 5e-2)
DP_TRAJ_RTOL = 5e-2
DP_LOSSES = ('BIoU', 'C', 'center', 'M', 'T', 'B_shift', 'M_shift',
             'total')
# the exported artifacts against the live steps (the same kernels in the
# same order): ids and kept slots equal, box, score and mask within 1e-5
EXPORT_ATOL = 1e-5
EXPORT_BATCHED = (2, 2)         # streams, frames a chunk (bf16 artifact)
EXPORT_BENCH_PASSES = 1


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _dp_rank(rank: int, world: int, port: int, tmp: str, hosts) -> None:
    """One rank of phase 13a (spawned): the flagship from seed 0 (rank 1
    first shifts every parameter, which replicate must undo), its share of
    each host batch, DP_STEPS training steps with the launches counted
    around each; rank 0 saves its state before the last step, and the
    last step's raw gradients and parameters."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR='localhost', MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist
    from stmask_torch.config import get_config
    from stmask_torch.data.transforms import prepare_batch
    from stmask_torch.kernels import KERNELS
    from stmask_torch.models import build_model
    from stmask_torch.parallel import initialize_multihost, replicate
    from stmask_torch.train.train_step import build_train_step

    dev = initialize_multihost(device='cuda')
    assert dist.get_backend() == 'gloo', dist.get_backend()
    cfg = get_config('STMask_plus_resnet50')
    model = build_model(cfg, dev, seed=0)
    if rank == 1:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.5)
    step, init = build_train_step(cfg, model, dev)
    state = replicate(init())
    params = list(model.parameters())

    def diff_to_rank0(ts):
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        ref = flat.clone()
        dist.broadcast(ref, src=0)
        return float((flat - ref).abs().max())

    out = {'metrics': [], 'launches': [], 'ms': [],
           'param_diff': [diff_to_rank0(params)]}
    n = TRAIN_CLIPS // world
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, host in enumerate(hosts):
        local = prepare_batch(cfg, {k: v[rank * n:(rank + 1) * n]
                                    for k, v in host.items()}, dev)
        if i == len(hosts) - 1 and rank == 0:
            out['before_last'] = (
                {k: p.detach().cpu() for k, p in model.named_parameters()},
                [m.cpu() for m in state.momentum], int(state.count))
        torch.cuda.synchronize()
        for k in KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        state, m = step(state, local)
        torch.cuda.synchronize()
        out['ms'].append((time.perf_counter() - t0) * 1e3)
        out['launches'].append({n_: k.launches for n_, k in KERNELS.items()})
        out['metrics'].append({k: float(v) for k, v in m.items()})
        if i == 0 and rank == 0:
            out['grads0'] = {k: p.grad.cpu()
                             for k, p in model.named_parameters()}
    out['peak'] = torch.cuda.max_memory_allocated()
    out['grad_diff'] = diff_to_rank0([p.grad for p in params])
    out['param_diff'].append(diff_to_rank0(params))
    if rank == 0:
        out['grads'] = {k: p.grad.cpu() for k, p in model.named_parameters()}
        out['params'] = {k: p.detach().cpu()
                         for k, p in model.named_parameters()}
    # the collective alone: the step's all_reduce of every gradient
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    ar = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3)
    out['all_reduce_ms'], out['all_reduce_mib'] = sorted(ar)[1], \
        flat.numel() * 4 / 2**20
    torch.save(out, f'{tmp}/rank{rank}.pt')
    dist.destroy_process_group()


@contextlib.contextmanager
def _split_forward(torch, model, parts: int):
    """Within the block, ``model``'s forward runs over ``parts`` equal
    slices of its clips and concatenates their outputs (every output leads
    with the frame or clip axis)."""
    if parts == 1:
        yield
        return
    fwd = model.forward

    def split(x, train=False):
        outs = [fwd(x_, train=train) for x_ in x.chunk(parts)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    model.forward = split
    try:
        yield
    finally:
        del model.forward


def _load_train_state(torch, model, state, saved):
    """``state`` with ``saved`` (parameters by name, momentum, count)."""
    params, momentum, count = saved
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
        for m, v in zip(state.momentum, momentum):
            m.copy_(v)
    return state._replace(count=torch.tensor(count, device=state.count.device),
                          step=count)


def _data_parallel(torch, dev, smi: str, name: str, train_med: float) -> dict:
    """Phase 13a: DP_RANKS gloo ranks on the one card against one process
    over the concatenated batches, and the per-shard control."""
    import torch.multiprocessing as tmp_mp
    from stmask_torch.config import get_config
    from stmask_torch.data.transforms import prepare_batch
    from stmask_torch.models import build_model
    from stmask_torch.train.train_step import build_train_step

    cfg = get_config('STMask_plus_resnet50')
    hosts = [_train_batch(cfg, 10 + i) for i in range(DP_STEPS)]
    tmp = tempfile.TemporaryDirectory()
    t_spawn = time.perf_counter()
    ctx = tmp_mp.start_processes(
        _dp_rank, args=(DP_RANKS, _free_port(), tmp.name, hosts),
        nprocs=DP_RANKS, join=False, start_method='spawn')
    try:
        # meanwhile: one process over the whole batches, and the control
        model = build_model(cfg, dev, seed=0)
        init_sd = {k: v.detach().cpu().clone()
                   for k, v in model.state_dict().items()}
        step, init = build_train_step(cfg, model, dev)

        def from_init():
            model.load_state_dict(init_sd)
            return init()

        def grads():
            return {k: p.grad.cpu() for k, p in model.named_parameters()}

        def per_shard(host, reset):
            """Each shard's step alone from ``reset()``'s state, with its
            own normalizers: (each shard's metrics, the gradients
            averaged), DDP's semantics."""
            n, shards, avg = TRAIN_CLIPS // DP_RANKS, [], {}
            for r in range(DP_RANKS):
                _, m = step(reset(), prepare_batch(cfg, {
                    k: v[r * n:(r + 1) * n] for k, v in host.items()}, dev))
                shards.append({k: float(v) for k, v in m.items()})
                for k, g in grads().items():
                    avg[k] = avg.get(k, 0) + g / DP_RANKS
            return shards, avg

        state = init()
        ref = []
        for host in hosts:
            state, m = step(state, prepare_batch(cfg, host, dev))
            ref.append({k: float(v) for k, v in m.items()})
            if len(ref) == 1:
                grads0 = grads()
        shards, control_g = per_shard(hosts[0], from_init)
        # the noise floor: one process's first step again
        step(from_init(), prepare_batch(cfg, hosts[0], dev))
        repeat_g = grads()
        # the witness of the cause: cuDNN deterministic, the 4-clip first
        # step, again, and with the network over DP_RANKS slices of the
        # clips (outputs concatenated; the losses and their normalizers
        # over the whole batch, as the ranks' are)
        cudnn = torch.backends.cudnn
        flags = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            witness = []
            for parts in (1, 1, DP_RANKS):
                with _split_forward(torch, model, parts):
                    step(from_init(), prepare_batch(cfg, hosts[0], dev))
                witness.append(grads())
        finally:
            cudnn.deterministic, cudnn.benchmark = flags
        while not ctx.join(timeout=600):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t_spawn
    ranks = [torch.load(f'{tmp.name}/rank{r}.pt', weights_only=False)
             for r in range(DP_RANKS)]
    tmp.cleanup()

    want = dict.fromkeys(ranks[0]['launches'][0], 0)
    want.update(TRAIN_LAUNCHES)
    keys = DP_LOSSES + ('gnorm',)

    def rel(got, ref_):
        return {k: abs(got[k] - ref_[k]) / max(abs(ref_[k]), 1e-30)
                for k in keys}

    traj = {}
    for r, rk in enumerate(ranks):
        assert rk['param_diff'] == [0.0, 0.0] and rk['grad_diff'] == 0.0, \
            (r, rk['param_diff'], rk['grad_diff'])
        for i, (got, m) in enumerate(zip(rk['metrics'], ref)):
            assert rk['launches'][i] == want, (r, i, rk['launches'][i])
            for k, v in rel(got, m).items():
                traj[k] = max(traj.get(k, 0.0), v)
        steady = sorted(rk['ms'][1:])
        ms = [round(t, 3) for t in rk['ms']]
        print(f'[dp] rank {r}: launches per step {rk["launches"][-1]} (each '
              f'of {DP_STEPS} steps); ms/step {ms} (median after the first '
              f'{steady[len(steady) // 2]:.3f}; '
              f'phase 6 alone, 4 clips: {train_med:.3f}); peak memory '
              f'{rk["peak"] / 2**20:.1f} MiB; all_reduce of '
              f'{rk["all_reduce_mib"]:.1f} MiB of gradients (gloo, one '
              f'card) {rk["all_reduce_ms"]:.3f} ms', flush=True)
    for i, m in enumerate(ref):
        print(f'[dp] step {i}: one process ' + ', '.join(
            f'{k} {m[k]:.6f}' for k in keys) + '; ranks ' + ', '.join(
            f'{k} {ranks[0]["metrics"][i][k]:.6f}' for k in keys))
    print('[dp] along the trajectories, max relative difference '
          + ', '.join(f'{k} {v:.3e}' for k, v in traj.items())
          + f' (rtol {DP_TRAJ_RTOL})', flush=True)
    assert max(traj.values()) <= DP_TRAJ_RTOL, traj
    first = rel(ranks[0]['metrics'][0], ref[0])
    control = {k: sum(s_[k] for s_ in shards) / DP_RANKS for k in DP_LOSSES}
    c_rel = {k: abs(control[k] - ref[0][k]) / abs(ref[0][k])
             for k in DP_LOSSES}
    print('[dp] control, each shard\'s losses with its own normalizers '
          'averaged (step 0): relative difference ' + ', '.join(
              f'{k} {v:.3e}' for k, v in c_rel.items())
          + f' (must exceed rtol {DP_LOSS_RTOL})', flush=True)
    assert max(c_rel.values()) > DP_LOSS_RTOL, c_rel

    # the last step from rank 0's own state: losses, raw gradients and
    # parameters
    def before_last():
        return _load_train_state(torch, model, init(),
                                 ranks[0]['before_last'])

    state, m = step(before_last(), prepare_batch(cfg, hosts[-1], dev))
    last = rel(ranks[0]['metrics'][-1], {k: float(v) for k, v in m.items()})
    grads3 = grads()
    prev = ranks[0]['before_last'][0]
    upd = {k: p.detach().cpu() - prev[k] for k, p in
           model.named_parameters()}
    _, control_g3 = per_shard(hosts[-1], before_last)

    def diff(got, want):
        """(|got - want| / |want| over every tensor, the worst tensor's
        max|got - want| / max|want|)."""
        num = den = worst = 0.0
        for k, w in want.items():
            d = (got[k] - w).double()
            num += float((d ** 2).sum())
            den += float((w.double() ** 2).sum())
            worst = max(worst, float(d.abs().max())
                        / max(float(w.abs().max()), 1e-30))
        return (num / den) ** 0.5, worst

    g0 = diff(ranks[0]['grads0'], grads0)
    g0_noise = diff(repeat_g, grads0)
    g0_control = diff(control_g, grads0)
    g3 = diff(ranks[0]['grads'], grads3)
    g3_control = diff(control_g3, grads3)
    w_noise = diff(witness[1], witness[0])
    w_split = diff(witness[2], witness[0])
    u3 = diff({k: v - prev[k] for k, v in ranks[0]['params'].items()}, upd)
    same = {k: max(first[k], last[k]) for k in keys}
    print('[dp] from the same state (step 0, and step '
          f'{DP_STEPS - 1} from rank 0\'s), max relative difference '
          + ', '.join(f'{k} {v:.3e}' for k, v in same.items())
          + f' (rtol {DP_LOSS_RTOL})', flush=True)
    print(f'[dp] raw gradient, |diff| / |ref| and the worst parameter\'s '
          f'max|diff| / max|ref|: step 0 {g0[0]:.3e}, {g0[1]:.3e} (limits '
          f'{DP_L2_REL[0]}, {DP_PARAM_REL[0]}; one process run twice '
          f'{g0_noise[0]:.3e}, {g0_noise[1]:.3e}; the control '
          f'{g0_control[0]:.3e}, {g0_control[1]:.3e}, which must exceed '
          f'both limits); step {DP_STEPS - 1} {g3[0]:.3e}, {g3[1]:.3e}, '
          f'its update {u3[0]:.3e}, {u3[1]:.3e} (limits {DP_L2_REL[1]}, '
          f'{DP_PARAM_REL[1]}; the control {g3_control[0]:.3e}, '
          f'{g3_control[1]:.3e}, which must exceed both) ({name}, {smi}; '
          f'{wall:.1f} s with the ranks\' start)', flush=True)
    print(f'[dp] witness, one process with cuDNN deterministic, step 0: '
          f'the 4-clip step run twice {w_noise[0]:.3e}, {w_noise[1]:.3e}; '
          f'the network over {DP_RANKS} slices of {TRAIN_CLIPS // DP_RANKS} '
          f'clips (the losses over all {TRAIN_CLIPS}) against one pass '
          f'{w_split[0]:.3e}, {w_split[1]:.3e}', flush=True)
    assert max(same.values()) <= DP_LOSS_RTOL, same
    for i, (d, c) in enumerate(((g0, g0_control), (g3, g3_control))):
        assert c[0] > DP_L2_REL[i] and c[1] > DP_PARAM_REL[i], (i, c)
        assert d[0] <= DP_L2_REL[i] and d[1] <= DP_PARAM_REL[i], (i, d)
    assert u3[0] <= DP_L2_REL[1] and u3[1] <= DP_PARAM_REL[1], u3
    del model, step, state
    torch.cuda.empty_cache()
    return dict(launches=ranks[0]['launches'][-1], ms=ranks[0]['ms'],
                ms_rank1=ranks[1]['ms'], peak=[rk['peak'] for rk in ranks],
                all_reduce_ms=ranks[0]['all_reduce_ms'], same=same,
                traj=traj, control=c_rel, grad0=g0, grad0_noise=g0_noise,
                grad0_control=g0_control, grad_last=g3, update_last=u3,
                grad_last_control=g3_control, witness_noise=w_noise,
                witness_split=w_split,
                wall=wall)


def _nccl_world1(torch, dev, phase6: list) -> dict:
    """Phase 13b: an NCCL process group of world size 1 on the card, its
    collectives and 2 training steps against phase 6's."""
    import torch.distributed as dist
    from stmask_torch.config import get_config
    from stmask_torch.data.transforms import prepare_batch
    from stmask_torch.models import build_model
    from stmask_torch.parallel import (all_gather_cat, all_reduce_sum,
                                       replicate)
    from stmask_torch.train.train_step import build_train_step

    dist.init_process_group('nccl', init_method=f'tcp://localhost:'
                            f'{_free_port()}', world_size=1, rank=0,
                            device_id=torch.device(
                                'cuda', torch.cuda.current_device()))
    try:
        t = torch.arange(6.0, device=dev)
        s, gathered = t.clone(), [torch.empty_like(t)]
        dist.all_reduce(s)
        dist.all_gather(gathered, t)
        dist.broadcast(s, src=0)
        torch.cuda.synchronize()
        assert torch.equal(s, t) and torch.equal(gathered[0], t)
        assert all_reduce_sum(t) is t and all_gather_cat(t) is t
        cfg = get_config('STMask_plus_resnet50')
        model = build_model(cfg, dev, seed=0)
        step, init = build_train_step(cfg, model, dev)
        state = replicate(init())
        got, launches = [], []
        for i in range(2):
            batch = prepare_batch(cfg, _train_batch(cfg, 10 + i), dev)
            (state, m), ln = _counted(torch, step, state, batch)
            got.append({k: float(v) for k, v in m.items()})
            launches.append(ln)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    rel = [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
               for k in DP_LOSSES + ('gnorm',))
           for g, w in zip(got, phase6)]
    print(f'[nccl] world size 1, backend {backend}: all_reduce, all_gather '
          f'and broadcast on the card; 2 training steps against phase 6\'s '
          f'first two: max relative difference {rel[0]:.3e} (step 0, from '
          f'the same seeded weights; rtol {DP_LOSS_RTOL}), {rel[1]:.3e} '
          f'(step 1, along the trajectories; rtol {DP_TRAJ_RTOL}); '
          f'launches {launches}', flush=True)
    assert backend == 'nccl', backend
    assert rel[0] <= DP_LOSS_RTOL and rel[1] <= DP_TRAJ_RTOL, rel
    want = dict.fromkeys(launches[0], 0)
    want.update(TRAIN_LAUNCHES)
    assert all(ln == want for ln in launches), launches
    del model, step, state
    torch.cuda.empty_cache()

    return dict(launches=launches[-1], rel=rel)


def _start_clis(ann: str, prefix: str, tmp: str) -> dict:
    """Phase 13's command-line runs, started together: the training CLI
    under torchrun with one process (2 steps of phase 6's batch over phase
    8's set), and python -m stmask_torch.export of the fp32 single-stream
    step and of the bf16 EXPORT_BATCHED step (seeded random weights, as
    phase 4's).  tag -> (start time, process, output file)."""
    n_b, k_b = EXPORT_BATCHED
    cmds = {
        'torchrun': ['-m', 'torch.distributed.run', '--standalone',
                     '--nproc_per_node=1', '-m', 'stmask_torch.train',
                     '--ann_file', ann, '--img_prefix', prefix,
                     '--batch_size', str(TRAIN_CLIPS), '--max_iter', '2',
                     '--num_workers', '4', '--save_folder', f'{tmp}/w',
                     '--log_folder', f'{tmp}/logs'],
        'fp32': ['-m', 'stmask_torch.export', '--out', f'{tmp}/fp32.stmask'],
        'bf16': ['-m', 'stmask_torch.export', '--out', f'{tmp}/bf16.stmask',
                 '--bf16', '--batched', str(n_b), '--chunk', str(k_b)]}
    root = os.path.dirname(os.path.abspath(__file__))
    started = {}
    for tag, cmd in cmds.items():
        log = f'{tmp}/{tag}.out'
        with open(log, 'w') as f:
            started[tag] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, *cmd], cwd=root, stdout=f,
                stderr=subprocess.STDOUT), log)
    return started


def _finish(tag: str, started) -> tuple:
    """Wait for one of _start_clis' processes: (its output, seconds)."""
    t0, p, log = started
    p.wait(timeout=900)
    secs = time.perf_counter() - t0
    with open(log) as f:
        out = f.read()
    assert p.returncode == 0, (tag, out[-4000:])
    return out, secs


def _torchrun_cli(started, tmp: str) -> float:
    """The torchrun run of _start_clis: exit 0 and its one checkpoint."""
    _, secs = _finish('torchrun', started)
    saved = sorted(os.listdir(f'{tmp}/w'))
    print(f'[torchrun] --nproc_per_node=1 -m stmask_torch.train, 2 steps of '
          f'{TRAIN_CLIPS} clips over phase 8\'s set: exit 0 in {secs:.1f} s '
          f'(start-up included, beside the export CLIs), checkpoints '
          f'{saved}', flush=True)
    assert saved == ['STMask_plus_resnet50_1_2.pth'], saved
    return secs


_ARTIFACT_RUN = r'''
import json, sys, time
sys.path.insert(0, %(root)r)
import numpy as np
import torch
t0 = time.perf_counter()
from stmask_torch.export import load_exported
step, meta = load_exported(%(path)r)
load_s = time.perf_counter() - t0
from stmask_torch.kernels import KERNELS
frames = np.load(%(frames)r)            # [V, F, H, W, 3]
n, k = meta['batched'], meta['chunk_size']
calls = []
if n:
    first = np.zeros((k, n), bool)
    for c in range(frames.shape[1] // k):
        calls.append((np.ascontiguousarray(
            frames[:n, c * k:(c + 1) * k].transpose(1, 0, 2, 3, 4)),
            first | (c == 0) & (np.arange(k) == 0)[:, None]))
else:
    for v in range(frames.shape[0]):
        for f in range(frames.shape[1]):
            calls.append((frames[v, f], f == 0))
torch.cuda.synchronize()
for kk in KERNELS.values():
    kk.launches = 0
outs, ms = [], []
state = None
for fr, first in calls:
    if state is None or (not n and first):
        state = step.init_state()
    t = time.perf_counter()
    state, out = step(state, torch.from_numpy(fr), torch.as_tensor(first))
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t) * 1e3)
    outs.append({f: getattr(out, f).cpu() for f in
                 ('keep', 'obj_id', 'box', 'score', 'mask')})
launches = {name: kk.launches for name, kk in KERNELS.items()}
weights = {str(t.device) for t in step._fn.state_dict().values()}
mods = sorted(m for m in sys.modules if m.startswith('stmask_torch.'))
from stmask_torch.export import bench_artifact
bench = bench_artifact(%(path)r, %(passes)d)
torch.save({'outs': outs, 'launches': launches, 'ms': ms, 'load_s': load_s,
            'weights': sorted(weights), 'mods': mods, 'bench': bench},
           %(out)r)
'''


def _export_phase(torch, dev, smi: str, name: str, clips, live_ms: float,
                  tmp: str, started: dict) -> dict:
    """Phase 13c: the export CLIs' fp32 single-stream and bf16 batched
    artifacts (started by _start_clis), each loaded in a fresh process
    that imports no model code, run over ``clips`` against the live step
    and timed alone by bench_artifact (what the CLI's --bench runs)."""
    from stmask_torch.config import get_config
    from stmask_torch.inference.pipeline import (build_video_step,
                                                 build_video_step_batched)
    from stmask_torch.models import build_model

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = get_config('STMask_plus_resnet50')
    np.save(f'{tmp}/frames.npy', np.stack(clips))
    n_b, k_b = EXPORT_BATCHED
    arts = ('fp32', 'bf16')
    cli = {}
    for tag in arts:
        out, secs = _finish(tag, started[tag])
        wrote = [ln for ln in out.splitlines() if ln.startswith('wrote ')]
        m = re.search(r'in ([\d.]+) s export \+ ([\d.]+) s save', wrote[0])
        cli[tag] = dict(line=wrote[0], export_s=float(m.group(1)),
                        save_s=float(m.group(2)), wall=secs,
                        mb=os.path.getsize(f'{tmp}/{tag}.stmask') / 1e6)
        print(f'[export] {tag}: {wrote[0]}; the CLI took {secs:.1f} s with '
              'its start-up, beside the other CLIs', flush=True)
    runs = {}
    for tag in arts:             # one at a time: each is timed
        code = _ARTIFACT_RUN % dict(root=root, path=f'{tmp}/{tag}.stmask',
                                    frames=f'{tmp}/frames.npy',
                                    out=f'{tmp}/{tag}.pt',
                                    passes=EXPORT_BENCH_PASSES)
        res = subprocess.run([sys.executable, '-c', code], cwd=tmp,
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, (tag, res.stdout[-3000:],
                                     res.stderr[-3000:])
        runs[tag] = torch.load(f'{tmp}/{tag}.pt', weights_only=False)
        mods = runs[tag]['mods']
        assert not [m for m in mods if m.startswith(
            ('stmask_torch.models', 'stmask_torch.inference.pipeline'))], mods
        assert runs[tag]['weights'] == [str(torch.device('cuda', 0))], \
            runs[tag]['weights']

    # the live steps on the same weights
    live = {}
    model = build_model(cfg, dev, seed=0)
    step, init_state = build_video_step(cfg, model, uint8_input=True,
                                        device=dev)
    outs = []
    for clip in clips:
        state = init_state()
        for f, frame in enumerate(clip):
            state, out = step(state, frame, f == 0)
            outs.append(out)
    live['fp32'] = outs
    model = build_model(cfg, dev, seed=0)
    chunk, make_states = build_video_step_batched(
        cfg, model, n_videos=n_b, chunk_size=k_b, uint8_input=True,
        device=dev, compute_dtype=torch.bfloat16)
    states, outs = make_states(), []
    frames = np.stack(clips)
    for c in range(FRAMES_PER_VIDEO // k_b):
        fr = np.ascontiguousarray(frames[:n_b, c * k_b:(c + 1) * k_b]
                                  .transpose(1, 0, 2, 3, 4))
        first = np.zeros((k_b, n_b), bool)
        first[0] = c == 0
        states, out = chunk(states, fr, first)
        outs.append(out)
    live['bf16'] = outs
    del model, step, chunk
    torch.cuda.empty_cache()

    per_call = {'fp32': 1, 'bf16': n_b * k_b}
    result = {}
    for tag, run in runs.items():
        worst, kept = 0.0, 0
        for got, want in zip(run['outs'], live[tag]):
            for f in ('keep', 'obj_id'):
                assert torch.equal(got[f], getattr(want, f).cpu()), (tag, f)
            for f in ('box', 'score', 'mask'):
                d = float((got[f].float() - getattr(want, f).float().cpu())
                          .abs().max())
                worst = max(worst, d)
            kept += int(got['keep'].sum())
        n_calls = len(run['outs'])
        frames_ = n_calls * per_call[tag]
        launches = run['launches']
        steady = sorted(run['ms'][WARMUP_FRAMES:])
        med = steady[len(steady) // 2]
        b = run['bench']
        print(f'[export] {tag} artifact in a fresh process ({len(run["mods"])}'
              f' modules of stmask_torch, none of models or the pipeline; '
              f'weights on {run["weights"]}): {n_calls} calls, {frames_} '
              f'frames, {kept} kept tracks; against the live step: keep and '
              f'obj_id equal, box / score / mask max|diff| {worst:.3e} (atol '
              f'{EXPORT_ATOL}); load {run["load_s"]:.2f} s with the imports; '
              f'median {med:.3f} ms a call after {WARMUP_FRAMES}; '
              f'bench_artifact, {EXPORT_BENCH_PASSES} passes: '
              f'{b["value"]:.2f} frames/s (min {b["min"]:.2f}, max '
              f'{b["max"]:.2f}) against the live fp32 step\'s '
              f'{1e3 / live_ms:.2f} ({live_ms:.3f} ms/frame, phase 4); '
              f'launches {launches} ({name}, {smi})', flush=True)
        assert kept > 0 and worst <= EXPORT_ATOL, (tag, kept, worst)
        if tag == 'fp32':
            _fp32_step_only(launches, 7, frames_, 'fp32 artifact')
        else:
            assert launches['deform_conv_bf16'] == 7 * n_calls * k_b, launches
            assert launches['correlation_bf16'] == _lane_count(
                'bf16 batched artifact', 'correlation_bf16', n_calls * k_b,
                n_b), launches
            assert sum(v for n_, v in launches.items() if n_ not in (
                'deform_conv_bf16', 'correlation_bf16')) == 0, launches
        result[tag] = dict(cli[tag], launches=launches, worst=worst,
                           ms=med, load_s=run['load_s'], frames=frames_,
                           bench=b)
    return result


# phase 14: bf16 training and remat.  The bf16 backward entries against
# their plain versions: both sum in fp32 from the same bf16 values and round
# once, so a value may differ by one bf16 ulp (2^-7 of it) where the sums'
# order decides, plus 2^-12 of max|ref| for values near 0 (fixed before the
# entries' first run on the card)
BF16_BWD_RTOL = 2.0 ** -7
BF16_BWD_ATOL = 2.0 ** -12
# the training step's modes (build_train_step's remat and compute_dtype),
# each run for MODE_STEPS steps of phase 6's batches from seeded weights
MODE_STEPS = 4
# launches a step of each mode: remat runs the forward twice (the second
# time inside the backward)
MODE_LAUNCHES = {
    'fp32': TRAIN_LAUNCHES,
    'remat': dict(TRAIN_LAUNCHES, deform_conv=14, correlation=2),
    'bf16': {'deform_conv_bf16': 7, 'deform_wgrad_bf16': 7,
             'deform_col2im_bf16': 7, 'correlation_bf16': 1,
             'correlation_bwd_bf16': 1},
    'bf16_remat': {'deform_conv_bf16': 14, 'deform_wgrad_bf16': 7,
                   'deform_col2im_bf16': 7, 'correlation_bf16': 2,
                   'correlation_bwd_bf16': 1}}
# remat against the plain step from the same state, cuDNN deterministic:
# the relative L2 of the whole gradient (K4 adds dx with atomics, so two
# plain runs differ by ~2.5e-7 too)
REMAT_GRAD_REL = 1e-6
ALI_BF16_STEPS = 2
# the bf16 + remat steps of STMask_plus_resnet50_ali: the backbone's 7
# sites with bf16 offsets, FCB's 15 with fp32 ones
ALI_BF16_LAUNCHES = {'deform_conv_bf16': 14,
                     'deform_conv_bf16_f32off': 2 * FCB_PER_FRAME,
                     'deform_wgrad_bf16': 7,
                     'deform_wgrad_bf16_f32off': FCB_PER_FRAME,
                     'deform_col2im_bf16': 7,
                     'deform_col2im_bf16_f32off': FCB_PER_FRAME,
                     'correlation_bf16': 2, 'correlation_bwd_bf16': 1}


def _bf16_err(got, again, want, same: bool = True) -> float:
    """max|got - want| / max|want| of a bf16 entry's output, after checking
    its type, the tolerance (BF16_BWD_RTOL of each value plus BF16_BWD_ATOL
    of max|want|) and, when ``same``, that a second launch gave it bit for
    bit."""
    import torch
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype)
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    lim = BF16_BWD_RTOL * w.abs() + BF16_BWD_ATOL * scale
    d = (g - w).abs()
    assert bool((d <= lim).all()), (float(d.max()), scale)
    if same:
        assert torch.equal(got, again)
    return float(d.max()) / max(scale, 1e-30)


def _wgrad_route(KW, g, x) -> str:
    """The path of deform_wgrad's kernel that a call with ``g`` and ``x``
    takes (the wrapper's own decision)."""
    return ('fast' if KW.wgrad_fast(x.shape[3], g.shape[1], x.data_ptr(),
                                    g.data_ptr()) else 'general')


_CONV_FAST_PATH = ('fast (bf16 wgmma fed by a warp-specialised gather '
                   'ring)')
_CONV_LIBRARY_IS = ('cuBLAS\'s bf16 GEMM over the gathered columns alone '
                    '(the columns made beforehand; not the same function)')


def _split_sites(torch, dev) -> list:
    """(label, arguments of deform_conv_cuda) of the bf16 fused conv's
    split: the 7 DCN sites (mask, bias, bf16 offsets) and FCB's 48x80 3x5
    site (v1, no bias), bf16, EVAL_LANES frames each."""
    out = []
    for i, (site, (h, w, cin), stride) in enumerate(DCN_SITES):
        x, off, mask = _dcn_inputs(torch, dev, h, w, cin, stride, i,
                                   b=EVAL_LANES)
        wt, bias = _dcn_weight(torch, dev, 3, 3, cin, cin, i)
        out.append((site, tuple(t.bfloat16() for t in (x, off, wt, mask,
                                                        bias)) + (stride, 1)))
    x, off, wt = _fcb_inputs(torch, dev, 48, 80, 3, 5, EVAL_LANES, 900)
    out.append(('FCB 48x80 3x5', (x.bfloat16(), off.bfloat16(),
                                  wt.bfloat16(), None, None, 1, 1)))
    return out


def _col2im_split_sites(torch, dev) -> list:
    """(label, arguments of deform_col2im_cuda) of K4's bf16 split: the 7
    DCN sites (random offsets clamped to +-2, mask) and FCB's 48x80 3x5
    site (no mask), bf16 dcols, x and offsets, 2 * TRAIN_CLIPS frames."""
    bf = torch.bfloat16
    frames = 2 * TRAIN_CLIPS
    out = []
    for i, (site, (h, w, cin), stride) in enumerate(DCN_SITES):
        dcols, x, off, mask = _dcn_train_inputs(torch, dev, h, w, cin,
                                                stride, frames, 'random',
                                                1700 + i)
        out.append((site, tuple(t.to(bf) for t in (dcols, x, off, mask))
                    + (3, 3, stride)))
    dcols, x, off, _ = _dcn_train_inputs(torch, dev, 48, 80, 256, 1, frames,
                                         'random', 1710, 3, 5)
    out.append(('FCB 48x80 3x5', tuple(t.to(bf) for t in (dcols, x, off))
                + (None, 3, 5, 1)))
    return out


def _split_sum(rows: dict, n: int) -> float:
    """The whole kernel's ms summed over the first ``n`` sites of a split."""
    return sum(r['whole'] for r in list(rows.values())[:n])


def _conv_route(KD, args) -> str:
    """The route on which ``KD.deform_conv_cuda(*args)`` (bf16 x) launches
    the bf16 entry of its offsets' type: read from the split the wrapper
    hands the entry (0 names the general route; the entry refuses a fast
    call that the fast route cannot take).  Launches it once."""
    name = ('KERNEL_BF16' if args[1].dtype == args[0].dtype
            else 'KERNEL_BF16_F32OFF')
    kern = getattr(KD, name)
    splits = []

    def record(*a):
        splits.append(a[-2])
        return kern(*a)

    setattr(KD, name, record)
    try:
        KD.deform_conv_cuda(*args)
    finally:
        setattr(KD, name, kern)
    return 'fast' if splits[0] > 0 else 'general'


def _col2im_route(K4, args) -> str:
    """The route on which ``K4.deform_col2im_cuda(*args)`` (bf16 dcols and
    x) launches the bf16 entry of its offsets' type: read from the route
    the wrapper hands the entry (1 fast, 0 general; the entry refuses a
    fast call that the fast route cannot take).  Launches it once."""
    name = ('KERNEL_BF16' if args[2].dtype == args[1].dtype
            else 'KERNEL_BF16_F32OFF')
    kern = getattr(K4, name)
    routes = []

    def record(*a):
        routes.append(a[-2])
        return kern(*a)

    setattr(K4, name, record)
    try:
        K4.deform_col2im_cuda(*args)
    finally:
        setattr(K4, name, kern)
    return 'fast' if routes[0] == 1 else 'general'


@contextlib.contextmanager
def _general_route(module, predicate: str):
    """The bf16 calls of a kernel's wrapper in ``module`` take the general
    route (its route predicate ``predicate`` says no), as every call did
    before the fast route."""
    fast = getattr(module, predicate)
    setattr(module, predicate, lambda *a: False)
    try:
        yield
    finally:
        setattr(module, predicate, fast)


_COL2IM_FAST_PATH = ('fast (bf16 rows staged by cp.async in a two-chunk '
                     'ring, tiles of up to 8 x 8 sites)')


_CORR_BWD_FAST_PATH = ('fast (bf16 source rows staged by cp.async in a '
                       'four-row ring)')


def _bf16_conv_time(torch, KD, args, flops: float, iters: int) -> dict:
    """The fused conv's bf16 entry at one site (``args`` of deform_conv_cuda,
    bf16 x, weight, mask and bias, bf16 or fp32 offsets): route, device ms,
    per-call ms, plain ms, the bound (x, offset, mask, weight, bias read
    once and out written once; the gather's ``flops`` at the fp32 peak and
    2*M*N*K at the bf16 peak), the bytes the kernel's loads ask of L2 (every
    corner run of every sample, 4 x 2 bytes a (site, column), once per tile
    column, and the weight rows once per tile row, from conv_plan) and
    their rate, and cuBLAS's bf16 GEMM over the gathered columns (the
    columns made beforehand: the library yardstick, not the same
    function)."""
    x, off, wt, mask, bias, stride, dil = args
    b, ho, wo, _ = off.shape
    cout, kh, kw, cin = wt.shape
    m, ktot = b * ho * wo, kh * kw * cin
    route = _conv_route(KD, args)
    plan = KD.conv_plan(m, cin, cout, kh, kw, route == 'fast')
    ms = _device_ms(lambda: KD.deform_conv_cuda(*args), iters)
    call = _time_ms(lambda: KD.deform_conv_cuda(*args), iters)
    plain = _time_ms(lambda: KD.deform_conv_reference(*args), 2, warmup=1)
    nbytes = (sum(t.element_size() * t.numel() for t in (x, off, wt, mask,
                                                          bias)
                  if t is not None) + 2 * m * cout)
    mm = 2 * m * cout * ktot
    bound, by = _bound_ms(nbytes, flops, bf16_flops=mm)
    corner = 8 * m * ktot * -(-cout // plan.bn)
    weight = 2 * ktot * cout * -(-m // plan.bm)
    cols = KD.deform_cols_bf16(x, off, mask, kh, kw, stride,
                               dil).to(torch.bfloat16)
    w2 = wt.reshape(cout, ktot).t()
    lib = _device_ms(lambda: cols @ w2, iters)
    del cols
    return dict(route=route, plan=plan, ms=ms, call_ms=call, plain_ms=plain,
                bound_ms=bound, by=by, nbytes=nbytes, flops=flops, mm=mm,
                l2_bytes=corner + weight, corner_bytes=corner,
                weight_bytes=weight,
                l2_tb_s=(corner + weight) / (ms * 1e-3) / 1e12,
                library_ms=lib, bytes_s=nbytes / PEAK_BYTES_PER_S,
                ops_s=_ops_s(flops, bf16_flops=mm))


def _bf16_conv_line(r: dict) -> str:
    return (f'{r["route"]} route, kernel {r["ms"]:.5f} ms (device), per '
            f'wrapper call {r["call_ms"]:.5f} ms, plain {r["plain_ms"]:.5f} '
            f'ms, bound {r["bound_ms"]:.5f} ms ({r["by"]}; {r["nbytes"]} B, '
            f'{r["flops"]} fp32 flop, {r["mm"]} bf16 flop); asked of L2 '
            f'{r["corner_bytes"] / 1e6:.1f} MB of corner runs + '
            f'{r["weight_bytes"] / 1e6:.1f} MB of weight rows, '
            f'{r["l2_tb_s"]:.3f} TB/s; cuBLAS bf16 GEMM over the gathered '
            f'columns (not the same function) {r["library_ms"]:.5f} ms; '
            f'plan {r["plan"]}')


def _acc_add(acc: dict, r: dict, **extra) -> None:
    """Add a site's times and bound to the sums in ``acc``."""
    for key in ('ms', 'call_ms', 'plain_ms', 'bound_ms', 'bytes_s', 'ops_s',
                'library_ms', 'l2_bytes'):
        acc[key] = acc.get(key, 0.0) + r[key]
    for key, v in extra.items():
        acc[key] = acc.get(key, 0.0) + v


def _wgrad_bf16_matrix(torch, dev, KW, x, off, mask, kh, kw, stride,
                       cout, gen) -> tuple:
    """deform_wgrad's bf16 entries at one site under every input they
    take: bf16 and fp32 offsets, with and without the mask, random, zero
    and integer (+-1, +-2) offsets; each against the plain version with
    _bf16_err (bit for bit over two launches).  Returns (routes, worst
    max|diff| / max|ref|, cases)."""
    bf = torch.bfloat16
    xb = x.to(bf)
    g = torch.randn(off.shape[0] * off.shape[1] * off.shape[2], cout,
                    device=dev, generator=gen).to(bf)
    vals = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=dev)
    kinds = {'random': off, 'zero': torch.zeros_like(off),
             'integer': vals[torch.randint(0, 4, off.shape, device=dev,
                                           generator=gen)]}
    routes, worst, n = set(), 0.0, 0
    for o in kinds.values():
        for od in (bf, torch.float32):
            for m in (mask, None):
                ob, mb = o.to(od), None if m is None else m.to(bf)
                routes.add(_wgrad_route(KW, g, xb))
                got = KW.deform_wgrad_cuda(g, xb, ob, mb, kh, kw, stride)
                again = KW.deform_wgrad_cuda(g, xb, ob, mb, kh, kw, stride)
                want = KW.deform_wgrad_reference(g, xb, ob, mb, kh, kw,
                                                 stride)
                torch.cuda.synchronize()
                worst = max(worst, _bf16_err(got, again, want))
                n += 1
    return routes, worst, n


def _bf16_backward(torch, dev, smi: str, err: dict) -> dict:
    """Phase 14a: the bf16 entries of deform_wgrad, K4 and K3 against their
    plain versions and timed beside them, with their bounds: at the
    flagship's 7 DCN sites x 8 frames (bf16 offsets and mask), at FCB's 15
    sites x 8 frames with bf16 offsets (_ada) and with fp32 ones (_ali, the
    f32off entries), and K3 at [4, 24, 40, 256] (fp32 g and out, as K1's
    bf16 entry writes them).  deform_wgrad's bf16 entries also at every
    site under bf16 and fp32 offsets, with and without the mask, random,
    zero and integer offsets (checked, not timed), each timed site beside
    the fp32 kernel on the same inputs in fp32, with the route its kernel
    takes (fast or general), and two shapes off the fast path (Cin 48, an
    x one element into its buffer) through the general path.  Bounds: the
    bytes of the bf16 (and fp32) tensors read and written once;
    deform_wgrad's product as a bf16 tensor-core product (2MNK at the bf16
    peak) plus the gather's fp32 flops, K4's and K3's fp32 flops as in
    phase 6.  deform_wgrad's library column is cuBLAS's bf16 GEMM g^T @
    cols alone (cols gathered beforehand: not the same function)."""
    from stmask_torch.kernels import correlation_bwd as K3
    from stmask_torch.kernels import deform_col2im as K4
    from stmask_torch.kernels import deform_wgrad as KW
    from stmask_torch.kernels import split as KS
    from stmask_torch.kernels.deform_conv import deform_cols_bf16
    # K4's and K3's split variants build while the entries are checked
    builds = threading.Thread(target=KS.build_variants, args=(KS.COL2IM,))
    builds.start()
    k3_builds = threading.Thread(target=KS.build_variants,
                                 args=(KS.CORR_BWD,))
    k3_builds.start()
    bf = torch.bfloat16
    frames = 2 * TRAIN_CLIPS
    acc = {k: {} for k in ('deform_wgrad_bf16', 'deform_col2im_bf16',
                           'deform_wgrad_bf16_fcb', 'deform_col2im_bf16_fcb',
                           'deform_wgrad_bf16_f32off',
                           'deform_col2im_bf16_f32off')}
    lib = {'sites': 0.0, 'fcb': 0.0}
    routes = {}

    def one(tag, key, dcols, x, off, mask, kh, kw, stride, gen, cout):
        k = kh * kw
        m = dcols.shape[0]
        g = torch.randn(m, cout, device=dev, generator=gen).to(bf)
        route = _wgrad_route(KW, g, x)
        routes.setdefault(key, set()).add(route)
        got = KW.deform_wgrad_cuda(g, x, off, mask, kh, kw, stride)
        again = KW.deform_wgrad_cuda(g, x, off, mask, kh, kw, stride)
        want = KW.deform_wgrad_reference(g, x, off, mask, kh, kw, stride)
        torch.cuda.synchronize()
        e_w = _bf16_err(got, again, want)
        del got, again, want
        args4 = (dcols, x, off, mask, kh, kw, stride)
        route4 = _col2im_route(K4, args4)
        routes.setdefault('col2im' + key, set()).add(route4)
        got = K4.deform_col2im_cuda(*args4)
        again = K4.deform_col2im_cuda(*args4)
        want = K4.deform_col2im_reference(*args4)
        torch.cuda.synchronize()
        assert want[1].dtype == off.dtype
        e_4 = max(_bf16_err(got[0], again[0], want[0], same=False),
                  _bf16_err(got[1], again[1], want[1]),
                  0.0 if mask is None else _bf16_err(got[2], again[2],
                                                     want[2]))
        del got, again, want
        wk = 'deform_wgrad' + key
        ck = 'deform_col2im' + key
        for name_, e in ((wk, e_w), (ck, e_4)):
            base = name_.replace('_fcb', '')
            err[base] = max(err[base], e)
        fl = _dcn_cost(torch, x, off.float(), stride, kh, kw,
                       modulated=mask is not None)[1]
        n_mask = 0 if mask is None else mask.numel()
        nb = (2 * (x.numel() + n_mask + g.numel() + cout * k * x.shape[3])
              + off.element_size() * off.numel())
        ms = _device_ms(lambda: KW.deform_wgrad_cuda(g, x, off, mask, kh, kw,
                                                     stride), 20)
        call = _time_ms(lambda: KW.deform_wgrad_cuda(g, x, off, mask, kh, kw,
                                                     stride), 20)
        plain = _time_ms(lambda: KW.deform_wgrad_reference(
            g, x, off, mask, kh, kw, stride), 2, warmup=1)
        bw, byw = _tally(acc[wk], ms, call, plain, nb, fl,
                         bf16_flops=2 * m * cout * k * x.shape[3])
        gf, xf, of = g.float(), x.float(), off.float()
        mf = None if mask is None else mask.float()
        f32 = _device_ms(lambda: KW.deform_wgrad_cuda(gf, xf, of, mf, kh, kw,
                                                      stride), 20)
        acc[wk]['fp32_ms'] = acc[wk].get('fp32_ms', 0.0) + f32
        del gf, xf, of, mf
        cols = deform_cols_bf16(x, off, mask, kh, kw, stride).to(bf)
        l_ms = _device_ms(lambda: g.t() @ cols, 20)
        del cols
        nb4, fl4 = _col2im_cost(torch, x, off.float(), stride, kh=kh, kw=kw,
                                modulated=mask is not None)
        nb4 = (2 * (dcols.numel() + 2 * x.numel() + 2 * n_mask)
               + 2 * off.element_size() * off.numel())
        ms4 = _device_ms(lambda: K4.deform_col2im_cuda(*args4), 20)
        call4 = _time_ms(lambda: K4.deform_col2im_cuda(*args4), 20)
        plain4 = _time_ms(lambda: K4.deform_col2im_reference(*args4), 2,
                          warmup=1)
        b4, by4 = _tally(acc[ck], ms4, call4, plain4, nb4, fl4)
        # the general route (the design every call took before the fast
        # route) and the fp32 kernel on the same inputs
        with _general_route(K4, 'col2im_fast'):
            gen4 = _device_ms(lambda: K4.deform_col2im_cuda(*args4), 20)
        f32in = tuple(None if t is None else t.float()
                      for t in (dcols, x, off, mask))
        f32_4 = _device_ms(lambda: K4.deform_col2im_cuda(
            *f32in, kh, kw, stride), 20)
        del f32in
        for k_, v in (('general_ms', gen4), ('fp32_ms', f32_4)):
            acc[ck][k_] = acc[ck].get(k_, 0.0) + v
        plan4 = K4.col2im_plan(*off.shape[:3], x.shape[3], kh, kw, stride,
                               fast=route4 == 'fast')
        print(f'[bf16 bwd] {tag}: deform_wgrad{key} route {route}, '
              f'{ms:.5f} ms (device), call {call:.5f}, plain {plain:.5f}, '
              f'bound {bw:.5f} ({byw}), max|diff| {e_w:.3e} of max|ref|, the '
              f'bf16 GEMM alone {l_ms:.5f}, the fp32 kernel {f32:.5f}; '
              f'deform_col2im{key} route {route4}, {ms4:.5f} ms, call '
              f'{call4:.5f}, plain {plain4:.5f}, bound {b4:.5f} ({by4}), '
              f'the general route {gen4:.5f}, the fp32 kernel {f32_4:.5f}, '
              f'max|diff| {e_4:.3e} of max|ref|, plan {plan4}', flush=True)
        return l_ms

    def matrix(tag, x, off, mask, kh, kw, stride, cout, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        r, e, n = _wgrad_bf16_matrix(torch, dev, KW, x, off, mask, kh, kw,
                                     stride, cout, gen)
        err['deform_wgrad_bf16'] = max(err['deform_wgrad_bf16'], e)
        routes.setdefault('matrix', set()).update(r)
        print(f'[bf16 wgrad] {tag}: route {"/".join(sorted(r))}, {n} cases '
              '(bf16 and fp32 offsets, with and without the mask, random, '
              f'zero and integer offsets): max|diff| {e:.3e} of max|ref|, '
              'each bit-identical over two launches', flush=True)

    for i, (site, (h, w, cin), stride) in enumerate(DCN_SITES):
        dcols, x, off, mask = _dcn_train_inputs(torch, dev, h, w, cin,
                                                stride, frames, 'random',
                                                1400 + i)
        gen = torch.Generator(device=dev).manual_seed(1450 + i)
        lib['sites'] += one(f'{site} x {frames} frames', '_bf16',
                            dcols.to(bf), x.to(bf), off.to(bf), mask.to(bf),
                            3, 3, stride, gen, cin)
        del dcols
        matrix(f'{site} x {frames} frames', x, off, mask, 3, 3, stride, cin,
               1470 + i)
        del x, off, mask
    for i, (h, w, kh, kw) in enumerate(FCB_SITES):
        x, off, _ = _fcb_inputs(torch, dev, h, w, kh, kw, frames, 1500 + i)
        off = off.clamp(-2, 2)
        gen = torch.Generator(device=dev).manual_seed(1550 + i)
        dcols = torch.randn(frames * h * w, kh * kw * 256, device=dev,
                            generator=gen).to(bf)
        xb = x.to(bf)
        for key, o in (('_bf16_fcb', off.to(bf)), ('_bf16_f32off', off)):
            l_ms = one(f'FCB {h}x{w} {kh}x{kw} x {frames} frames', key,
                       dcols, xb, o, None, kh, kw, 1, gen, 256)
            if key == '_bf16_f32off':
                lib['fcb'] += l_ms
        del dcols, xb
        mask = torch.rand(frames, h, w, kh * kw, device=dev, generator=gen)
        matrix(f'FCB {h}x{w} {kh}x{kw} x {frames} frames', x, off, mask, kh,
               kw, 1, 256, 1580 + i)
        del x, off, mask
    # the fast routes of deform_wgrad and K4 at all 22 sites, each entry
    assert routes.keys() == {'_bf16', '_bf16_fcb', '_bf16_f32off', 'matrix',
                             'col2im_bf16', 'col2im_bf16_fcb',
                             'col2im_bf16_f32off'} and all(
        r == {'fast'} for r in routes.values()), routes
    # off the fast path: Cin 48, and an x one element into its buffer
    for tag, (h, w, cin), shift in (('Cin 48', (24, 40, 48), 0),
                                    ('x one element into its buffer',
                                     (24, 40, 256), 1)):
        _, x, off, mask = _dcn_train_inputs(torch, dev, h, w, cin, 1, 2,
                                            'random', 1590)
        xb = torch.empty(x.numel() + shift, device=dev, dtype=bf)[shift:]
        xb = xb.view(x.shape).copy_(x)
        gen = torch.Generator(device=dev).manual_seed(1591)
        g = torch.randn(2 * h * w, cin, device=dev, generator=gen).to(bf)
        route = _wgrad_route(KW, g, xb)
        assert route == 'general', (tag, route)
        worst = 0.0
        for od in (bf, torch.float32):
            for m in (mask.to(bf), None):
                got = KW.deform_wgrad_cuda(g, xb, off.to(od), m, 3, 3)
                again = KW.deform_wgrad_cuda(g, xb, off.to(od), m, 3, 3)
                want = KW.deform_wgrad_reference(g, xb, off.to(od), m, 3, 3)
                torch.cuda.synchronize()
                worst = max(worst, _bf16_err(got, again, want))
        err['deform_wgrad_bf16'] = max(err['deform_wgrad_bf16'], worst)
        print(f'[bf16 wgrad] {tag} ([2, {h}, {w}, {cin}], Cout {cin}): '
              f'route {route}, bf16 and fp32 offsets, with and without the '
              f'mask: max|diff| {worst:.3e} of max|ref|, each bit-identical '
              'over two launches', flush=True)
    # K4 off its fast route: Cin 6, and an x one element into its buffer
    for tag, cin, shift in (('Cin 6', 6, 0),
                            ('x one element into its buffer', 256, 1)):
        dcols, x, off, mask = _dcn_train_inputs(torch, dev, 24, 40, cin, 1,
                                                2, 'random', 1595)
        xb = torch.empty(x.numel() + shift, device=dev, dtype=bf)[shift:]
        xb = xb.view(x.shape).copy_(x)
        worst = 0.0
        for od in (bf, torch.float32):
            for m in (mask.to(bf), None):
                args4 = (dcols.to(bf), xb, off.to(od), m, 3, 3, 1)
                route = _col2im_route(K4, args4)
                assert route == 'general', (tag, route)
                got = K4.deform_col2im_cuda(*args4)
                again = K4.deform_col2im_cuda(*args4)
                want = K4.deform_col2im_reference(*args4)
                torch.cuda.synchronize()
                worst = max(worst, _bf16_err(got[0], again[0], want[0],
                                             same=False),
                            _bf16_err(got[1], again[1], want[1]),
                            0.0 if m is None else _bf16_err(got[2], again[2],
                                                            want[2]))
        err['deform_col2im_bf16'] = max(err['deform_col2im_bf16'], worst)
        print(f'[bf16 bwd] K4 {tag} ([2, 24, 40, {cin}]): route general, '
              f'bf16 and fp32 offsets, with and without the mask: max|diff| '
              f'{worst:.3e} of max|ref|, d_offset and d_mask bit-identical '
              'over two launches', flush=True)
    # where K4's bf16 time goes (kernels/split.py: builds with a part left
    # out) on the general route (the design before the fast route) and on
    # the fast one
    builds.join()
    split_sites = _col2im_split_sites(torch, dev)
    k4_split = {}
    for route in ('general', 'fast'):
        k4_split[route] = KS.split(KS.COL2IM, K4, split_sites,
                                   K4.deform_col2im_cuda,
                                   lambda fn: _device_ms(fn, 20), route)
        KS.print_split(KS.COL2IM, route, k4_split[route], smi,
                       2 * TRAIN_CLIPS)
    del split_sites

    # K3 bf16 at the training shape: the fast route (the one training
    # takes) against the plain version and, bit for bit, against the
    # general route (the design before it); both routes' times beside the
    # fp32 entry's on the same values, then where each route's time goes
    tshape = (TRAIN_CLIPS, 24, 40, 256)
    gen = torch.Generator(device=dev).manual_seed(1600)
    up, x1, x2, out = _corr_bwd_inputs(torch, dev, tshape, 11, gen)
    x1, x2 = x1.to(bf), x2.to(bf)
    got = K3.correlation_bwd_cuda(up, x1, x2, 11, out)
    assert K3.corr_bwd_fast(tshape[-1], x1.data_ptr(), x2.data_ptr(),
                            *(d.data_ptr() for d in got))
    again = K3.correlation_bwd_cuda(up, x1, x2, 11, out)
    with _general_route(K3, 'corr_bwd_fast'):
        general = K3.correlation_bwd_cuda(up, x1, x2, 11, out)
    want = K3.correlation_bwd_reference(up, x1, x2, 11, out)
    torch.cuda.synchronize()
    e3 = max(_bf16_err(a, a2, b) for a, a2, b in zip(got, again, want))
    same = all(torch.equal(a, b) for a, b in zip(got, general))
    assert same, 'K3 bf16: the fast route differs from the general route'
    err['correlation_bwd_bf16'] = max(err['correlation_bwd_bf16'], e3)
    k3 = {}
    ms = _device_ms(lambda: K3.correlation_bwd_cuda(up, x1, x2, 11, out),
                    200)
    call = _time_ms(lambda: K3.correlation_bwd_cuda(up, x1, x2, 11, out),
                    200)
    plain = _time_ms(lambda: K3.correlation_bwd_reference(
        up, x1, x2, 11, out), 5)
    with _general_route(K3, 'corr_bwd_fast'):
        gen_ms = _device_ms(lambda: K3.correlation_bwd_cuda(
            up, x1, x2, 11, out), 200)
    x1f, x2f = x1.float(), x2.float()
    f32_ms = _device_ms(lambda: K3.correlation_bwd_cuda(up, x1f, x2f, 11,
                                                        out), 200)
    del x1f, x2f
    b, h_, w_, c = tshape
    nb = 4 * 2 * b * h_ * w_ * 121 + 2 * 4 * b * h_ * w_ * c
    bound, by = _tally(k3, ms, call, plain, nb, _corr_bwd_cost(tshape, 11)[1])
    k3.update(general_ms=gen_ms, fp32_ms=f32_ms, routes_bit_identical=same)
    print(f'[bf16 bwd] correlation_bwd_bf16 {list(tshape)} P 11 (bf16 x1, '
          f'x2, dx1, dx2; fp32 g, out): fast route {ms:.5f} ms (device), '
          f'call {call:.5f}, the general route {gen_ms:.5f} ms, the fp32 '
          f'entry on the same values {f32_ms:.5f} ms, plain {plain:.5f}, '
          f'bound {bound:.5f} ({by}), max|diff| {e3:.3e} of max|ref|, the '
          f'two routes bit for bit the same: {same}, bit-identical over two '
          f'launches ({smi})', flush=True)
    acc['correlation_bwd_bf16'] = k3
    k3_builds.join()
    k3_split = {}
    for route in ('general', 'fast'):
        k3_split[route] = KS.split(
            KS.CORR_BWD, K3, [(f'{list(tshape)} P 11', (up, x1, x2, 11,
                                                         out))],
            K3.correlation_bwd_cuda, lambda fn: _device_ms(fn, 200), route)
        KS.print_split(KS.CORR_BWD, route, k3_split[route], smi,
                       'one bf16 training step\'s call')
    for key, a in acc.items():
        print(f'[bf16 bwd] summed, {key}: {a["ms"]:.5f} ms (device), per call '
              f'{a["call_ms"]:.5f} ms, plain {a["plain_ms"]:.5f} ms, bound '
              f'{a["bound_ms"]:.5f} ms ({_by_of(a)})'
              + (f', the fp32 kernel {a["fp32_ms"]:.5f} ms' if 'fp32_ms' in a
                 else '')
              + (f', the general route {a["general_ms"]:.5f} ms'
                 if 'general_ms' in a else '') + f' ({smi})', flush=True)
    print(f'[bf16 bwd] the bf16 GEMM g^T @ cols alone (cuBLAS), summed: 7 '
          f'sites {lib["sites"]:.5f} ms, FCB 15 sites {lib["fcb"]:.5f} ms '
          f'(device) ({smi})', flush=True)
    return dict(acc=acc, lib=lib, k4_split=k4_split, k3_split=k3_split)


def _train_modes(torch, dev, smi: str, name: str, hosts) -> dict:
    """Phase 14b: the flagship's training step (4 clips = 8 frames at
    360x640, phase 6's batches) in each mode of build_train_step: fp32,
    remat, bf16, bf16 + remat.  Each from the same seeded weights for
    MODE_STEPS steps: launches a step (MODE_LAUNCHES), finite losses,
    ms/step (median of steps 1-3), peak memory above the first step's
    start.  Then, with cuDNN deterministic, one remat step against one
    plain step from the same state (gradients within REMAT_GRAD_REL of the
    whole gradient's L2, losses within 1e-6), beside two plain steps;
    and the bf16 step's losses against the fp32 step's, read."""
    from stmask_torch.config import get_config
    from stmask_torch.data.transforms import prepare_batch
    from stmask_torch.kernels import KERNELS
    from stmask_torch.models import build_model
    from stmask_torch.train.train_step import build_train_step
    cfg = get_config('STMask_plus_resnet50')
    batches = [prepare_batch(cfg, h_, dev) for h_ in hosts[:MODE_STEPS]]
    modes = (('fp32', {}), ('remat', dict(remat=True)),
             ('bf16', dict(compute_dtype=torch.bfloat16)),
             ('bf16_remat', dict(remat=True, compute_dtype=torch.bfloat16)))
    res = {}
    for tag, kw in modes:
        model = build_model(cfg, dev, seed=0)
        step, init = build_train_step(cfg, model, dev, **kw)
        state = init()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for k in KERNELS.values():
            k.launches = 0
        ms, metrics = [], []
        for b_ in batches:
            t0 = time.perf_counter()
            state, m = step(state, b_)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
        launches = {n: k.launches for n, k in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated() - base
        want = dict.fromkeys(KERNELS, 0)
        want.update({n_: per * MODE_STEPS
                     for n_, per in MODE_LAUNCHES[tag].items()})
        assert launches == want, (tag, launches, want)
        for m in metrics:
            assert all(np.isfinite(v) for v in m.values()), (tag, m)
        assert all(p.grad is None or p.grad.dtype == torch.float32
                   for p in model.parameters()), tag
        med = sorted(ms[1:])[len(ms[1:]) // 2]
        res[tag] = dict(ms=med, all_ms=ms, peak=peak, base=base,
                        metrics=metrics, launches=launches,
                        per_step={n_: v // MODE_STEPS
                                  for n_, v in launches.items() if v})
        print(f'[modes] {tag}: median {med:.3f} ms/step over steps 1-'
              f'{MODE_STEPS - 1}, all {[round(t, 3) for t in ms]}; peak '
              f'{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB '
              f'allocated at the first step\'s start; launches a step '
              f'{res[tag]["per_step"]}; losses of step 0 '
              f'{metrics[0]} ({name}, {smi})', flush=True)
        if tag == 'bf16':
            # one steady bf16 step under torch.profiler, as phase 6's
            rows = _device_events(lambda: step(state, batches[1]), 1)
            if rows:
                busy = sum(us for _, _, us in rows) / 1e3
                res[tag].update(busy=busy, top=[
                    (key, cnt, us / 1e3) for key, cnt, us in
                    sorted(rows, key=lambda r: -r[2])[:15]])
                print(f'[profile] bf16 train step: device busy {busy:.3f} '
                      f'ms of {med:.3f} ms wall (idle share '
                      f'{1 - busy / med:.3f}), '
                      f'{sum(c for _, c, _ in rows)} kernel launches '
                      f'({smi})', flush=True)
                for key, cnt, ms_ in res[tag]['top']:
                    print(f'[profile]   {ms_:8.4f} ms/step {cnt:6d}x  '
                          f'{key[:100]}')
            else:
                print('[profile] torch.profiler recorded no device time for '
                      'the bf16 train step: device busy share not measured')
        del model, step, state
        torch.cuda.empty_cache()
    f0, b0 = res['fp32']['metrics'][0], res['bf16']['metrics'][0]
    gap = {k: abs(b0[k] - f0[k]) / max(abs(f0[k]), 1e-30) for k in f0
           if k != 'lr'}
    print(f'[modes] bf16 against fp32, step 0 from the same weights and '
          f'batch, |bf16 - fp32| / |fp32|: '
          + ', '.join(f'{k} {v:.3e}' for k, v in gap.items()), flush=True)

    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    runs = {}
    try:
        for tag, kw in (('plain', {}), ('plain_again', {}),
                        ('remat', dict(remat=True))):
            model = build_model(cfg, dev, seed=0)
            step, init = build_train_step(cfg, model, dev, **kw)
            _, m = step(init(), batches[0])
            runs[tag] = ({k: float(v) for k, v in m.items()},
                         [(torch.zeros_like(p) if p.grad is None else p.grad)
                          .detach().clone() for p in model.parameters()])
            del model, step
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det

    def rel(a, b):
        num = sum(float((x - y).double().norm()) ** 2 for x, y in zip(a, b))
        den = sum(float(y.double().norm()) ** 2 for y in b)
        return (num / den) ** 0.5

    (pl, pg), (al, ag), (rl, rg) = (runs[k] for k in ('plain', 'plain_again',
                                                      'remat'))
    r_rel, noise = rel(rg, pg), rel(ag, pg)
    l_rel = max(abs(rl[k] - pl[k]) / max(abs(pl[k]), 1e-30) for k in pl)
    print(f'[modes] remat against plain from the same state (cuDNN '
          f'deterministic): gradient relative L2 {r_rel:.3e} (limit '
          f'{REMAT_GRAD_REL:.0e}), losses max relative {l_rel:.3e}; two plain '
          f'steps: {noise:.3e}', flush=True)
    assert r_rel <= REMAT_GRAD_REL and l_rel <= 1e-6, (r_rel, l_rel)
    del runs, batches
    torch.cuda.empty_cache()
    return dict(res=res, remat_rel=r_rel, noise=noise, loss_rel=l_rel,
                gap=gap)


def _ali_bf16_remat(torch, dev, smi: str, name: str, hosts) -> dict:
    """Phase 14c: ALI_BF16_STEPS bf16 + remat steps of
    STMask_plus_resnet50_ali (FCB's fp32 analytic offsets) over phase 6's
    batches: finite losses, launches a step (ALI_BF16_LAUNCHES), peak
    memory above the first step's start."""
    from stmask_torch.config import get_config
    from stmask_torch.data.transforms import prepare_batch
    from stmask_torch.kernels import KERNELS
    from stmask_torch.models import build_model
    from stmask_torch.train.train_step import build_train_step
    cfg = get_config('STMask_plus_resnet50_ali')
    model = build_model(cfg, dev, seed=0)
    step, init = build_train_step(cfg, model, dev, remat=True,
                                  compute_dtype=torch.bfloat16)
    batches = [prepare_batch(cfg, h_, dev) for h_ in hosts[:ALI_BF16_STEPS]]
    state = init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for k in KERNELS.values():
        k.launches = 0
    ms, metrics = [], []
    for b_ in batches:
        t0 = time.perf_counter()
        state, m = step(state, b_)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {n: k.launches for n, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated() - base
    want = dict.fromkeys(KERNELS, 0)
    want.update({n_: per * ALI_BF16_STEPS
                 for n_, per in ALI_BF16_LAUNCHES.items()})
    assert launches == want, (launches, want)
    for m in metrics:
        assert all(np.isfinite(v) for v in m.values()), m
    print(f'[ali bf16] STMask_plus_resnet50_ali bf16 + remat, '
          f'{ALI_BF16_STEPS} steps of {TRAIN_CLIPS} clips: losses {metrics}; '
          f'steps {[round(t, 3) for t in ms]} ms; peak {peak / 2**20:.1f} MiB '
          f'above the {base / 2**20:.1f} MiB allocated at the first step\'s '
          f'start; launches {launches} ({name}, {smi})', flush=True)
    del model, step, state, batches
    torch.cuda.empty_cache()
    return dict(ms=ms, peak=peak, base=base, launches=launches,
                metrics=metrics)


# K5 (the exact gather's backward) and the radius-0 training paths: the
# offsets K5 is checked at (all 0; integers placing every sample at a row in
# {-1, 0, H-1, H} and a column in {-1, 0, W-1, W}; N(0, 6), far off the
# image) and timed at (N(0, 1.5), as a training step's offsets spread);
# its tolerances, fixed before its first run in the form of K4's: fp32
# relative to max|ref| (dx adds with atomics), bf16 BF16_REL_ATOL of
# max|ref|
EXACT_KINDS = ('zero', 'edge', 'normal6')
EXACT_RTOL = 1e-5
EXACT_STEPS = 2
# launches a step of each radius-0 training run of phase 15 (both window
# radii 0); remat runs the forward twice
_EXACT_FP32 = {'deform_conv': 7, 'deform_wgrad': 7, 'deform_exact_bwd': 7,
               'correlation': 1, 'correlation_bwd': 1}
_EXACT_BF16 = {'deform_conv_bf16': 22, 'deform_wgrad_bf16': 22,
               'deform_exact_bwd_bf16': 22, 'correlation_bf16': 1,
               'correlation_bwd_bf16': 1}
EXACT_LAUNCHES = {
    ('STMask_plus_resnet50', 'fp32'): _EXACT_FP32,
    ('STMask_plus_resnet50_ada', 'fp32'): {
        n_: 22 if n_.startswith('deform') else v
        for n_, v in _EXACT_FP32.items()},
    ('STMask_plus_resnet50_ada', 'remat'): {
        n_: 44 if n_ == 'deform_conv' else 2 if n_ == 'correlation'
        else 22 if n_.startswith('deform') else v
        for n_, v in _EXACT_FP32.items()},
    ('STMask_plus_resnet50_ada', 'bf16'): _EXACT_BF16,
    ('STMask_plus_resnet50_ada', 'bf16_remat'): dict(
        _EXACT_BF16, deform_conv_bf16=44, correlation_bf16=2),
    ('STMask_plus_resnet50_ali', 'bf16'): {
        'deform_conv_bf16': 7, 'deform_conv_bf16_f32off': FCB_PER_FRAME,
        'deform_wgrad_bf16': 7, 'deform_wgrad_bf16_f32off': FCB_PER_FRAME,
        'deform_exact_bwd_bf16': 7,
        'deform_exact_bwd_bf16_f32off': FCB_PER_FRAME,
        'correlation_bf16': 1, 'correlation_bwd_bf16': 1}}


def _radius0(cfg, fcb_only: bool = False):
    """``cfg`` with FCB's window radius 0 and, unless ``fcb_only``, the
    backbone DCN's too: the exact gather in training."""
    import dataclasses
    if fcb_only:
        return cfg.replace(fcb_window_radius=0)
    return cfg.replace(backbone=dataclasses.replace(
        cfg.backbone, dcn_window_radius=0), fcb_window_radius=0)


def _exact_inputs(torch, dev, h, w, cin, stride, frames, kind, seed, kh=3,
                  kw=3, dilation=1):
    """K5's inputs at one site (dcols, x, offset, mask; fp32): x, dcols and
    the mask random, the offsets of ``kind`` (EXACT_KINDS, or 'random':
    N(0, 1.5))."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    k = kh * kw
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(frames, h, w, cin, device=dev, generator=g)
    shape = (frames, ho, wo, 2 * k)
    if kind == 'zero':
        off = torch.zeros(shape, device=dev)
    elif kind == 'edge':
        oy = torch.arange(ho, device=dev) * stride - (kh - 1) // 2 * dilation
        ox = torch.arange(wo, device=dev) * stride - (kw - 1) // 2 * dilation
        ky = torch.arange(kh, device=dev) * dilation
        kx = torch.arange(kw, device=dev) * dilation
        rows = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
            ho, wo, kh, kw).reshape(ho, wo, k)
        cols = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
            ho, wo, kh, kw).reshape(ho, wo, k)
        pick = (frames, ho, wo, k)
        ty = torch.tensor([-1, 0, h - 1, h], device=dev)[torch.randint(
            0, 4, pick, device=dev, generator=g)]
        tx = torch.tensor([-1, 0, w - 1, w], device=dev)[torch.randint(
            0, 4, pick, device=dev, generator=g)]
        off = torch.stack([ty - rows, tx - cols], -1).reshape(shape).float()
    else:
        std = 6.0 if kind == 'normal6' else 1.5
        off = torch.randn(shape, device=dev, generator=g) * std
    mask = torch.rand(frames, ho, wo, k, device=dev, generator=g)
    dcols = torch.randn(frames * ho * wo, k * cin, device=dev, generator=g)
    return dcols, x, off, mask


def _exact_typed(torch, args, entry: str):
    """K5's inputs in the types of ``entry`` ('fp32', 'bf16': all bf16,
    'bf16_f32off': bf16 with fp32 offsets)."""
    if entry == 'fp32':
        return args
    dcols, x, off, mask = args
    b16 = torch.bfloat16
    return (dcols.to(b16), x.to(b16), off if entry == 'bf16_f32off'
            else off.to(b16), None if mask is None else mask.to(b16))


def _exact_route(K5, args, kh, kw, stride, dilation=1) -> str:
    """The route on which ``K5.deform_exact_bwd_cuda`` launches ``args``:
    read from the route the wrapper hands the entry (1 fast, 0 general; the
    entry refuses a fast call that the fast route cannot take).  Launches
    it once."""
    name = ('KERNEL' if args[1].element_size() == 4
            else 'KERNEL_BF16' if args[2].dtype == args[1].dtype
            else 'KERNEL_BF16_F32OFF')
    kern = getattr(K5, name)
    routes = []

    def record(*a):
        routes.append(a[-9])
        return kern(*a)

    setattr(K5, name, record)
    try:
        K5.deform_exact_bwd_cuda(*args, kh, kw, stride, dilation)
    finally:
        setattr(K5, name, kern)
    return 'fast' if routes[0] == 1 else 'general'


def _exact_check(torch, args, kh, kw, stride, dilation=1):
    """K5 on ``args`` (dcols, x, offset, mask) on the route its wrapper
    takes and on the general route, each against the plain version and
    against each other, every output in its input's type, within EXACT_RTOL
    (fp32) or BF16_REL_ATOL (bf16) of the plain version's max|ref|;
    d_offset and d_mask the same bit for bit over two launches on each
    route.  Returns (the largest max|diff| / max|ref|, the route)."""
    from stmask_torch.kernels import deform_exact_bwd as K5
    route = _exact_route(K5, args, kh, kw, stride, dilation)
    runs = [K5.deform_exact_bwd_cuda(*args, kh, kw, stride, dilation)
            for _ in range(2)]
    with _general_route(K5, 'exact_bwd_fast'):
        runs += [K5.deform_exact_bwd_cuda(*args, kh, kw, stride, dilation)
                 for _ in range(2)]
    want = K5.deform_exact_bwd_reference(*args, kh, kw, stride, dilation)
    torch.cuda.synchronize()
    tol = EXACT_RTOL if args[1].dtype == torch.float32 else BF16_REL_ATOL
    worst = 0.0
    for i, out_name in enumerate(('dx', 'd_offset', 'd_mask')):
        b = want[i]
        if b is None:
            assert all(r[i] is None for r in runs), out_name
            continue
        scale = max(float(b.float().abs().max()), 1e-30)
        for tag, a in (('route', runs[0][i]), ('general', runs[2][i]),
                       ('route vs general', runs[2][i])):
            ref = runs[0][i] if tag == 'route vs general' else b
            assert a.dtype == b.dtype, (out_name, a.dtype, b.dtype)
            d = float((a.float() - ref.float()).abs().max()) / scale
            assert d <= tol, (out_name, tag, route, d, tol)
            worst = max(worst, d)
        if i:
            assert torch.equal(runs[0][i], runs[1][i]), \
                f'K5 {out_name} varies ({route} route)'
            assert torch.equal(runs[2][i], runs[3][i]), \
                f'K5 {out_name} varies (general route)'
    return worst, route


def _exact_cost(torch, x, off, mask, kh, kw, stride, dilation=1):
    """(bytes, flops) of K5 for these inputs: dcols, x, offset and (v2) mask
    read once, dx, d_offset and (v2) d_mask written once, each in its type;
    per channel 2 flops for each corner a sample reads (its weight or a
    derivative not 0: the dot product S) and 2 more for each corner it adds
    to dx (its weight not 0)."""
    from stmask_torch.kernels.deform_exact_bwd import exact_geometry
    _, h, w, cin = x.shape
    rows, cols = exact_geometry(off, h, w, kh, kw, stride, dilation)
    n_s = n_w = 0
    for _, wy, dwy in rows:
        for _, wx, dwx in cols:
            wgt = wy * wx
            n_s += int(((wgt != 0) | (dwy * wx != 0) | (wy * dwx != 0)).sum())
            n_w += int((wgt != 0).sum())
    items = off.numel() // 2
    nbytes = (x.element_size() * (items * cin + 2 * x.numel()
                                  + (2 * items if mask is not None else 0))
              + off.element_size() * 2 * off.numel())
    return nbytes, 2 * cin * (n_s + n_w)


def _exact_sites():
    """(label, H, W, Cin, stride, kh, kw, modulated): the flagship's 7 DCN
    sites (v2) and FCB's 15 (v1) at 384x640."""
    return ([(site, h, w, cin, stride, 3, 3, True)
             for site, (h, w, cin), stride in DCN_SITES]
            + [(f'FCB {h}x{w} {kh}x{kw}', h, w, 256, 1, kh, kw, False)
               for h, w, kh, kw in FCB_SITES])


def _exact_overflow(torch, args, kh, kw, stride) -> float:
    """The share of the (site, tap)s of ``args`` whose block lies outside
    their tile's footprint on K5's fast route (its overflow items)."""
    from stmask_torch.kernels import deform_exact_bwd as K5
    _, x, off, _ = args
    b, h, w, cin = x.shape
    _, ho, wo, _ = off.shape
    plan = K5.exact_bwd_plan(b, ho, wo, cin, kh, kw, stride, 1,
                             x.element_size())
    inside = K5.exact_bwd_inside(off, h, w, kh, kw, stride, 1, plan)
    return 1.0 - float(inside.float().mean())


def _exact_split_sites(torch, dev, entry: str) -> list:
    """(label, arguments of deform_exact_bwd_cuda) of K5's split in the
    types of ``entry`` ('fp32', 'bf16'): the 7 DCN sites (v2) and FCB's
    48x80 3x5 site (v1), 2 * TRAIN_CLIPS frames, N(0, 1.5) offsets."""
    frames = 2 * TRAIN_CLIPS
    out = []
    for i, (site, (h, w, cin), stride) in enumerate(DCN_SITES):
        args = _exact_inputs(torch, dev, h, w, cin, stride, frames, 'random',
                             1600 + i)
        out.append((site, _exact_typed(torch, args, entry) + (3, 3, stride)))
    args = _exact_inputs(torch, dev, 48, 80, 256, 1, frames, 'random', 1610,
                         3, 5)
    out.append(('FCB 48x80 3x5', _exact_typed(torch, args[:3] + (None,),
                                              entry) + (3, 5, 1)))
    return out


def _exact_kernel(torch, dev, smi: str, err: dict) -> dict:
    """Phase 15a: K5 against its plain version at the 7 DCN sites and FCB's
    15 x 8 frames, at EXACT_KINDS' and N(0, 1.5) offsets, with and without
    the mask, in fp32 and both bf16 entries, on the fast route (asserted:
    every site takes it) and on the general route, each against the other
    (_exact_check), with the share of overflow items of each kind; then
    the time of both routes (device, per call, plain) and the bound at
    each site with N(0, 1.5) offsets, v2 at the DCN sites and v1 at FCB's
    (the training step's calls): fp32 and bf16 at both, bf16 with fp32
    offsets at FCB's (_ali's); then the split of both routes of the fp32
    and bf16 entries (kernels/split.py: builds with a part left out)."""
    from stmask_torch.kernels import KERNELS
    from stmask_torch.kernels import deform_exact_bwd as K5
    from stmask_torch.kernels import split as KS
    t_phase = time.perf_counter()
    # the split's variants build while the kernel is checked
    builds = threading.Thread(target=KS.build_variants,
                              args=(KS.EXACT_BWD,))
    builds.start()
    frames = 2 * TRAIN_CLIPS
    entries = ('fp32', 'bf16', 'bf16_f32off')
    kinds = EXACT_KINDS + ('random',)
    worst = {e: 0.0 for e in entries}
    over = {kind: [0.0, 0] for kind in kinds}
    t0 = time.perf_counter()
    for i, (label, h, w, cin, stride, kh, kw, _) in enumerate(
            _exact_sites()):
        shares = {}
        for kind in kinds:
            args = _exact_inputs(torch, dev, h, w, cin, stride, frames, kind,
                                 1500 + i, kh, kw)
            shares[kind] = _exact_overflow(torch, args, kh, kw, stride)
            n_items = args[2].numel() // 2
            over[kind][0] += shares[kind] * n_items
            over[kind][1] += n_items
            for masked in (True, False):
                a_ = args if masked else args[:3] + (None,)
                for e in entries:
                    d, route = _exact_check(torch, _exact_typed(torch, a_, e),
                                            kh, kw, stride)
                    assert route == 'fast', (label, kind, e, route)
                    worst[e] = max(worst[e], d)
            del args, a_
        assert shares['zero'] == 0.0, (label, shares)
        print(f'[K5] {label} x {(frames, h, w, cin)} stride {stride} '
              f'{kh}x{kw}: offsets {"/".join(kinds)} (overflow items '
              f'{" / ".join(f"{shares[k_]:.4f}" for k_ in kinds)}), with and '
              'without the mask, fp32 / bf16 / bf16 with fp32 offsets, the '
              'fast route and the general route against the plain version '
              f'and each other: max|diff| / max|ref| so far '
              f'{worst["fp32"]:.3e} / {worst["bf16"]:.3e} / '
              f'{worst["bf16_f32off"]:.3e} (limits {EXACT_RTOL}, '
              f'{BF16_REL_ATOL:.4f}); d_offset, d_mask bit-identical over '
              'two launches on each route', flush=True)
    names = {'fp32': 'deform_exact_bwd', 'bf16': 'deform_exact_bwd_bf16',
             'bf16_f32off': 'deform_exact_bwd_bf16_f32off'}
    for e, n_ in names.items():
        err[n_] = max(err[n_], worst[e])
    print(f'[K5] the share of overflow items (block outside the tile\'s '
          f'footprint, halo {K5.FAST_HALO}) over the 22 sites: '
          + ', '.join(f'{k_} {o_[0] / o_[1]:.5f}' for k_, o_ in over.items())
          + f'; checks: {time.perf_counter() - t0:.1f} s', flush=True)

    acc = {}
    for i, (label, h, w, cin, stride, kh, kw, v2) in enumerate(
            _exact_sites()):
        args = _exact_inputs(torch, dev, h, w, cin, stride, frames, 'random',
                             1600 + i, kh, kw)
        if not v2:
            args = args[:3] + (None,)
        fcb = label.startswith('FCB')
        for e in (entries if fcb else entries[:2]):
            a_ = _exact_typed(torch, args, e)
            n0 = KERNELS[names[e]].launches

            def fn():
                return K5.deform_exact_bwd_cuda(*a_, kh, kw, stride)
            ms = _device_ms(fn, 20)
            call = _time_ms(fn, 20)
            with _general_route(K5, 'exact_bwd_fast'):
                gen_ms = _device_ms(fn, 20)
            plain = _time_ms(lambda: K5.deform_exact_bwd_reference(
                *a_, kh, kw, stride), 3, warmup=1)
            assert KERNELS[names[e]].launches > n0
            nbytes, flops = _exact_cost(torch, a_[1], a_[2], a_[3], kh, kw,
                                        stride)
            key = names[e] + ('_fcb' if fcb and e != 'bf16_f32off' else '')
            bound, by = _tally(acc.setdefault(key, {}), ms, call, plain,
                               nbytes, flops)
            acc[key]['general_ms'] = acc[key].get('general_ms', 0.0) + gen_ms
            print(f'[K5 time] {names[e]} {label} x {(frames, h, w, cin)} '
                  f'{"v2" if v2 else "v1"}: fast route {ms:.5f} ms (device), '
                  f'per wrapper call {call:.5f} ms, general route '
                  f'{gen_ms:.5f} ms, plain {plain:.5f} ms, bound '
                  f'{bound:.5f} ms ({by}; {nbytes} B, {flops} flop)',
                  flush=True)
        del args
    for key, a_ in acc.items():
        print(f'[K5 time] {key}: sum over the sites: fast route '
              f'{a_["ms"]:.5f} ms (device), per call {a_["call_ms"]:.5f} ms, '
              f'general route {a_["general_ms"]:.5f} ms, plain '
              f'{a_["plain_ms"]:.5f} ms, bound {a_["bound_ms"]:.5f} ms '
              f'({_by_of(a_)}) ({smi})', flush=True)
        assert a_['ms'] < a_['general_ms'], (key, a_)

    # where each entry's time goes on the general route (the design before
    # the fast route) and on the fast one
    builds.join()
    for e, spec in (('fp32', KS.EXACT_BWD_F32), ('bf16', KS.EXACT_BWD)):
        sites = _exact_split_sites(torch, dev, e)
        for route in ('general', 'fast'):
            rows = KS.split(spec, K5, sites, K5.deform_exact_bwd_cuda,
                            lambda fn: _device_ms(fn, 20), route)
            KS.print_split(spec, route, rows, smi,
                           f'{frames} frames, {e} entry')
        del sites
    print(f'[K5] phase 15a: {time.perf_counter() - t_phase:.1f} s',
          flush=True)
    return acc


def _wgrad_far(torch, dev, err: dict) -> None:
    """Phase 15b: deform_wgrad at N(0, 6) offsets (most samples far off the
    image, the rest anywhere) against deform_wgrad_reference: its fast path
    at the 7 DCN sites and FCB's 15 x 8 frames, fp32 and bf16; its general
    path at Cin 48 / Cout 5 and at a DCN site with x one element into its
    buffer; fp32 within WGRAD_RTOL, bf16 within BF16_REL_ATOL of max|ref|,
    bit for bit over two launches."""
    from stmask_torch.kernels import deform_wgrad as KW
    frames = 2 * TRAIN_CLIPS
    cases = [(label, h, w, cin, cin if v2 else 256, stride, kh, kw, v2,
              False) for label, h, w, cin, stride, kh, kw, v2
             in _exact_sites()]
    cases += [('ragged Cin 48 Cout 5', 19, 37, 48, 5, 1, 3, 3, True, False),
              ('ragged Cin 48 Cout 5 stride 2 3x5', 19, 37, 48, 5, 2, 3, 5,
               False, False),
              ('layer2_2, x one element into its buffer', 24, 40, 256, 256,
               1, 3, 3, True, True)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (label, h, w, cin, cout, stride, kh, kw, v2, shift) in enumerate(
            cases):
        _, x, off, mask = _exact_inputs(torch, dev, h, w, cin, stride,
                                        frames, 'normal6', 1700 + i, kh, kw)
        if shift:
            buf = torch.empty(x.numel() + 1, device=dev)
            buf[1:] = x.reshape(-1)
            x = buf[1:].view(x.shape)
        g = torch.Generator(device=dev).manual_seed(1800 + i)
        gg = torch.randn(off.shape[0] * off.shape[1] * off.shape[2], cout,
                         device=dev, generator=g)
        for dt in (torch.float32, torch.bfloat16):
            args = tuple(None if t is None else t.to(dt) for t in (
                gg, x, off, mask if v2 else None))
            if shift and dt == torch.bfloat16:
                buf16 = torch.empty(x.numel() + 1, dtype=dt, device=dev)
                buf16[1:] = x.reshape(-1).to(dt)
                args = (args[0], buf16[1:].view(x.shape)) + args[2:]
            route = 'fast' if KW.wgrad_fast(cin, cout, args[1].data_ptr(),
                                            args[0].data_ptr()) else 'general'
            assert route == ('general' if cin % 32 or cout % 128 or shift
                             else 'fast'), (label, route)
            got = KW.deform_wgrad_cuda(*args, kh, kw, stride)
            again = KW.deform_wgrad_cuda(*args, kh, kw, stride)
            want = KW.deform_wgrad_reference(*args, kh, kw, stride)
            torch.cuda.synchronize()
            scale = max(float(want.float().abs().max()), 1e-30)
            d = float((got.float() - want.float()).abs().max()) / scale
            tol = WGRAD_RTOL if dt == torch.float32 else BF16_REL_ATOL
            assert d <= tol, (label, dt, d)
            assert torch.equal(got, again), (label, dt, 'd_w varies')
            worst[dt] = max(worst[dt], d)
        print(f'[wgrad far] {label} x {(frames, h, w, cin)} Cout {cout} '
              f'{kh}x{kw} stride {stride}, N(0, 6) offsets, {route} path: '
              f'max|diff| / max|ref| fp32 {worst[torch.float32]:.3e} (limit '
              f'{WGRAD_RTOL}), bf16 {worst[torch.bfloat16]:.3e} (limit '
              f'{BF16_REL_ATOL:.4f}) so far; bit-identical over two launches',
              flush=True)
        del x, off, mask, gg
    err['deform_wgrad'] = max(err['deform_wgrad'], worst[torch.float32])
    err['deform_wgrad_bf16'] = max(err['deform_wgrad_bf16'],
                                   worst[torch.bfloat16])


def _exact_train(torch, dev, smi: str, name: str, hosts) -> dict:
    """Phase 15c-d: the training steps through the exact gather at 360x640
    over phase 6's batches, EXACT_STEPS steps each (both window radii 0):
    the flagship and STMask_plus_resnet50_ada in fp32, _ada in remat, bf16
    and bf16 + remat, _ali in bf16 (K5's fp32-offset entry): launches a step
    (EXACT_LAUNCHES), finite losses, gradients on every offset predictor,
    ms/step and peak memory above the first step's start."""
    from stmask_torch.config import get_config
    from stmask_torch.data.transforms import prepare_batch
    from stmask_torch.kernels import KERNELS
    from stmask_torch.models import build_model
    from stmask_torch.train.train_step import build_train_step
    res = {}
    for (cfg_name, mode), per in EXACT_LAUNCHES.items():
        cfg = _radius0(get_config(cfg_name))
        model = build_model(cfg, dev, seed=0)
        kw = {'fp32': {}, 'remat': dict(remat=True),
              'bf16': dict(compute_dtype=torch.bfloat16),
              'bf16_remat': dict(compute_dtype=torch.bfloat16,
                                 remat=True)}[mode]
        step, init = build_train_step(cfg, model, dev, **kw)
        batches = [prepare_batch(cfg, h_, dev) for h_ in hosts[:EXACT_STEPS]]
        state = init()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for k in KERNELS.values():
            k.launches = 0
        ms, metrics = [], []
        for b_ in batches:
            t0 = time.perf_counter()
            state, m = step(state, b_)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
        launches = {n: k.launches for n, k in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated() - base
        want = dict.fromkeys(KERNELS, 0)
        want.update({n_: v * EXACT_STEPS for n_, v in per.items()})
        assert launches == want, (cfg_name, mode, launches, want)
        for m in metrics:
            assert all(np.isfinite(v) for v in m.values()), (cfg_name, m)
        offs = {n: float(p.grad.abs().max())
                for n, p in model.named_parameters()
                if 'conv_offset' in n and p.grad is not None}
        n_off = 2 * len(DCN_SITES) + (
            3 if cfg.use_dcn_class and cfg.use_pred_offset else 0)
        assert len(offs) == n_off and min(offs.values()) > 0, (cfg_name,
                                                                offs)
        print(f'[exact train] {cfg_name} {mode} (both window radii 0), '
              f'{EXACT_STEPS} steps of {TRAIN_CLIPS} clips at '
              f'{cfg.img_h}x{cfg.img_w}: steps {[round(t, 3) for t in ms]} '
              f'ms; peak {peak / 2**20:.1f} MiB above the {base / 2**20:.1f} '
              f'MiB allocated at the first step\'s start; losses '
              f'{metrics[-1]}; launches a step '
              f'{ {n_: v // EXACT_STEPS for n_, v in launches.items() if v} }'
              f' ({name}, {smi})', flush=True)
        res[(cfg_name, mode)] = dict(ms=ms, peak=peak, base=base,
                                     launches=launches)
        del model, step, state, batches
        torch.cuda.empty_cache()
    return res


# ROADMAP C.15: a decision that the card and the CPU take apart must lie
# this close to its boundary on both (a tie that summation order tips:
# 2.98e-7 and 8.34e-7 in the runs that classified it)
DECISION_MARGIN = 2e-6


def _c15_decisions(torch, dev) -> None:
    """ROADMAP C.15: the discrete decisions of the backbone's training
    forward of STMask_plus_resnet50_ada at 96x128 (seed 0, _train_step_vs
    _cpu's batch) that the card and the CPU take apart: ReLU inputs of
    opposite sign (each bottleneck's three ReLUs) and DCN offsets whose
    K4 cell differs (floor of the clamped offset, on an integer or not,
    clamped or not), printed per block; each must lie within
    DECISION_MARGIN of its boundary on both devices."""
    from stmask_torch.config import get_config
    from stmask_torch.data.transforms import prepare_batch
    from stmask_torch.models import build_model
    from stmask_torch.models.backbone import Bottleneck, DCNConv
    small = get_config('STMask_plus_resnet50_ada').replace(img_h=96,
                                                          img_w=128)
    host = _train_batch(small, 99, clips=1)
    r = small.backbone.dcn_window_radius
    seen = []
    for d_ in (torch.device('cpu'), dev):
        mdl = build_model(small, d_, seed=0).train()
        mdl.to(memory_format=torch.channels_last)   # as build_train_step
        rec, hooks = {}, []
        for bname, blk in mdl.backbone.named_modules():
            if not isinstance(blk, Bottleneck):
                continue

            def keep(key):
                def hook(mod, inp, out):
                    rec[key] = out.detach().float().cpu()
                return hook
            hooks.append(blk.bn1.register_forward_hook(keep(f'{bname} relu1')))
            hooks.append(blk.bn2.register_forward_hook(keep(f'{bname} relu2')))

            hooks.append(blk.bn3.register_forward_hook(keep(f'{bname} bn3')))
            if blk.downsample is not None:
                hooks.append(blk.downsample.register_forward_hook(
                    keep(f'{bname} residual')))

            def relu3(mod, inp, out, bname=bname):
                res = rec.pop(f'{bname} residual', None)
                res = inp[0].detach().float().cpu() if res is None else res
                rec[f'{bname} relu3'] = rec.pop(f'{bname} bn3') + res
            hooks.append(blk.register_forward_hook(relu3))
            if isinstance(blk.conv2, DCNConv):
                hooks.append(blk.conv2.conv_offset_mask.register_forward_hook(
                    keep(f'{bname} offsets')))
        with torch.no_grad():
            mdl(prepare_batch(small, host, d_)['images'], train=True)
        for h_ in hooks:
            h_.remove()
        seen.append(rec)
        del mdl
    cpu, card = seen
    for key in cpu:
        a, b = cpu[key], card[key]
        if key.endswith('offsets'):
            a = a.permute(0, 2, 3, 1)[..., :18].clamp(-r, r)
            b = b.permute(0, 2, 3, 1)[..., :18].clamp(-r, r)
            cell = [(torch.floor(t), t == torch.floor(t), t.abs() >= r)
                    for t in (a, b)]
            apart = ((cell[0][0] != cell[1][0]) | (cell[0][1] != cell[1][1])
                     | (cell[0][2] != cell[1][2]))
            near = torch.maximum((a - a.round()).abs(), (b - b.round()).abs())
        else:
            apart = (a > 0) != (b > 0)
            near = torch.maximum(a.abs(), b.abs())
        n = int(apart.sum())
        assert n == 0 or float(near[apart].max()) <= DECISION_MARGIN, (
            key, float(near[apart].max()))
        if n:
            print(f'[C.15] {key}: {n} of {a.numel()} decisions apart '
                  f'between the card and the CPU; the CPU\'s values there '
                  f'{[round(float(v), 9) for v in a[apart][:6]]}, the '
                  f'card\'s {[round(float(v), 9) for v in b[apart][:6]]} '
                  f'(limit {DECISION_MARGIN} from the boundary)', flush=True)
    print('[C.15] decisions compared: every bottleneck\'s three ReLUs and '
          'every DCN site\'s window offsets; those apart are ties',
          flush=True)


def _exact_vs_cpu(torch, dev, c15_r2: dict) -> dict:
    """Phase 15c: the radius-0 training steps on the card against the CPU
    path at 96x128, full depth, at _train_step_vs_cpu's limits: the
    flagship with dcn_window_radius 0, and STMask_plus_resnet50_ada with
    fcb_window_radius 0.  Then ROADMAP C.15's third run: _ada at FCB's
    radius 2 with its conv_offset scaled by 1/4 on both devices, so that no
    FCB offset reaches +-2 (asserted: none is clamped); printed beside
    phase 9's radius-2 comparison and the radius-0 one (the five worst
    parameters each), not held; then the decisions the two devices take
    apart (_c15_decisions)."""
    from stmask_torch.config import get_config
    from stmask_torch.models.heads import FeatureAlign
    flag = get_config('STMask_plus_resnet50')
    ada = get_config('STMask_plus_resnet50_ada')
    out = {'flagship_r0': _train_step_vs_cpu(
        torch, dev, _radius0(flag), 'radius-0 flagship ')}
    out['ada_fcb_r0'] = _train_step_vs_cpu(
        torch, dev, _radius0(ada, fcb_only=True), 'FCB radius-0 _ada ')

    largest = []

    def nudge(model):
        for m in model.modules():
            if isinstance(m, FeatureAlign):
                with torch.no_grad():
                    m.conv_offset.weight.mul_(0.25)
                m.conv_offset.register_forward_hook(
                    lambda mod, inp, o: largest.append(
                        float(o.detach().abs().max())))
    out['ada_r2_nudged'] = _train_step_vs_cpu(
        torch, dev, ada, 'C.15 nudged _ada ', prepare=nudge, hold=False)
    print(f'[C.15] nudged _ada: largest |FCB offset| {max(largest):.4f} '
          f'(window radius {ada.fcb_window_radius}: none clamped)',
          flush=True)
    assert max(largest) < ada.fcb_window_radius, max(largest)
    out['ada_r2'] = c15_r2
    _c15_decisions(torch, dev)
    for tag in ('ada_r2', 'ada_fcb_r0', 'ada_r2_nudged', 'flagship_r0'):
        rel = out[tag]
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
        print(f'[C.15] {tag}: five worst parameters (card vs CPU, relative '
              f'L2) {[(n, round(v, 6)) for n, v in worst]}', flush=True)
    return out


# phase 16: the lane axis and the scan.  The chunk's lanes: 6 videos from
# step 0, one video of 2 frames then a new one from step 2 (is_first
# mid-chunk), and an idle lane (zero frames, as the eval CLI feeds it)
LANE_CHUNK = 4
LANE_RESTART, LANE_IDLE = 6, 7
# box, score and mask of a step of the lane axis against the per-lane
# wrappers from the same state.  On the CPU the two are bit for bit the
# same; on the card cuBLAS and cuDNN sum the batched products (RoIAlign's
# contractions, the TemporalNet, the masks' lincomb) in another order
# than the one-lane ones, and the random TemporalNet and prototypes grow
# that: box 3.8e-5 and mask 4.0e-5 on an H100 (with the TemporalNet at
# the lane axis's batch too: box 3.8e-5, mask 2.1e-5), past 1e-5.  Held
# at the tolerances tests/test_torch_eval_batched.py holds the batched
# step to against JAX; scores (gathered) at 1e-5
LANE_ATOL = {'box': 1e-4, 'score': 1e-5, 'mask': 1e-3}
SCAN_CHUNK = 6                  # build_video_scan over phase 4's videos
# the lane loop's eval CLI chunk (bf16, 8 x 4) as PERF.md section 5
# records it: device busy ms, wall ms, launches a frame
LANE_LOOP_CLI = (118.933, 435.551, 658.9)


def _lane_chunk_inputs(cfg):
    """[K, B] uint8 frames and is_first of phase 16c's chunk."""
    k, b = LANE_CHUNK, EVAL_LANES
    frames = np.zeros((k, b, cfg.img_h, cfg.img_w, 3), np.uint8)
    first = np.zeros((k, b), bool)
    for lane in range(b):
        if lane == LANE_IDLE:
            continue
        clip = _synthetic_clip(cfg.img_h, cfg.img_w, k, seed=160 + lane)
        if lane == LANE_RESTART:
            new = _synthetic_clip(cfg.img_h, cfg.img_w, 2, seed=170)
            clip = np.concatenate([clip[:2], new])
            first[2, lane] = True
        frames[:, lane] = clip
        first[0, lane] = True
    return frames, first


def _lane_axis(torch, dev, smi: str, name: str, clips, err: dict) -> dict:
    """Phase 16: the lane axis and the scan on the card.  (a) K1 at [8, 24,
    40, 256] fp32 and bf16 (the fast route asserted) against its plain
    version and against 8 launches of one lane each, bit for bit; (b) B5's
    boxes entry at G = 8 x 40 over lane-offset indices into [8 * P, 4]
    boxes against its plain version and against 8 launches of one lane's
    40 classes, bit for bit; (c) one fp32 8-lane 4-frame chunk of the
    flagship (a lane that starts a new video mid-chunk, an idle lane)
    through build_video_step_batched, and the lane-batched detect +
    tracker against the per-lane wrappers applied lane by lane (the lane
    loop) to the same forward outputs; (d) the chunk's launches a step;
    (e) device busy ms and launches of a chunk under torch.profiler,
    lane axis beside lane loop in this run; (f) build_video_scan over
    phase 4's videos in chunks of 6 against build_video_step, bit for
    bit."""
    from stmask_torch.config import get_config
    from stmask_torch.inference import build_video_scan, build_video_step
    from stmask_torch.inference.candidates import detect_frame
    from stmask_torch.inference.pipeline import (build_video_step_batched,
                                                 detect_and_rescore,
                                                 normalize_pad)
    from stmask_torch.inference.tracker import (TrackState, track_step_tf,
                                                track_step_tf_lanes)
    from stmask_torch.kernels import KERNELS
    from stmask_torch.kernels import correlation as K1
    from stmask_torch.kernels import greedy_nms as KG
    from stmask_torch.models import build_model
    from stmask_torch.ops.anchors import all_priors
    from stmask_torch.ops.nms import NEG_INF, _top_k_padded
    from stmask_torch.ops.roi_align import roi_align

    t_phase = time.perf_counter()
    cfg = get_config('STMask_plus_resnet50')
    b = EVAL_LANES
    res = {}

    # (a) K1 over the lanes
    g = torch.Generator(device=dev).manual_seed(16)
    x1 = torch.randn(b, 24, 40, 256, device=dev, generator=g)
    x2 = torch.randn(b, 24, 40, 256, device=dev, generator=g)
    for kname, dt in (('correlation', torch.float32),
                      ('correlation_bf16', torch.bfloat16)):
        a1, a2 = x1.to(dt), x2.to(dt)
        if dt == torch.bfloat16:
            assert K1.corr_fast(256, a1.data_ptr(), a2.data_ptr())
        got = K1.correlate_cuda(a1, a2, 11)
        want = K1.correlate_reference(a1, a2, 11)
        lanes = torch.cat([K1.correlate_cuda(a1[i:i + 1], a2[i:i + 1], 11)
                           for i in range(b)])
        torch.cuda.synchronize()
        d = float((got - want).abs().max())
        err[kname] = max(err[kname], d)
        print(f'[lanes] K1 {kname} [{b},24,40,256] patch 11: max|diff| '
              f'{d:.3e} against the plain version (atol 1e-5, rtol 1e-5); '
              f'bit for bit {b} launches of one lane each', flush=True)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        assert torch.equal(got, lanes), kname

    # (b) B5's boxes entry over lane-offset indices: boxes clustered around
    # a few centres a lane (so that suppression happens), the eval path's
    # P, 40 classes and nms_top_k 200
    p, c, k = cfg.num_priors, cfg.num_classes - 1, cfg.nms_top_k
    gen = torch.Generator(device=dev).manual_seed(17)
    ctr = torch.rand(b, 12, 2, device=dev, generator=gen) * 0.8 + 0.1
    pick = torch.randint(0, 12, (b, p), device=dev, generator=gen)
    cxy = torch.gather(ctr, 1, pick[..., None].expand(-1, -1, 2)) + \
        torch.randn(b, p, 2, device=dev, generator=gen) * 0.01
    wh = 0.05 + torch.rand(b, p, 2, device=dev, generator=gen) * 0.1
    boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], dim=-1)      # [B, P, 4]
    scores = torch.rand(b, c, p, device=dev, generator=gen) ** 4
    masked = torch.where(scores > cfg.nms_conf_thresh, scores, NEG_INF)
    top, idx = _top_k_padded(masked, k)                          # [B, C, K]
    valid = top > NEG_INF / 2
    off = torch.arange(b, device=dev).reshape(b, 1, 1) * p
    scale = float(max(cfg.pad_w, cfg.pad_h))
    args = (boxes.reshape(-1, 4).contiguous(),
            (idx + off).reshape(b * c, k).contiguous(),
            valid.reshape(b * c, k).contiguous(), scale, cfg.nms_thresh)
    n0 = KG.KERNEL_BOXES.launches
    got = KG.greedy_nms_boxes_cuda(*args)
    assert KG.KERNEL_BOXES.launches == n0 + 1
    want = KG.greedy_nms_plus_one_reference(*args)
    lanes = torch.cat([KG.greedy_nms_boxes_cuda(
        boxes[i].contiguous(), idx[i].contiguous(), valid[i].contiguous(),
        scale, cfg.nms_thresh) for i in range(b)])
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    err['greedy_nms_boxes'] = max(err['greedy_nms_boxes'], float(n_diff))
    kept, cand = int(got.sum()), int(valid.sum())
    print(f'[lanes] B5 greedy_nms_boxes G {b} x {c} = {b * c}, K {k}, '
          f'boxes [{b} x {p}, 4] with lane-offset indices: {n_diff} keep '
          f'flags differ from the plain version, {kept} kept of {cand} '
          f'valid candidates; bit for bit {b} launches of one lane\'s {c} '
          'classes', flush=True)
    assert n_diff == 0 and torch.equal(got, lanes) and 0 < kept < cand

    # (c) one fp32 chunk: the lane axis against the lane loop
    model = build_model(cfg, dev, seed=0)
    chunk, make_states = build_video_step_batched(
        cfg, model, b, LANE_CHUNK, uint8_input=True, device=dev)
    frames_np, first_np = _lane_chunk_inputs(cfg)
    frames = torch.from_numpy(frames_np).to(dev)
    first = torch.from_numpy(first_np).to(dev)
    torch.cuda.synchronize()
    for kk in KERNELS.values():
        kk.launches = 0
    states, outs = chunk(make_states(), frames, first)
    torch.cuda.synchronize()
    launches = {n: kk.launches for n, kk in KERNELS.items()}
    next_ids = states.next_id.tolist()

    priors = torch.as_tensor(all_priors(cfg), device=dev)
    x = normalize_pad(cfg, frames)
    keys = ('loc', 'conf', 'mask_coeff', 'track', 'centerness')
    # each step of the lane axis against the per-lane wrappers from the
    # same state (held), with the TemporalNet at the lane axis's batch and
    # at the lane's own; and against the lane loop along its own
    # trajectory (printed: the random TemporalNet, fed back its own
    # shifted boxes, grows the rounding differences step by step)
    fields = ('box', 'score', 'mask')
    s_cap = min(cfg.shift_capacity, cfg.track_capacity)
    worst = dict.fromkeys(fields, 0.0)
    worst_net = dict.fromkeys(fields, 0.0)
    # the batched products alone, on this run's card: the TemporalNet over
    # B * S rows against one lane's S, RoIAlign over B lanes against one
    with torch.inference_mode():
        pooled = torch.relu(torch.randn(b * s_cap, 7, 7, 633, device=dev,
                                        generator=g))
        nets = (model.temporal_shift(pooled),
                model.temporal_shift(pooled[:s_cap]))
        net_d = [float((a[:s_cap] - o).abs().max()) for a, o in zip(*nets)]
        feats = torch.randn(b, 24, 40, 633, device=dev, generator=g)
        lo = torch.rand(b, s_cap, 2, device=dev, generator=g) * 16
        rboxes = torch.cat([lo, lo + 2 + torch.rand(
            b, s_cap, 2, device=dev, generator=g) * 8], dim=-1)
        roi_d = float((roi_align(feats, rboxes)[0]
                       - roi_align(feats[0], rboxes[0])).abs().max())
    print(f'[lanes] 16c batched against one lane on the card: the '
          f'TemporalNet over {b} x {s_cap} rows against {s_cap}, max|diff| '
          f'box shift {net_d[0]:.3e}, coefficient shift {net_d[1]:.3e}; '
          f'RoIAlign over {b} lanes against one, {roi_d:.3e}', flush=True)
    drift = [dict.fromkeys(fields, 0.0) for _ in range(LANE_CHUNK)]
    flips = 0
    lane_state = make_states()
    singles = [TrackState(*(f[i] for f in lane_state)) for i in range(b)]
    n_kept = 0

    def diff(a, w, fld):
        return float((getattr(a, fld) - getattr(w, fld)).abs().max())

    def net_at_lane(i):
        """The TemporalNet over lane i's S rows inside B * S rows."""
        def fn(pooled):
            buf = pooled.new_zeros((b * s_cap,) + tuple(pooled.shape[1:]))
            buf[i * s_cap:(i + 1) * s_cap] = pooled
            return tuple(t[i * s_cap:(i + 1) * s_cap]
                         for t in model.temporal_shift(buf))
        return fn

    with torch.inference_mode():
        for step in range(LANE_CHUNK):
            preds = model(x[step])
            det = detect_and_rescore(cfg, model, preds, priors)
            prev = lane_state
            lane_state, lane_out = track_step_tf_lanes(
                cfg, model.temporal_shift, prev, det, preds['proto'],
                preds['fpn_feat'], preds['T2S_feat'], first[step])
            for f, (a, o) in enumerate(zip(lane_out, outs)):
                assert torch.equal(a, o[step]), ('chunk', step, f)
            for i in range(b):
                one = detect_frame(cfg, {kk: preds[kk][i] for kk in keys},
                                   priors, proto=preds['proto'][i])
                args = (one, preds['proto'][i], preds['fpn_feat'][i],
                        preds['T2S_feat'][i], first[step, i])
                got = type(lane_out)(*(t[i] for t in lane_out))
                lane_prev = TrackState(*(f[i] for f in prev))
                for net, acc in ((net_at_lane(i), worst),
                                 (model.temporal_shift, worst_net)):
                    _, want = track_step_tf(cfg, net, lane_prev, *args)
                    for fld in ('obj_id', 'keep', 'cls'):
                        assert torch.equal(getattr(got, fld),
                                           getattr(want, fld)), (step, i, fld)
                    for fld in fields:
                        acc[fld] = max(acc[fld], diff(got, want, fld))
                n_kept += int(want.keep.sum())
                singles[i], loop = track_step_tf(
                    cfg, model.temporal_shift, singles[i], *args)
                flips += sum(int((getattr(got, fld) != getattr(loop, fld))
                                 .sum()) for fld in ('obj_id', 'keep', 'cls'))
                for fld in fields:
                    drift[step][fld] = max(drift[step][fld],
                                           diff(got, loop, fld))
    print(f'[lanes] 16c fp32 chunk of {b} lanes x {LANE_CHUNK} frames (lane '
          f'{LANE_RESTART} starts a new video at step 2, lane {LANE_IDLE} '
          f'idle): each step of the lane axis against the per-lane wrappers '
          f'lane by lane from the same state and forward outputs: obj_id, '
          f'keep and cls equal; max|diff| with the TemporalNet at the lane\'s '
          f'own {s_cap} rows: box {worst_net["box"]:.3e}, score '
          f'{worst_net["score"]:.3e}, mask {worst_net["mask"]:.3e}; at the '
          f'lane axis\'s batch: box {worst["box"]:.3e}, score '
          f'{worst["score"]:.3e}, mask {worst["mask"]:.3e} (atol '
          f'{LANE_ATOL}); {n_kept} kept tracks; the lanes\' next ids after '
          f'the chunk {next_ids}; the chunk\'s outputs equal the functions\' '
          'bit for bit', flush=True)
    print('[lanes] 16c the lane loop along its own trajectory, max|diff| a '
          'step (box, score, mask): ' + '; '.join(
              f'{d["box"]:.3e}, {d["score"]:.3e}, {d["mask"]:.3e}'
              for d in drift) + f'; {flips} obj_id / keep / cls entries '
          'differ', flush=True)
    for acc in (worst, worst_net):
        assert all(acc[f] <= LANE_ATOL[f] for f in fields), acc
    assert n_kept > 0
    for t in outs:
        if t.is_floating_point():
            assert bool(torch.isfinite(t).all())

    # (d) launches a step
    want = dict.fromkeys(KERNELS, 0)
    want.update(deform_conv=_dcn_sites(cfg) * LANE_CHUNK,
                correlation=LANE_CHUNK)
    print(f'[lanes] 16d launches of the chunk: {launches}; a step: '
          f'deform_conv {launches["deform_conv"] // LANE_CHUNK}, correlation '
          f'{launches["correlation"] // LANE_CHUNK} (the lane loop launched '
          f'K1 {b} times a step)', flush=True)
    assert launches == want, (launches, want)

    # (e) a steady chunk's device time and launches under torch.profiler:
    # the lane axis, then the lane loop (the network once on all lanes, then
    # detect and track lane by lane through the per-lane wrappers, the
    # design before the lane axis) on the same frames
    def lane_loop():
        nonlocal singles
        with torch.inference_mode():
            for step in range(LANE_CHUNK):
                preds = model(x[step])
                for i in range(b):
                    one = detect_frame(cfg, {kk: preds[kk][i] for kk in keys},
                                       priors, proto=preds['proto'][i])
                    singles[i], _ = track_step_tf(
                        cfg, model.temporal_shift, singles[i], one,
                        preds['proto'][i], preds['fpn_feat'][i],
                        preds['T2S_feat'][i], first[step, i])

    def lane_axis():
        nonlocal states
        states, _ = chunk(states, frames, first)

    prof = {}
    for tag, fn in (('lane axis', lane_axis), ('lane loop', lane_loop)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rows = _device_events(fn, 1)
        busy = sum(us for _, _, us in rows) / 1e3 if rows else None
        n_kern = sum(cnt for _, cnt, _ in rows) if rows else None
        prof[tag] = dict(wall_ms=wall, busy_ms=busy, launches=n_kern)
        if rows:
            print(f'[lanes] 16e {tag}, fp32 chunk of {b} x {LANE_CHUNK}: '
                  f'device busy {busy:.3f} ms of {wall:.3f} ms wall (idle '
                  f'share {1 - busy / wall:.3f}), {n_kern} kernel launches '
                  f'({n_kern / (b * LANE_CHUNK):.1f} a lane-frame) '
                  f'({name}, {smi})', flush=True)
        else:
            print(f'[lanes] 16e {tag}: torch.profiler recorded no device '
                  f'time: device busy ms not measured; {wall:.3f} ms wall',
                  flush=True)
    print(f'[lanes] 16e beside the lane loop\'s eval CLI chunk in PERF.md '
          f'section 5: bf16 8 x 4, busy {LANE_LOOP_CLI[0]} ms of '
          f'{LANE_LOOP_CLI[1]} ms wall, {LANE_LOOP_CLI[2]} launches a frame '
          '(phase 7 prints the lane axis\'s)', flush=True)
    res['chunk'] = dict(launches=launches, worst=worst, prof=prof)
    del chunk, states, outs, lane_state, singles

    # (f) the scan against the step over phase 4's videos and the first
    # two frames of video 0 again (a third video), in chunks of 6
    stream = [(v, f) for v, clip in enumerate(clips)
              for f in range(len(clip))] + [(0, 0), (0, 1)]
    assert len(stream) % SCAN_CHUNK == 0
    scan, make_state = build_video_scan(cfg, model, chunk_size=SCAN_CHUNK,
                                        uint8_input=True, device=dev)
    step, make_one = build_video_step(cfg, model, uint8_input=True,
                                      device=dev)
    state, got = make_state(), []
    n_span = 0
    for c0 in range(0, len(stream), SCAN_CHUNK):
        part = stream[c0:c0 + SCAN_CHUNK]
        n_span += any(f == 0 for _, f in part[1:])
        state, out = scan(state, np.stack([clips[v][f] for v, f in part]),
                          np.array([f == 0 for _, f in part]))
        got.extend(type(out)(*(t[j] for t in out))
                   for j in range(SCAN_CHUNK))
    n_kept = 0
    for (v, f), o in zip(stream, got):
        one = make_one() if f == 0 else one
        one, want = step(one, clips[v][f], f == 0)
        for fld, a, w in zip(want._fields, o, want):
            assert torch.equal(a, w), ('scan', v, f, fld)
        n_kept += int(want.keep.sum())
    print(f'[lanes] 16f build_video_scan, {len(stream)} frames in chunks of '
          f'{SCAN_CHUNK} ({n_span} chunks span a video boundary) against '
          f'build_video_step: every field bit for bit, {n_kept} kept tracks; '
          f'phase 16 took {time.perf_counter() - t_phase:.1f} s', flush=True)
    assert n_span >= 2 and n_kept > 0
    del model, scan, step
    torch.cuda.empty_cache()
    return res


# phase 17: the scripts on the card (stmask_torch/scripts/), each run in
# process through its run(); the form of what each prints is checked
SCRIPT_CHUNK = (8, 4)        # trace_step --chunked: streams, frames a chunk


def _script_out(fn, *args, **kw):
    """(fn's result, what it printed); the first 14 lines of the print are
    echoed with a ``[scripts]`` prefix."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    text = buf.getvalue()
    for ln in text.splitlines()[:14]:
        print(f'[scripts]   {ln[:150]}')
    return res, text


def _names(rows, pat: str):
    return [(n, c) for n, c, _ in rows if re.search(pat, n)]


def _scripts_phase(torch, dev, smi: str, tmp: str) -> dict:
    """Phase 17: (a) mfu: the FLOP count of one flagship fp32 video step at
    384x640 and of one fp32 training step of 1 clip at 96x128, on the card
    (the kernels) and on the CPU (their plain versions), equal exactly; the
    three programs' rows, mfu_pct in (0, 100]; (b) trace_step, one-frame
    and --chunked --streams 8 --chunk 4: the table names the fused conv
    and K1, and K1 launches once a step in the chunked run; (c)
    trace_train --bf16: the table names deform_wgrad, K4 and K3; (d)
    profile_step: four positive times, forward <= full step; (e) bench_dcn
    at fp32 and bf16, 5 repeats: 7 rows; (f) dcn_clip_rate, one batch: every
    share 0 at the seeded flax-like init, a share for each of the 7 sites
    with --mirror; (g) parity_run --dryrun at 96x128: both JSONs and the
    table."""
    from stmask_torch.config import get_config
    from stmask_torch.scripts import (bench_dcn, dcn_clip_rate, mfu,
                                      parity_run, profile_step, trace_step,
                                      trace_train)
    from stmask_torch.scripts._common import frame_call, train_call
    from stmask_torch.utils import flops
    cfg = get_config('STMask_plus_resnet50')
    small = cfg.replace(img_h=96, img_w=128)
    out = {}
    t0 = time.perf_counter()

    # (a) the count, kernels against plain versions, then the rows
    cpu = torch.device('cpu')
    for tag, build in (
            ('video step 384x640 fp32',
             lambda d: frame_call(cfg, d)),
            ('train step 1 clip 96x128 fp32',
             lambda d: train_call(small, d, 1, bf16=False))):
        _, card = flops.count(build(dev))
        _, host = flops.count(build(cpu))
        print(f'[scripts] mfu count, {tag}: card {card.flops} FLOPs, cpu '
              f'{host.flops} FLOPs; card by op {card.flops_by_op}',
              flush=True)
        assert card.flops == host.flops > 0, (tag, card, host)
        assert card.flops_by_op == host.flops_by_op, tag
        out[f'count {tag}'] = card.flops
    rows, text = _script_out(mfu.run, cfg, dev, repeats=3)
    assert len(rows) == 3 and text.count(' | ') >= 40, text[-2000:]
    for r in rows:
        assert 0 < r['mfu_pct'] <= 100 and 0 < r['hbm_pct'] <= 100, r
        print(f'[scripts] mfu {r["program"]}: {r["ms_per_call"]:.3f} ms, '
              f'{r["gflops_per_call"]:.3f} GFLOP/call, '
              f'{r["gflops_per_frame"]:.3f} GFLOP/frame, '
              f'{r["achieved_tflops"]:.3f} TFLOP/s, mfu {r["mfu_pct"]:.3f}% '
              f'of {r["peak_tflops"]:g}, {r["bytes_per_call_mb"]:.1f} MB '
              f'(counted ops), hbm {r["hbm_pct"]:.3f}%, '
              f'{r["arith_intensity"]:.1f} FLOP/B (ridge '
              f'{r["ridge_flop_per_byte"]:.1f}), {r["bound"]}-bound ({smi})',
              flush=True)
    out['mfu'] = rows
    print(f'[scripts] (a) {time.perf_counter() - t0:.1f} s', flush=True)

    # (b) trace_step
    res, text = _script_out(trace_step.run, cfg, dev)
    assert 'frames profiled' in text and 'idle shares' in text
    assert _names(res['rows'], r'deform_conv') and \
        _names(res['rows'], r'correlation(_bf16_fast)?_kernel'), res['rows']
    streams, chunk = SCRIPT_CHUNK
    (res, text), launches = _counted(
        torch, lambda: _script_out(trace_step.run, cfg, dev, chunked=True,
                                   streams=streams, chunk=chunk))
    steps = 6 * chunk                 # 2 chunks before the window, 4 in it
    k1 = launches['correlation_bf16'] + launches['correlation']
    k1_rows = _names(res['rows'], r'correlation(_bf16_fast)?_kernel')
    print(f'[scripts] trace_step --chunked: {k1} K1 launches over {steps} '
          f'steps of {streams} lanes; profiler rows {k1_rows}; '
          f'{res["ms_per_frame"]:.4f} device ms a frame, idle {res["idle"]}',
          flush=True)
    assert k1 == steps and k1_rows and _names(res['rows'], r'deform_conv')
    out['trace_step_chunked_ms_per_frame'] = res['ms_per_frame']
    out['trace_step_chunked_idle'] = res['idle']

    # (c) trace_train --bf16
    res, text = _script_out(trace_train.run, cfg, dev, bf16=True)
    for pat in (r'deform_wgrad', r'deform_col2im', r'correlation_bwd'):
        assert _names(res['rows'], pat), (pat, res['rows'][:40])
    print(f'[scripts] trace_train --bf16: {res["step_ms"]:.3f} ms a step; '
          'host ms a step by range ' + ', '.join(
              f'{k} {v[0] / trace_train.STEPS:.3f}'
              for k, v in sorted(res['ranges'].items())), flush=True)
    out['trace_train_bf16_step_ms'] = res['step_ms']
    out['trace_train_bf16_ranges'] = {
        k: v[0] / trace_train.STEPS for k, v in res['ranges'].items()}

    # (d) profile_step
    res, _ = _script_out(profile_step.run, cfg, dev)
    assert all(v > 0 for v in res.values()) and len(res) == 4, res
    assert res['forward'] <= res['full_step'], res
    out['profile_step'] = res
    print(f'[scripts] (b-d) {time.perf_counter() - t0:.1f} s', flush=True)

    # (e) bench_dcn
    for dtype in ('f32', 'bf16'):
        res, text = _script_out(bench_dcn.run, dev, dtype, repeats=5)
        assert len(res) == 7 and 'maxdiff=' in text and \
            'max |exact - window|' in text, text
        out[f'bench_dcn_{dtype}'] = res

    # (f) dcn_clip_rate
    data = os.path.join(tmp, 'overfit')
    for mirror in (False, True):
        model, source = dcn_clip_rate.load_model(cfg, dev, mirror=mirror)
        res, text = _script_out(
            dcn_clip_rate.run, cfg, model,
            dcn_clip_rate.loader_batches(cfg, data, 1), dev, source)
        assert len(res) == 7 and 'worst_clip_pct' in text, text
        if not mirror:
            assert all(r['clip_pct'] == 0 for r in res), res
        out[f'clip_rate_{source}'] = {r['site']: r['clip_pct'] for r in res}
        print(f'[scripts] dcn_clip_rate {source}: ' + ', '.join(
            f'{r["site"]} {r["clip_pct"]:.4f}% (max {r["max_abs"]:.3f}, '
            f'p99 {r["p99"]:.3f})' for r in res), flush=True)
        del model

    # (g) parity_run --dryrun
    par = os.path.join(tmp, 'parity')
    (res, text) = _script_out(parity_run.main, [
        '--dryrun', '--img_h', '96', '--img_w', '128', '--out_dir', par])
    for f in ('results_cc.json', 'results_per_class.json',
              'parity_summary.json'):
        assert os.path.getsize(os.path.join(par, f)) > 2, f
    assert res == 0 and 'measured  baseline' in text, text[-2000:]
    out['seconds'] = time.perf_counter() - t0
    print(f'[scripts] phase 17: {out["seconds"]:.1f} s', flush=True)
    return out


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

    t_script = time.perf_counter()

    def mark(phase) -> None:
        print(f'[phase] {phase} at {time.perf_counter() - t_script:.1f} s',
              flush=True)

    dev = resolve_device('cuda')            # also turns TF32 off
    smi = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {name} ({smi})', flush=True)

    # ---- 1. build ---------------------------------------------------------
    mark(1)
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
    # the fused conv's bf16 fast route (not its general route's kernels)
    entry, fast = '', []
    for ln in build.ptxas_report('deform_conv'):
        if 'entry function' in ln:
            entry = ln
        elif 'spill' in ln and 'fast_kernel' in entry:
            fast.append(ln)
    assert len(fast) == 4 and all(
        re.search(r'(^|\s)0 bytes spill stores, 0 bytes spill loads', ln)
        for ln in fast), fast
    # K4's bf16 fast route: both instantiations (bf16 and fp32 offsets)
    entry, fast = '', []
    for ln in build.ptxas_report('deform_col2im'):
        if 'entry function' in ln:
            entry = ln
        elif 'spill' in ln and 'bf16_fast_kernel' in entry:
            fast.append(ln)
    assert len(fast) == 2 and all(
        re.search(r'(^|\s)0 bytes spill stores, 0 bytes spill loads', ln)
        for ln in fast), fast
    # K5's fast route: its three instantiations (fp32, bf16, bf16 with fp32
    # offsets)
    entry, fast = '', []
    for ln in build.ptxas_report('deform_exact_bwd'):
        if 'entry function' in ln:
            entry = ln
        elif 'spill' in ln and 'fast_kernel' in entry:
            fast.append(ln)
    assert len(fast) == 3 and all(
        re.search(r'(^|\s)0 bytes spill stores, 0 bytes spill loads', ln)
        for ln in fast), fast

    # ---- 2. the frame resize against cv2, then K1 vs plain ----------------
    mark(2)
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
    # so only the order of the fp32 sum differs.  C a multiple of 8 with
    # aligned maps takes the fast route (the eval shape must), C 5 and a
    # map one element into its buffer the general one; a second launch
    # gives the same bits.
    for shape, patch, off in (((1, 24, 40, 256), 11, 0),
                              ((2, 7, 9, 96), 11, 0), ((2, 7, 9, 96), 5, 0),
                              ((1, 5, 70, 40), 11, 0), ((1, 3, 2, 5), 11, 0),
                              ((1, 24, 40, 256), 11, 1)):
        n_el = int(np.prod(shape))
        buf = torch.randn(n_el + 1, device=dev, generator=g).bfloat16()
        x1 = buf[off:off + n_el].view(shape)
        x2 = torch.randn(shape, device=dev, generator=g).bfloat16()
        route = ('fast' if K1.corr_fast(shape[-1], x1.data_ptr(),
                                        x2.data_ptr()) else 'general')
        assert route == ('fast' if shape[-1] % 8 == 0 and off == 0
                         else 'general'), (shape, off, route)
        got = K1.correlate_cuda(x1, x2, patch)
        again = K1.correlate_cuda(x1, x2, patch)
        want = K1.correlate_reference(x1, x2, patch)
        torch.cuda.synchronize()
        d = float((got - want).abs().max())
        err['correlation_bf16'] = max(err['correlation_bf16'], d)
        print(f'[K1 bf16] correlation {shape} patch {patch}'
              f'{" (x1 one element into its buffer)" if off else ""}, '
              f'{route} route: max|diff| {d:.3e} (atol 1e-5, rtol 1e-5), '
              'bit-identical over two launches', flush=True)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        assert torch.equal(got, again), (shape, 'K1 bf16 varies')

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
    mark(3)
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
    # eval), then ragged channels, v1, no bias, 3x5 and dilation 2; each
    # call's route printed (the 7 sites and the 3x5 take the fast one, the
    # rest the general one) and held bit for bit over two launches
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
        route = _conv_route(KD, args)
        assert route == ('fast' if cin % 64 == 0 and cout % 128 == 0
                         and dil == 1 else 'general'), (label, route)
        got = KD.deform_conv_cuda(*args)
        again = KD.deform_conv_cuda(*args)
        want = KD.deform_conv_reference(*args)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, again), f'{label}: differs between launches'
        d = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        err['deform_conv_bf16'] = max(err['deform_conv_bf16'], d)
        print(f'[fused bf16] {label}: x {(b, h, w, cin)} Cout {cout} '
              f'{kh}x{kw} stride {st} dilation {dil}, {route} route: '
              f'max|diff| {d:.3e} (max|ref| {scale:.3e}, atol '
              f'{BF16_REL_ATOL:.4f} of it), bit-identical over two launches',
              flush=True)
        assert d <= BF16_REL_ATOL * scale, (label, d, scale)
        del x, off, mask, args, got, again, want

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
    mark(4)
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
    _model_vs_cpu(torch, dev, cfg)

    # where one steady frame's device and host time go (torch.profiler)
    from torch.profiler import record_function
    state = init_state()
    clip = clips[0]
    for f in range(2):
        state, _, _ = step(state, clip[f], f == 0)
    n_prof = 4

    def frames():
        nonlocal state
        for f in range(2, 2 + n_prof):
            with record_function('step'):
                state, _, _ = step(state, clip[f], False)

    prof = _profile(frames, 1)
    rows = _device_rows(prof, ranges=('step',))
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
    _print_host_split('phase 4 step, steady frames', prof, 'step')
    for stage, ms in _stage_ms(torch, cfg, model, state, clip[6], 9).items():
        print(f'[stage] {ms:8.3f} ms  {stage}')

    # ---- 5. kernel times ----------------------------------------------------
    mark(5)
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

    tally = _tally
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

    # the bf16 variants.  K1 on bf16 [8,24,40,256] (one step of the
    # batched eval, all 8 lanes in one launch): half the input bytes, the
    # same fp32 flops; the fp32 kernel on the same values beside it
    x1e = torch.randn(EVAL_LANES, 24, 40, 256, device=dev, generator=g)
    x2e = torch.randn(EVAL_LANES, 24, 40, 256, device=dev, generator=g)
    x1b, x2b = x1e.bfloat16(), x2e.bfloat16()
    assert K1.corr_fast(256, x1b.data_ptr(), x2b.data_ptr())
    k1b_ms = _device_ms(lambda: K1.correlate_cuda(x1b, x2b, 11), 200)
    k1b_call = _time_ms(lambda: K1.correlate_cuda(x1b, x2b, 11), 500)
    k1b_plain = _time_ms(lambda: K1.correlate_reference(x1b, x2b, 11), 50)
    k1e_ms = _device_ms(lambda: K1.correlate_cuda(x1e, x2e, 11), 200)
    k1b_bound, k1b_by = _bound_ms(
        2 * 2 * x1b.numel() + 4 * EVAL_LANES * 960 * 121,
        2 * EVAL_LANES * 960 * 121 * 256)
    # where the bf16 kernel's time goes on each route (kernels/split.py:
    # builds with a part left out); the general route is the design every
    # bf16 call took before the fast route
    k1_split = _corr_split(torch, dev, smi, ('fast', 'general'))
    k1b_general = _split_sum(k1_split['general'], 1)
    print(f'[time] correlation bf16 [{EVAL_LANES},24,40,256] P 11: kernel '
          f'{k1b_ms:.5f} ms (device, fast route), per wrapper call '
          f'{k1b_call:.5f} ms, plain {k1b_plain:.5f} ms, bound '
          f'{k1b_bound:.5f} ms ({k1b_by}); general route {k1b_general:.5f} '
          f'ms, fp32 sibling on the same values {k1e_ms:.5f} ms ({smi})')
    # the fused conv at the 7 sites with 8 frames (one step of the batched
    # eval): bf16 beside fp32 on the same inputs.  Bound of bf16: x,
    # offset, mask, weight, bias read once and out written once at 2 bytes;
    # the gather's flops at the fp32 peak plus 2*M*N*K at the bf16
    # tensor-core peak (_bf16_conv_time, also the L2 reads and the cuBLAS
    # yardstick).  Every site takes the fast route.
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
        r = _bf16_conv_time(torch, KD, tuple(t.bfloat16() for t in (
            x, off, wt, mask, bias)) + (stride, 1), flops, 100)
        assert r['route'] == 'fast', (site, r['route'])
        _acc_add(kdb, r)
        print(f'[time] deform_conv bf16 {site} x {EVAL_LANES} frames: '
              f'{_bf16_conv_line(r)}; fp32 sibling (same inputs) {ms8:.5f} '
              f'ms', flush=True)
        del x, off, mask, r
    print(f'[time] deform_conv bf16, 7 sites x {EVAL_LANES} frames summed: '
          f'{kdb["ms"]:.5f} ms (device), per call {kdb["call_ms"]:.5f} ms, '
          f'plain {kdb["plain_ms"]:.5f} ms, bound {kdb["bound_ms"]:.5f} ms; '
          f'asked of L2 {kdb["l2_bytes"] / 1e6:.1f} MB, '
          f'{kdb["l2_bytes"] / (kdb["ms"] * 1e-3) / 1e12:.3f} TB/s; cuBLAS '
          f'bf16 GEMM over the gathered columns (not the same function) '
          f'{kdb["library_ms"]:.5f} ms; fp32 sibling {kd8["ms"]:.5f} ms '
          f'(bound {kd8["bound_ms"]:.5f} ms) ({smi})', flush=True)
    # where the bf16 kernel's time goes (kernels/split.py: builds with a
    # part left out), on the fast route and on the general one, the design
    # every site took before the fast route
    from stmask_torch.kernels import split as KS
    KS.build_variants(KS.CONV)
    split_sites = _split_sites(torch, dev)
    kd_split = {}
    for route in ('fast', 'general'):
        kd_split[route] = KS.split(KS.CONV, KD, split_sites,
                                   KD.deform_conv_cuda,
                                   lambda fn: _device_ms(fn, 50), route)
        KS.print_split(KS.CONV, route, kd_split[route], smi, EVAL_LANES)
    del split_sites

    # ---- 6. the training step ----------------------------------------------
    mark(6)
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
    train_base = torch.cuda.memory_allocated()
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
    want = dict.fromkeys(KERNELS, 0)
    want.update({n_: per * TRAIN_STEPS for n_, per in TRAIN_LAUNCHES.items()})
    assert train_launches == want, (train_launches, want)
    phase6 = [{k: float(v) for k, v in m.items()} for m in metrics]
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
          f'memory {train_peak / 2**20:.1f} MiB, '
          f'{(train_peak - train_base) / 2**20:.1f} MiB above the '
          f'{train_base / 2**20:.1f} MiB allocated at the first step\'s '
          f'start ({name}, {smi}); '
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
        s1 = train(cfg.replace(max_iter=1), model, lambda e: hosts[-2:-1],
                   1, save_dir, log_dir, save_interval=1, device=dev)
        saved = sorted(os.listdir(save_dir))
        s2 = train(cfg.replace(max_iter=2), model, lambda e: hosts[-1:], 1,
                   save_dir, log_dir, resume='latest', device=dev)
        n_log = sum(1 for _ in open(f'{log_dir}/{cfg.name}.log'))
        print(f'[loop] checkpoints {saved}, then {sorted(os.listdir(save_dir))}'
              f'; steps {s1.step} then {s2.step} (resumed); {n_log} log lines',
              flush=True)
        assert saved == [f'{cfg.name}_0_1.pth', f'{cfg.name}_1_1.pth'], \
            saved
        assert s1.step == 1
        assert s2.step == 2 and int(s2.count) == 2

    # the card against the CPU path: one step at 96x128, full depth
    _train_step_vs_cpu(torch, dev, cfg)

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
    mark(7)
    eval_tmp = tempfile.TemporaryDirectory()     # phase 9 reads its set
    ev = _eval_cli(torch, dev, smi, name, eval_tmp.name)
    eval_launches = ev['launches']

    # ---- 8. the training CLI -----------------------------------------------
    mark(8)
    train_tmp = tempfile.TemporaryDirectory()    # phase 12 reads its set
    tc = _train_cli(torch, dev, smi, name, train_tmp.name, train_med)

    # ---- 9. FCB: STMask_plus_resnet50_ada / _ali ---------------------------
    mark(9)
    _fcb_checks(torch, dev, err)
    fcb_eval = _fcb_eval_step(torch, dev, smi, name)
    fcb_cli = _fcb_eval_cli(torch, dev, smi, name, ev['ann'], ev['prefix'],
                            eval_tmp.name)
    fcb_train = _fcb_train(torch, dev, smi, name)
    fcb_t = _fcb_times(torch, dev, smi)

    # ---- 10. the mAP* NMS family (B5) and the legacy YOLACT preset ---------
    mark(10)
    greedy_t = _greedy_checks(torch, dev, smi, err)
    mapstar = _mapstar_eval(torch, dev, smi, name, cc_ms=med)
    legacy = _legacy_eval_step(torch, dev, smi, name)
    legacy_cli = _legacy_eval_cli(torch, dev, smi, name, ev['ann'],
                                  ev['prefix'], eval_tmp.name)

    # ---- 11. the other backbones, legacy training, the flags, C.7 ----------
    mark(11)
    extra_eval = _extra_eval(torch, dev, smi, name)
    extra_train = _extra_train(torch, dev, smi, name)
    flags = _flag_surface(torch, dev, smi, name)
    r101 = _r101_eval(torch, dev, smi, name)
    ada_cli = _ada_eval_cli(torch, dev, smi, name, ev['ann'], ev['prefix'],
                            eval_tmp.name)

    # ---- 12. the eval CLI's other modes and the training overlays ---------
    mark(12)
    with tempfile.TemporaryDirectory() as tmp:
        modes = _other_modes(torch, dev, smi, name, ev['ann'], ev['prefix'],
                             tc['ann'], tc['prefix'], tmp, med,
                             tc['ms_per_step'])
    eval_tmp.cleanup()

    # ---- 13. data-parallel training and the serving artifact -------------
    mark(13)
    torch.cuda.empty_cache()
    dp = _data_parallel(torch, dev, smi, name, train_med)
    with tempfile.TemporaryDirectory() as tmp:
        started = _start_clis(tc['ann'], tc['prefix'], tmp)
        nccl = _nccl_world1(torch, dev, phase6[:2])
        nccl['torchrun_s'] = _torchrun_cli(started.pop('torchrun'), tmp)
        exp = _export_phase(torch, dev, smi, name, clips, med, tmp, started)
    train_tmp.cleanup()

    # ---- 14. bf16 training and remat ------------------------------------
    mark(14)
    torch.cuda.empty_cache()
    bwd = _bf16_backward(torch, dev, smi, err)
    tmodes = _train_modes(torch, dev, smi, name, hosts)
    ali16 = _ali_bf16_remat(torch, dev, smi, name, hosts)

    # ---- 15. training through the exact gather (window radius 0) ---------
    mark(15)
    torch.cuda.empty_cache()
    k5 = _exact_kernel(torch, dev, smi, err)
    _wgrad_far(torch, dev, err)
    exact_cpu = _exact_vs_cpu(torch, dev, fcb_train['rel'])
    exact = _exact_train(torch, dev, smi, name, hosts)

    # ---- 16. the lane axis and the scan ------------------------------------
    mark(16)
    torch.cuda.empty_cache()
    lanes16 = _lane_axis(torch, dev, smi, name, clips, err)

    # ---- 17. the scripts on the card ---------------------------------------
    mark(17)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp17:
        scripts17 = _scripts_phase(torch, dev, smi, tmp17)

    by_of = _by_of
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
         'bound_by': k1b_by, 'library_ms': None, 'fp32_ms': k1e_ms,
         'kernel_path': 'fast (packed bf16x2 products)',
         'general_route_ms': k1b_general,
         'shape': f'x1, x2 [{EVAL_LANES},24,40,256] bf16 (one eval CLI step '
                  'over its lanes), patch 11, fp32 out; one launch'},
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
         'library_ms': kdb['library_ms'],
         'library_is': _CONV_LIBRARY_IS, 'fp32_ms': kd8['ms'],
         'kernel_path': _CONV_FAST_PATH, 'l2_read_bytes': kdb['l2_bytes'],
         'general_route_ms': _split_sum(kd_split['general'], 7),
         'fcb_ada_ms': fcb_t['acc']['deform_conv_bf16']['ms'],
         'fcb_ada_call_ms': fcb_t['acc']['deform_conv_bf16']['call_ms'],
         'fcb_ada_plain_ms': fcb_t['acc']['deform_conv_bf16']['plain_ms'],
         'fcb_ada_bound_ms': fcb_t['acc']['deform_conv_bf16']['bound_ms'],
         'fcb_ada_library_ms':
             fcb_t['acc']['deform_conv_bf16']['library_ms'],
         'fcb_ada_fp32_ms': fcb_t['acc']['deform_conv_bf16']['fp32_ms'],
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
    train_cli_path = (f'training CLI, {TRAIN_CLI_STEPS} steps of '
                      f'{TRAIN_CLIPS} clips and the validation (bf16)')
    acc = fcb_t['acc']
    fcb_sites = ('FCB\'s 15 sites (P3..P7 of a 384x640 frame under 3x3, 3x5 '
                 'and 5x3 taps, Cin = Cout = 256, v1), one launch each; '
                 'times are their sum')
    table['kernels'].insert(5, {
        'name': 'deform_conv_bf16_f32off', 'route': 'cuda',
        'source': 'stmask_torch/kernels/csrc/deform_conv.cu',
        'replaces': 'stmask_tpu/ops/deform_conv.py:31 (called by '
                    'stmask_tpu/models/heads.py:124 with _ali_offsets\' '
                    'fp32 offsets)',
        'launches': fcb_cli['launches']['deform_conv_bf16_f32off'],
        'launches_path': (
            f'STMask_plus_resnet50_ali eval CLI (bf16, {EVAL_LANES} streams '
            f'x {EVAL_CHUNK}-frame chunks), {fcb_cli["stats"]["n_chunks"]} '
            'chunks and a warm-up chunk'),
        'max_abs_err': err['deform_conv_bf16_f32off'],
        'ms': acc['deform_conv_bf16_f32off']['ms'],
        'call_ms': acc['deform_conv_bf16_f32off']['call_ms'],
        'plain_ms': acc['deform_conv_bf16_f32off']['plain_ms'],
        'bound_ms': acc['deform_conv_bf16_f32off']['bound_ms'],
        'bound_by': _by_of(acc['deform_conv_bf16_f32off']),
        'library_ms': acc['deform_conv_bf16_f32off']['library_ms'],
        'library_is': _CONV_LIBRARY_IS, 'kernel_path': _CONV_FAST_PATH,
        'fp32_ms': acc['deform_conv_bf16_f32off']['fp32_ms'],
        'l2_read_bytes': acc['deform_conv_bf16_f32off']['l2_bytes'],
        'shape': fcb_sites.replace('one 384x640 frame',
                                   f'{2 * TRAIN_CLIPS} 384x640 frames') +
        '; bf16 x and weight, fp32 offsets'})
    bf16_path = (f'bf16 + remat training step of STMask_plus_resnet50, '
                 f'{MODE_STEPS} steps of {TRAIN_CLIPS} clips')
    ali_path = (f'bf16 + remat training step of STMask_plus_resnet50_ali, '
                f'{ALI_BF16_STEPS} steps of {TRAIN_CLIPS} clips')
    b16 = bwd['acc']
    fcb_acc = fcb_t['acc']
    for row_name, key, src, replaces, path, n_launch, fp32_ms, lib_ms, \
            shape in (
            ('deform_wgrad_bf16', 'deform_wgrad_bf16', 'deform_wgrad.cu',
             'stmask_tpu/ops/deform_conv.py:347 (the transpose of jnp.dot '
             'in deform_conv2d_window :270, bf16)', bf16_path,
             tmodes['res']['bf16_remat']['launches']['deform_wgrad_bf16'],
             wgt['ms'], bwd['lib']['sites'],
             sites.replace('one 384x640 frame', '8 384x640 frames')
             + '; bf16 g, x, offset, mask and d_w'),
            ('deform_wgrad_bf16_f32off', 'deform_wgrad_bf16_f32off',
             'deform_wgrad.cu',
             'stmask_tpu/ops/deform_conv.py:347 (FCB\'s sites, '
             'stmask_tpu/models/heads.py:124, fp32 offsets)', ali_path,
             ali16['launches']['deform_wgrad_bf16_f32off'],
             fcb_acc['deform_wgrad']['ms'], bwd['lib']['fcb'],
             fcb_sites.replace('one 384x640 frame', '8 384x640 frames')
             + '; bf16 g, x and d_w, fp32 offsets'),
            ('deform_col2im_bf16', 'deform_col2im_bf16', 'deform_col2im.cu',
             'stmask_tpu/ops/deform_conv.py:152 (_make_window_gather VJP, '
             'with deform_conv2d_window :270, bf16)', bf16_path,
             tmodes['res']['bf16_remat']['launches']['deform_col2im_bf16'],
             k4['ms'], None,
             sites.replace('one 384x640 frame', '8 384x640 frames')
             + '; bf16 dcols, x, offset, mask and their gradients'),
            ('deform_col2im_bf16_f32off', 'deform_col2im_bf16_f32off',
             'deform_col2im.cu',
             'stmask_tpu/ops/deform_conv.py:152 (FCB\'s sites, fp32 '
             'offsets)', ali_path,
             ali16['launches']['deform_col2im_bf16_f32off'],
             fcb_acc['deform_col2im']['ms'], None,
             fcb_sites.replace('one 384x640 frame', '8 384x640 frames')
             + '; bf16 dcols, x and dx, fp32 offsets and d_offset'),
            ('correlation_bwd_bf16', 'correlation_bwd_bf16',
             'correlation_bwd.cu',
             'stmask_tpu/ops/correlation.py:22 (its XLA transpose in bf16)',
             bf16_path,
             tmodes['res']['bf16_remat']['launches']['correlation_bwd_bf16'],
             k3_ms, None,
             f'x1, x2 [{TRAIN_CLIPS},24,40,256] bf16, g, out '
             f'[{TRAIN_CLIPS},24,40,121] fp32; one launch')):
        a_ = b16[key]
        row = {'name': row_name, 'route': 'cuda',
               'source': f'stmask_torch/kernels/csrc/{src}',
               'replaces': replaces, 'launches': n_launch,
               'launches_path': path, 'max_abs_err': err[row_name],
               'max_abs_err_is': 'relative to max|ref|', 'ms': a_['ms'],
               'call_ms': a_['call_ms'], 'plain_ms': a_['plain_ms'],
               'bound_ms': a_['bound_ms'], 'bound_by': _by_of(a_),
               'library_ms': lib_ms, 'fp32_ms': fp32_ms, 'shape': shape}
        if lib_ms is not None:
            row['library_is'] = ('cuBLAS\'s bf16 GEMM g^T @ cols alone '
                                 '(the columns gathered beforehand)')
        if 'general_ms' in a_:
            row.update(kernel_path=_CORR_BWD_FAST_PATH
                       if key == 'correlation_bwd_bf16'
                       else _COL2IM_FAST_PATH,
                       general_ms=a_['general_ms'],
                       fp32_same_inputs_ms=a_['fp32_ms'])
            if 'routes_bit_identical' in a_:
                row['routes_bit_identical'] = a_['routes_bit_identical']
        elif 'fp32_ms' in a_:
            row.update(kernel_path='fast (bf16 wgmma)',
                       fp32_same_inputs_ms=a_['fp32_ms'])
        fcb_key = key + '_fcb'
        if fcb_key in b16:
            f_ = b16[fcb_key]
            row.update(fcb_ada_ms=f_['ms'], fcb_ada_call_ms=f_['call_ms'],
                       fcb_ada_plain_ms=f_['plain_ms'],
                       fcb_ada_bound_ms=f_['bound_ms'],
                       fcb_ada_general_ms=f_.get('general_ms'),
                       fcb_ada_fp32_same_inputs_ms=f_.get('fp32_ms'),
                       fcb_ada_shape=fcb_sites.replace(
                           'one 384x640 frame', '8 384x640 frames')
                       + '; bf16 offsets (_ada)')
        table['kernels'].append(row)
    table['train_modes'] = {
        tag: dict(ms_per_step=r['ms'], peak_mib_above_start=r['peak'] / 2**20,
                  launches_per_step=r['per_step'],
                  device_busy_ms=r.get('busy'))
        for tag, r in tmodes['res'].items()}
    table['train_modes'].update(
        remat_grad_rel=tmodes['remat_rel'],
        plain_twice_grad_rel=tmodes['noise'],
        remat_loss_rel=tmodes['loss_rel'], bf16_loss_gap=tmodes['gap'],
        ali_bf16_remat_ms=ali16['ms'],
        ali_bf16_remat_peak_mib_above_start=ali16['peak'] / 2**20)
    fcb_paths = {
        'deform_conv': ('1 frame', 'eval (STMask_plus_resnet50_ada, fp32) '
                        '15 a frame, training 15 a step'),
        'deform_conv_bf16': (f'{2 * TRAIN_CLIPS} frames, bf16 offsets (ada)',
                             'eval CLI of STMask_plus_resnet50_ada 15 a '
                             'step (not driven here)'),
        'deform_conv_bf16_f32off': (f'{2 * TRAIN_CLIPS} frames',
                                    'eval CLI of STMask_plus_resnet50_ali '
                                    '15 a step'),
        'deform_wgrad': (f'{2 * TRAIN_CLIPS} frames', 'training 15 a step'),
        'deform_col2im': (f'{2 * TRAIN_CLIPS} frames', 'training 15 a step')}
    for row in table['kernels']:
        row['cli_launches'] = tc['launches'][row['name']]
        row['cli_path'] = train_cli_path
        row['fcb_eval_launches'] = fcb_eval['launches'][row['name']]
        row['fcb_cli_launches'] = fcb_cli['launches'][row['name']]
        row['fcb_train_launches_per_step'] = (
            fcb_train['launches'][row['name']] // TRAIN_STEPS)
        if row['name'] in acc:
            a_ = acc[row['name']]
            frames_, use = fcb_paths[row['name']]
            row.update(fcb_ms=a_['ms'], fcb_call_ms=a_['call_ms'],
                       fcb_plain_ms=a_['plain_ms'],
                       fcb_bound_ms=a_['bound_ms'], fcb_bound_by=_by_of(a_),
                       fcb_shape=fcb_sites.replace(
                           'one 384x640 frame', frames_) + f'; {use}')
    t_ = acc['deform_conv_train']
    table['kernels'][3].update(          # the fp32 row: the training forward
        fcb_train_ms=t_['ms'], fcb_train_call_ms=t_['call_ms'],
        fcb_train_plain_ms=t_['plain_ms'], fcb_train_bound_ms=t_['bound_ms'],
        fcb_train_bound_by=_by_of(t_),
        fcb_train_shape=fcb_sites.replace('one 384x640 frame',
                                          f'{2 * TRAIN_CLIPS} frames'))
    assert table['kernels'][3]['name'] == 'deform_conv'
    table['fcb'] = dict(
        eval_ms_per_frame=fcb_eval['ms'], eval_busy_ms=fcb_eval['busy'],
        eval_peak_mib_above_start=fcb_eval['peak'] / 2**20,
        cli_e2e_fps=fcb_cli['stats']['e2e_fps'],
        cli_device_fps=fcb_cli['timed']['device_fps'],
        train_ms_per_step=fcb_train['ms'], train_busy_ms=fcb_train['busy'],
        train_peak_mib=fcb_train['peak'] / 2**20,
        train_peak_mib_above_start=(fcb_train['peak']
                                    - fcb_train['base']) / 2**20,
        dcols_sgemm_ms=fcb_t['sgemm'])
    legacy_cli_path = (
        f'YOLACT_legacy_resnet50 eval CLI --nms greedy (bf16, {EVAL_LANES} '
        f'streams x {EVAL_CHUNK}-frame chunks), '
        f'{legacy_cli["stats"]["n_chunks"]} chunks and a warm-up chunk')
    gt_ = greedy_t[GREEDY_PATH_SHAPE]
    g320 = greedy_t[(320, 200)]
    table['kernels'].append({
        'name': 'greedy_nms', 'route': 'cuda',
        'source': 'stmask_torch/kernels/csrc/greedy_nms.cu',
        'replaces': 'stmask_tpu/ops/nms.py:117 (greedy_nms_mask, an XLA '
                    'fori_loop vmapped by greedy_nms_per_class :155; not '
                    'Pallas)',
        'launches': legacy_cli['launches']['greedy_nms'],
        'launches_path': legacy_cli_path + '; the matrix entry, on no path '
                         'since the boxes entry (greedy_nms_mask(..., iou=) '
                         'alone calls it)',
        'max_abs_err': err['greedy_nms'],
        'max_abs_err_is': 'keep flags that differ from the plain version',
        'ms': gt_['ms'], 'call_ms': gt_['call_ms'],
        'plain_ms': gt_['plain_ms'], 'bound_ms': gt_['bound_ms'],
        'bound_by': gt_['bound_by'], 'library_ms': None,
        'shape': 'iou [40,200,200] fp32, valid [40,200]: one frame\'s 40 '
                 'classes at nms_top_k 200; one launch',
        'ms_320': g320['ms'], 'call_ms_320': g320['call_ms']})
    table['kernels'].append({
        'name': 'greedy_nms_boxes', 'route': 'cuda',
        'source': 'stmask_torch/kernels/csrc/greedy_nms.cu',
        'replaces': 'stmask_tpu/ops/nms.py:117 (greedy_nms_mask, an XLA '
                    'fori_loop vmapped by greedy_nms_per_class :155; not '
                    'Pallas) with _plus_one_iou :140',
        'launches': legacy_cli['launches']['greedy_nms_boxes'],
        'launches_path': legacy_cli_path,
        'max_abs_err': err['greedy_nms_boxes'],
        'max_abs_err_is': 'keep flags that differ from the plain version',
        'ms': g320['boxes_ms'], 'call_ms': g320['boxes_call_ms'],
        'plain_ms': g320['boxes_plain_ms'],
        'bound_ms': g320['boxes_bound_ms'],
        'bound_by': g320['boxes_bound_by'], 'library_ms': None,
        'before_ms': g320['before_ms'],
        'before_is': f'the caller\'s IoU formation (_plus_one_iou, '
                     f'{g320["iou_kernels"]} kernels, {g320["iou_ms"]:.5f} '
                     'ms) + the matrix entry',
        'shape': 'boxes [64000,4] fp32 (scaled by 640 in the kernel), idx '
                 '[320,200] int64, valid [320,200]: the 40 classes of each of '
                 'the eval CLI\'s 8 lanes at nms_top_k 200, one step; one '
                 'launch',
        'ms_40': gt_['boxes_ms'], 'call_ms_40': gt_['boxes_call_ms'],
        'before_ms_40': gt_['before_ms']})
    for row in table['kernels']:
        row['lane_chunk_launches'] = lanes16['chunk']['launches'][row['name']]
        row['legacy_cli_launches'] = legacy_cli['launches'][row['name']]
        row['legacy_eval_launches'] = legacy['launches'][row['name']]
        row['mapstar_greedy_eval_launches'] = \
            mapstar['greedy']['launches'][row['name']]
    gn_train = extra_train['STMask_resnet50_gn']
    for row in table['kernels']:
        n_ = row['name']
        row['gn_eval_launches'] = \
            extra_eval['STMask_resnet50_gn']['launches'][n_]
        row['darknet_eval_launches'] = \
            extra_eval['STMask_darknet53']['launches'][n_]
        row['gn_train_launches_per_step'] = \
            gn_train['launches'][n_] // TRAIN_STEPS
        row['legacy_train_launches'] = \
            extra_train['YOLACT_legacy_resnet50']['launches'][n_]
        row['r101_eval_launches'] = r101['launches'][n_]
        row['ada_cli_launches'] = ada_cli['launches'][n_]
    for row in table['kernels']:
        for mode in ('video_dir', 'benchmark', 'display', 'coco',
                     'vis_every'):
            row[f'{mode}_launches'] = modes[mode]['launches'][row['name']]
    table['modes'] = dict(
        video_dir_fps=modes['video_dir']['e2e_fps'],
        benchmark_fps=modes['benchmark']['fps'],
        benchmark_stage_ms={k: st['avg_ms'] for k, st in
                            modes['benchmark']['stages'].items()},
        display_fps=modes['display']['e2e_fps'],
        coco_fps=modes['coco']['e2e_fps'],
        vis_overlay_ms=modes['vis_every']['median_ms'],
        tensorboard_written=modes['tensorboard'])
    ops = {'correlation': 'stmask::correlate',
           'correlation_bf16': 'stmask::correlate',
           'deform_conv': 'stmask::deform_conv',
           'deform_conv_bf16': 'stmask::deform_conv',
           'deform_conv_bf16_f32off': 'stmask::deform_conv',
           'greedy_nms': 'stmask::greedy_nms_keep',
           'greedy_nms_boxes': 'stmask::greedy_nms_plus_one_keep',
           'deform_im2col': 'ctypes (on no path)'}
    for row in table['kernels']:
        n_ = row['name']
        row['binding'] = ops.get(n_, 'ctypes, in an autograd backward')
        row['dp_rank_launches_per_step'] = dp['launches'][n_]
        row['nccl_world1_launches_per_step'] = nccl['launches'][n_]
        row['export_fp32_launches'] = exp['fp32']['launches'][n_]
        row['export_bf16_launches'] = exp['bf16']['launches'][n_]
    table['parallel'] = dict(
        ranks=DP_RANKS, rank_ms_per_step=dp['ms'],
        rank1_ms_per_step=dp['ms_rank1'], phase6_ms_per_step=train_med,
        rank_peak_mib=[b / 2**20 for b in dp['peak']],
        all_reduce_ms=dp['all_reduce_ms'], loss_rel=dp['same'],
        trajectory_rel=dp['traj'],
        control_rel=dp['control'], grad0_rel=dp['grad0'],
        grad0_noise_rel=dp['grad0_noise'],
        grad0_control_rel=dp['grad0_control'],
        grad_last_rel=dp['grad_last'], update_last_rel=dp['update_last'],
        grad_last_control_rel=dp['grad_last_control'],
        witness_noise_rel=dp['witness_noise'],
        witness_split_rel=dp['witness_split'],
        nccl_rel=nccl['rel'], torchrun_s=nccl['torchrun_s'])
    table['export'] = {tag: dict(
        export_s=r['export_s'], save_s=r['save_s'], load_s=r['load_s'],
        mb=r['mb'], bench_fps=r['bench']['value'], ms_per_call=r['ms'],
        max_abs_diff=r['worst']) for tag, r in exp.items()}
    table['export']['live_fp32_ms_per_frame'] = med
    table['mapstar'] = {tag: r['ms'] for tag, r in mapstar.items()
                        if tag != 'export'}
    table['mapstar']['detect_ms'] = {tag: r['detect_ms']
                                     for tag, r in mapstar.items()
                                     if tag != 'export'}
    table['legacy'] = dict(
        eval_ms_per_frame=legacy['ms'], eval_busy_ms=legacy['busy'],
        eval_launches_per_frame=legacy['launches_per_frame'],
        eval_peak_mib_above_start=legacy['peak'] / 2**20,
        cli_e2e_fps=legacy_cli['stats']['e2e_fps'],
        cli_device_fps=legacy_cli['timed']['device_fps'],
        cli_peak_mib=legacy_cli['peak'] / 2**20)
    table['extra'] = {
        'eval_ms_per_frame': {k: r['ms'] for k, r in extra_eval.items()
                              if 'ms' in r},
        'eval_busy_ms': {k: r['busy'] for k, r in extra_eval.items()
                         if 'busy' in r},
        'vgg16_forward_ms': extra_eval['STMask_vgg16']['forward_ms'],
        'train_ms_per_step': {k: r['ms'] for k, r in extra_train.items()},
        'train_busy_ms': {k: r['busy'] for k, r in extra_train.items()},
        'train_peak_mib': {k: r['peak'] / 2**20
                           for k, r in extra_train.items()},
        'flags_rescore_score_diff': flags['score_diff'],
        'r101_eval_ms_per_frame': r101['ms'], 'r101_eval_busy_ms':
            r101['busy'],
        'ada_cli_e2e_fps': ada_cli['stats']['e2e_fps'],
        'ada_cli_device_fps': ada_cli['stats']['device_fps']}
    # K5's rows: the training step through the exact gather (phase 15)
    k5_src = 'stmask_torch/kernels/csrc/deform_exact_bwd.cu'
    k5_replaces = ('stmask_tpu/ops/deform_conv.py:31 (the autodiff of '
                   'deform_conv2d\'s gather through ops/sampling.py:48 '
                   'bilinear_sample_block; XLA, not Pallas)')
    exact_path = ('training step through the exact gather (both window '
                  'radii 0) of {}, {} steps of {} clips'.format)
    for n_, run, shape, fcb_key in (
            ('deform_exact_bwd', ('STMask_plus_resnet50', 'fp32'),
             sites.replace('one 384x640 frame', '8 384x640 frames')
             + '; N(0, 1.5) offsets', 'deform_exact_bwd_fcb'),
            ('deform_exact_bwd_bf16', ('STMask_plus_resnet50_ada', 'bf16'),
             sites.replace('one 384x640 frame', '8 384x640 frames')
             + '; bf16 dcols, x, offset, mask and their gradients, N(0, '
               '1.5) offsets', 'deform_exact_bwd_bf16_fcb'),
            ('deform_exact_bwd_bf16_f32off',
             ('STMask_plus_resnet50_ali', 'bf16'),
             fcb_sites.replace('one 384x640 frame', '8 384x640 frames')
             + '; bf16 dcols, x and dx, fp32 offsets and d_offset, N(0, '
               '1.5) offsets', None)):
        a_ = k5[n_]
        row = {'name': n_, 'route': 'cuda', 'source': k5_src,
               'replaces': k5_replaces,
               'launches': exact[run]['launches'][n_],
               'launches_path': exact_path(f'{run[0]} ({run[1]})',
                                           EXACT_STEPS, TRAIN_CLIPS),
               'max_abs_err': err[n_],
               'max_abs_err_is': 'relative to max|ref|', 'ms': a_['ms'],
               'call_ms': a_['call_ms'], 'plain_ms': a_['plain_ms'],
               'bound_ms': a_['bound_ms'], 'bound_by': _by_of(a_),
               'library_ms': None, 'shape': shape,
               'path': 'fast route (tiles in shared memory, overflow items '
                       'in device memory)',
               'general_ms': a_['general_ms']}
        if fcb_key is not None:
            f_ = k5[fcb_key]
            row.update(fcb_ms=f_['ms'], fcb_call_ms=f_['call_ms'],
                       fcb_general_ms=f_['general_ms'],
                       fcb_plain_ms=f_['plain_ms'],
                       fcb_bound_ms=f_['bound_ms'], fcb_bound_by=_by_of(f_),
                       fcb_shape=fcb_sites.replace(
                           'one 384x640 frame', '8 384x640 frames'))
        row['ada_launches'] = exact[('STMask_plus_resnet50_ada',
                                     'fp32')]['launches'][n_]
        table['kernels'].append(row)
    table['exact'] = dict(
        {f'{c_}_{m_}_ms': r['ms'] for (c_, m_), r in exact.items()},
        **{f'{c_}_{m_}_peak_mib_above_start': r['peak'] / 2**20
           for (c_, m_), r in exact.items()},
        c15_worst={tag: max(rel.values()) for tag, rel in exact_cpu.items()})
    table['scripts'] = {k: v for k, v in scripts17.items()
                        if not k.startswith('bench_dcn')}
    table['scripts']['bench_dcn'] = {
        dt: [{k: r[k] for k in ('site', 'conv', 'exact', 'window',
                                'max_diff')} for r in scripts17[f'bench_dcn_{dt}']]
        for dt in ('f32', 'bf16')}
    mark('end')
    print(json.dumps(table))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
