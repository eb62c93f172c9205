"""What several scripts share: the ``--device`` flag, the seeded model, the
training batch of the JAX package's ``scripts/bench_train.py``, and the
programs ``mfu``, ``trace_step`` and ``trace_train`` run, each as a call
that runs it once."""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Tuple

import numpy as np
import torch


def add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                   help='where the model runs (default cuda, which raises '
                        'without a GPU)')


def seeded_model(cfg, device, train: bool = False):
    """The model of ``cfg`` on ``device`` (channels-last) with weights from
    seed 0: for training the flax-like init the training entry points
    start from (``init_flax``), for eval the eval CLI's random weights
    without a checkpoint (``init_random``: DCN offsets off the grid)."""
    from ..models.stmask import STMask, init_flax, init_random
    init = init_flax if train else init_random
    model = init(STMask(cfg), torch.Generator().manual_seed(0))
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.train() if train else model.eval()


def bench_batch(cfg, batch_size: int, device) -> Dict[str, torch.Tensor]:
    """The training batch of the JAX package's ``scripts/bench_train.py``
    (and ``trace_train.py``, ``mfu.py``): N(0, 1) images at the padded
    size, one box a frame with its id and label, its mask a rectangle at
    prototype resolution."""
    b, g = batch_size, cfg.max_gt_per_frame
    hp, wp = cfg.pad_h // 4, cfg.pad_w // 4
    rng = np.random.RandomState(0)
    boxes = np.zeros((b, 2, g, 4), np.float32)
    labels = np.zeros((b, 2, g), np.int32)
    ids = np.zeros((b, 2, g), np.int32)
    valid = np.zeros((b, 2, g), bool)
    masks = np.zeros((b, 2, g, hp, wp), np.uint8)
    for i in range(b):
        for f in range(2):
            boxes[i, f, 0] = [0.2, 0.2, 0.6, 0.7]
            labels[i, f, 0] = 1 + i % (cfg.num_classes - 1)
            ids[i, f, 0] = i + 1
            valid[i, f, 0] = True
            masks[i, f, 0, hp // 5:7 * hp // 10, wp // 5:6 * wp // 10] = 1
    batch = {'images': rng.randn(b, 2, cfg.pad_h, cfg.pad_w, 3).astype(
                 np.float32),
             'boxes': boxes, 'labels': labels, 'ids': ids, 'valid': valid,
             'masks_proto': masks}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def frame_call(cfg, device, compute_dtype=torch.float32) -> Callable:
    """One steady frame of ``build_video_step`` (after a first frame), from
    a fixed state."""
    from ..inference import build_video_step
    step, make_state = build_video_step(cfg, seeded_model(cfg, device),
                                        device=device,
                                        compute_dtype=compute_dtype)
    frame = torch.from_numpy(np.random.RandomState(0).randn(
        cfg.pad_h, cfg.pad_w, 3).astype(np.float32)).to(device)
    state, _ = step(make_state(), frame, True)
    return lambda: step(state, frame, False)


def chunk_call(cfg, device, lanes: int, chunk: int) -> Tuple[Callable, int]:
    """(call, frames a call): one call steps ``lanes`` lockstep streams
    ``chunk`` frames in bf16 (``build_video_step_batched``, the eval CLI's
    program), from a fixed state."""
    from ..inference.pipeline import build_video_step_batched
    video_chunk, make_states = build_video_step_batched(
        cfg, seeded_model(cfg, device), lanes, chunk, device=device,
        compute_dtype=torch.bfloat16)
    frames = torch.from_numpy(np.random.RandomState(0).randn(
        chunk, lanes, cfg.pad_h, cfg.pad_w, 3).astype(np.float32)).to(device)
    first = torch.zeros((chunk, lanes), dtype=torch.bool)
    first[0] = True
    states, _ = video_chunk(make_states(), frames, first)
    not_first = torch.zeros_like(first)
    return lambda: video_chunk(states, frames, not_first), lanes * chunk


def train_call(cfg, device, batch_size: int, bf16: bool) -> Callable:
    """One training step of ``bench_batch`` from the flax-like seeded init
    (after one step); each call takes a step of its own."""
    from ..train.train_step import build_train_step
    step, init_state = build_train_step(
        cfg, seeded_model(cfg, device, train=True), device=device,
        compute_dtype=torch.bfloat16 if bf16 else None)
    batch = bench_batch(cfg, batch_size, device)
    state = [step(init_state(), batch)[0]]

    def call():
        state[0], metrics = step(state[0], batch)
        return metrics
    return call
