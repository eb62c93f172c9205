"""The video steps (port of ``stmask_tpu/inference/pipeline.py``:
``build_video_step``, ``build_video_step_batched`` and ``cast_params``).

    video_step(state, frame, is_first) -> (state, FrameOutput)
    video_chunk(states, frames[K, B], is_first[K, B])
        -> (states, FrameOutput[K, B])

run the forward pass, decode, NMS, the mask-IoU re-scoring (under
``use_maskiou`` with ``rescore_mask`` or ``rescore_bbox``), temporal
shift and tracking (the simple tracker for models without TF) on the
device, with the model and
weights there too.  Nothing in a step waits for the device: the caller
reads the small per-frame outputs when it needs them (``inference.fetch``,
``inference.postprocess``).

Compute dtype: ``compute_dtype=torch.bfloat16`` rounds the weights and the
frozen-BN statistics to bf16 (``cast_model``, as ``cast_params`` does) and
runs the network on the bf16 frame; the decode-side outputs come back in
fp32 and the tracker keeps the bf16 features (``init_state(feat_dtype)``).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import MEANS, STD, STMaskConfig
from ..models.stmask import STMask
from ..ops.anchors import all_priors, check_anchor_count
from ..utils.device import resolve_device
from .candidates import Detections, detect_frame, rescore_maskiou
from .tracker import (FrameOutput, TrackState, init_state, track_step_simple,
                      track_step_tf)

_DECODE_KEYS = ('loc', 'conf', 'mask_coeff', 'track', 'centerness')


def normalize_pad(cfg: STMaskConfig, img: torch.Tensor) -> torch.Tensor:
    """uint8/float [..., img_h, img_w, 3] -> normalized, zero-padded float32
    [..., pad_h, pad_w, 3] (``data/transforms.py:150-166``)."""
    mean = torch.tensor(MEANS, dtype=torch.float32, device=img.device)
    std = torch.tensor(STD, dtype=torch.float32, device=img.device)
    x = (img.float() - mean) / std
    return F.pad(x, (0, 0, 0, cfg.pad_w - cfg.img_w, 0, cfg.pad_h - cfg.img_h))


def cast_model(model: STMask, dtype: torch.dtype) -> STMask:
    """Round every floating parameter and buffer to ``dtype`` in place (the
    frozen-BN statistics are buffers here and parameters in the JAX
    package, whose ``cast_params``, ``pipeline.py:234-245``, casts them
    alike).  ``FrozenBatchNorm`` folds in fp32 from the rounded statistics;
    ``TemporalNet`` computes in its input's dtype on the rounded weights."""
    return model.to(dtype=dtype)


def detect_and_rescore(cfg: STMaskConfig, model: STMask, preds: dict,
                       b: int, priors: torch.Tensor) -> Detections:
    """Lane ``b`` of a forward's outputs through ``detect_frame`` and, when
    the config asks for it, ``rescore_maskiou`` (``pipeline.py:48-52``,
    ``:144-150``)."""
    proto = preds['proto'][b]
    det = detect_frame(cfg, {k: preds[k][b] for k in _DECODE_KEYS}, priors,
                       proto=proto)
    if cfg.use_maskiou and (cfg.rescore_mask or cfg.rescore_bbox):
        det = rescore_maskiou(cfg, model.maskiou, det, proto)
    return det


def _prepare(cfg: STMaskConfig, model: STMask, device, compute_dtype):
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'compute dtype {compute_dtype}: float32 or '
                         'bfloat16')
    dev = resolve_device(device)
    model = cast_model(model.to(device=dev, memory_format=torch.channels_last),
                       compute_dtype).eval()
    priors = torch.as_tensor(all_priors(cfg), device=dev)

    def make_init_state() -> TrackState:
        return init_state(cfg, cfg.feature_shapes()[
            cfg.correlation_selected_layer], (cfg.pad_h // 4, cfg.pad_w // 4),
            cfg.fpn.num_features, cfg.embed_dim, device=dev,
            feat_dtype=compute_dtype)

    return dev, model, priors, make_init_state


def build_video_step(cfg: STMaskConfig, model: STMask,
                     uint8_input: bool = False, debug: bool = False,
                     device: torch.device | str = 'cuda',
                     compute_dtype: torch.dtype = torch.float32,
                     debug_fpn: bool = False
                     ) -> Tuple[Callable, Callable[[], TrackState]]:
    """Returns (video_step, make_init_state).

    ``video_step(state, frame[H, W, 3], is_first)`` takes the already
    normalized padded image as float — or, with ``uint8_input=True``, a
    resized uint8 [img_h, img_w, 3] frame (numpy or tensor) normalized and
    padded on the device, then cast to ``compute_dtype``.  ``debug=True``
    additionally returns {'proto', 'mask_coeff', 'det_valid'} of the
    pre-tracking detections (the ``--display_lincomb`` surface);
    ``debug_fpn=True`` returns that dict too, with ``fpn_outs``, the frame's
    P3..P7 as NHWC [h, w, C] maps (``--display_fpn_outs``).  The model is
    moved to ``device`` (default ``cuda``; raises when there is no GPU) and
    cast to ``compute_dtype``; fp32 runs with TF32 off.
    """
    dev, model, priors, make_init_state = _prepare(cfg, model, device,
                                                   compute_dtype)

    @torch.inference_mode()
    def video_step(state: TrackState, frame, is_first
                   ) -> Tuple[TrackState, FrameOutput]:
        frame = torch.as_tensor(frame).to(dev, non_blocking=True)
        frame = normalize_pad(cfg, frame) if uint8_input else frame.float()
        preds = model(frame[None].to(compute_dtype),
                      return_fpn_outs=debug_fpn)
        check_anchor_count(cfg, preds['loc'].shape[1], priors.shape[0])
        proto = preds['proto'][0]
        det = detect_and_rescore(cfg, model, preds, 0, priors)
        if cfg.temporal_fusion_module:
            state, out = track_step_tf(cfg, model.temporal_shift, state, det,
                                       proto, preds['fpn_feat'][0],
                                       preds['T2S_feat'][0], is_first)
        else:
            state, out = track_step_simple(cfg, state, det, proto, is_first)
        if debug or debug_fpn:
            dbg = {'proto': proto, 'mask_coeff': det.mask_coeff,
                   'det_valid': det.valid}
            if debug_fpn:
                dbg['fpn_outs'] = tuple(f[0] for f in preds['fpn_outs'])
            return state, out, dbg
        return state, out

    return video_step, make_init_state


def _stack(outs: Sequence[FrameOutput]) -> FrameOutput:
    return FrameOutput(*(torch.stack(f) for f in zip(*outs)))


def build_video_step_batched(cfg: STMaskConfig, model: STMask,
                             n_videos: int, chunk_size: int = 4,
                             uint8_input: bool = False,
                             device: torch.device | str = 'cuda',
                             compute_dtype: torch.dtype = torch.float32
                             ) -> Tuple[Callable, Callable[[], List]]:
    """Step ``n_videos`` independent video streams in lockstep,
    ``chunk_size`` frames a call (``pipeline.py:111-196``).

    Returns (video_chunk, make_init_states):
      video_chunk(states, frames [K, B, H, W, 3], is_first [K, B])
        -> (states, FrameOutput with leading [K, B])
    where ``states`` is a list of B ``TrackState``s, one per lane.

    Each of the K steps runs the network once on all B lanes; decode, NMS
    and the tracker then run lane by lane (the JAX package ``vmap``s them;
    the results are the same).  ``is_first[k, b]`` resets lane b's tracker
    at step k, so a lane starts its next video mid-chunk; a lane with no
    video steps on a zero frame and its outputs are the caller's to drop.
    ``uint8_input=True`` takes frames as uint8 [K, B, img_h, img_w, 3]
    (resized, not normalized) and normalizes and pads them on the device.
    """
    dev, model, priors, make_init_state = _prepare(cfg, model, device,
                                                   compute_dtype)

    @torch.inference_mode()
    def video_chunk(states: Sequence[TrackState], frames, is_first
                    ) -> Tuple[List[TrackState], FrameOutput]:
        frames = torch.as_tensor(frames).to(dev, non_blocking=True)
        first = torch.as_tensor(is_first, dtype=torch.bool).to(
            dev, non_blocking=True)
        if tuple(first.shape) != (chunk_size, n_videos) or \
                tuple(frames.shape[:2]) != (chunk_size, n_videos):
            raise ValueError(
                f'video_chunk: frames {tuple(frames.shape)} and is_first '
                f'{tuple(first.shape)} must lead with ({chunk_size}, '
                f'{n_videos})')
        x = normalize_pad(cfg, frames) if uint8_input else frames.float()
        states = list(states)
        steps = []
        for k in range(chunk_size):
            preds = model(x[k].to(compute_dtype))
            check_anchor_count(cfg, preds['loc'].shape[1], priors.shape[0])
            lanes = []
            for b in range(n_videos):
                proto = preds['proto'][b]
                det = detect_and_rescore(cfg, model, preds, b, priors)
                if cfg.temporal_fusion_module:
                    states[b], out = track_step_tf(
                        cfg, model.temporal_shift, states[b], det, proto,
                        preds['fpn_feat'][b], preds['T2S_feat'][b],
                        first[k, b])
                else:
                    states[b], out = track_step_simple(cfg, states[b], det,
                                                       proto, first[k, b])
                lanes.append(out)
            steps.append(_stack(lanes))
        return states, _stack(steps)

    def make_init_states() -> List[TrackState]:
        return [make_init_state() for _ in range(n_videos)]

    return video_chunk, make_init_states
