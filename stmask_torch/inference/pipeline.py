"""The per-frame video step (port of
``stmask_tpu/inference/pipeline.py::build_video_step``).

    video_step(state, frame, is_first) -> (state, FrameOutput)

runs the forward pass, decode, NMS, temporal shift and tracking on the
device, with the model and weights there too.  Nothing in a step waits for
the device: the caller reads the small per-frame outputs when it needs
them (``inference.postprocess``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ..config import MEANS, STD, STMaskConfig
from ..models.stmask import STMask
from ..ops.anchors import all_priors
from ..utils.device import resolve_device
from .candidates import detect_frame
from .tracker import FrameOutput, TrackState, init_state, track_step_tf


def normalize_pad(cfg: STMaskConfig, img: torch.Tensor) -> torch.Tensor:
    """uint8/float [..., img_h, img_w, 3] -> normalized, zero-padded float32
    [..., pad_h, pad_w, 3] (``data/transforms.py:150-166``)."""
    mean = torch.tensor(MEANS, dtype=torch.float32, device=img.device)
    std = torch.tensor(STD, dtype=torch.float32, device=img.device)
    x = (img.float() - mean) / std
    return F.pad(x, (0, 0, 0, cfg.pad_w - cfg.img_w, 0, cfg.pad_h - cfg.img_h))


def build_video_step(cfg: STMaskConfig, model: STMask,
                     uint8_input: bool = False, debug: bool = False,
                     device: torch.device | str = 'cuda'
                     ) -> Tuple[Callable, Callable[[], TrackState]]:
    """Returns (video_step, make_init_state).

    ``video_step(state, frame[H, W, 3], is_first)`` takes the already
    normalized padded image as float — or, with ``uint8_input=True``, a
    resized uint8 [img_h, img_w, 3] frame (numpy or tensor) normalized and
    padded on the device.  ``debug=True`` additionally returns
    {'proto', 'mask_coeff', 'det_valid'} of the pre-tracking detections.
    The model is moved to ``device`` (default ``cuda``; raises when there
    is no GPU) and run in float32 with TF32 off.
    """
    dev = resolve_device(device)
    model = model.to(device=dev, memory_format=torch.channels_last).eval()
    priors = torch.as_tensor(all_priors(cfg), device=dev)

    @torch.inference_mode()
    def video_step(state: TrackState, frame, is_first
                   ) -> Tuple[TrackState, FrameOutput]:
        frame = torch.as_tensor(frame).to(dev, non_blocking=True)
        frame = normalize_pad(cfg, frame) if uint8_input else frame.float()
        preds = model(frame[None])
        frame_preds = {k: preds[k][0] for k in
                       ('loc', 'conf', 'mask_coeff', 'track', 'centerness')}
        det = detect_frame(cfg, frame_preds, priors)
        proto = preds['proto'][0]
        state, out = track_step_tf(cfg, model.temporal_shift, state, det,
                                   proto, preds['fpn_feat'][0],
                                   preds['T2S_feat'][0], is_first)
        if debug:
            return state, out, {'proto': proto, 'mask_coeff': det.mask_coeff,
                                'det_valid': det.valid}
        return state, out

    def make_init_state() -> TrackState:
        return init_state(cfg, cfg.feature_shapes()[
            cfg.correlation_selected_layer], (cfg.pad_h // 4, cfg.pad_w // 4),
            cfg.fpn.num_features, cfg.embed_dim, device=dev)

    return video_step, make_init_state

