"""Split a frame's time: forward / forward + detect / the full video step
/ the candidate shift alone (the counterpart of the JAX package's
``scripts/profile_step.py``):

    python -m stmask_torch.scripts.profile_step [--device cuda|cpu]

The flagship at 384x640 in fp32 (TF32 off), the eval CLI's seeded random
weights.  Each part runs alone, timed by CUDA events around each call (a
synchronize before each), median of 30 calls after a warm-up.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

REPEATS = 30


def run(cfg, device, repeats: int = REPEATS) -> Dict[str, float]:
    """Print and return {'forward', 'forward_detect', 'full_step',
    'candidate_shift'} in ms."""
    from ..inference import build_video_step
    from ..inference.candidates import detect_frame
    from ..inference.tracker import candidate_shift
    from ..ops.anchors import all_priors
    from ..utils.device import resolve_device
    from ..utils.profiling import median_ms
    from ._common import seeded_model
    dev = resolve_device(device)
    model = seeded_model(cfg, dev)
    priors = torch.as_tensor(all_priors(cfg), device=dev)
    frame = torch.from_numpy(np.random.RandomState(0).randn(
        cfg.pad_h, cfg.pad_w, 3).astype(np.float32)).to(dev)
    keys = ('loc', 'conf', 'mask_coeff', 'track', 'centerness')

    @torch.inference_mode()
    def fwd():
        return model(frame[None])

    @torch.inference_mode()
    def fwd_detect():
        preds = fwd()
        return detect_frame(cfg, {k: preds[k][0] for k in keys}, priors,
                            proto=preds['proto'][0])

    out = {'forward': median_ms(fwd, repeats, dev),
           'forward_detect': median_ms(fwd_detect, repeats, dev)}
    print('forward only      :', out['forward'], 'ms')
    print('forward + detect  :', out['forward_detect'], 'ms')

    video_step, make_state = build_video_step(cfg, model, device=dev)
    state, _ = video_step(make_state(), frame, True)
    state, _ = video_step(state, frame, False)
    out['full_step'] = median_ms(lambda: video_step(state, frame, False),
                                 repeats, dev)
    print('full video step   :', out['full_step'], 'ms')

    preds = fwd()

    @torch.inference_mode()
    def shift_only():
        return candidate_shift(cfg, model.temporal_shift, state,
                               preds['fpn_feat'][0], preds['T2S_feat'][0],
                               preds['proto'][0])

    out['candidate_shift'] = median_ms(shift_only, repeats, dev)
    print('candidate shift   :', out['candidate_shift'], 'ms')
    return out


def main(argv=None) -> int:
    from ..config import get_config
    from ._common import add_device
    p = argparse.ArgumentParser()
    add_device(p)
    args = p.parse_args(argv)
    run(get_config('STMask_plus_resnet50'), args.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
