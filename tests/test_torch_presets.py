"""Every preset of the port's registry (``stmask_torch/config.py``, 24
names) builds at its full depth and forwards a 96x128 frame.

Building on the meta device draws no weights; the forward runs at one
block a stage where the backbone takes a depth (ResNet, with one DCN site
a stage where the preset has DCN), on the CPU.  The presets' outputs are
held against the JAX package by test_torch_model_parity.py (the flagship),
test_torch_fcb_model.py (FCB), test_torch_legacy.py (legacy) and
test_torch_backbones_extra.py (GN, DarkNet53, VGG16).
"""

import dataclasses

import pytest
import torch

from stmask_torch.config import REGISTRY
from stmask_torch.config import get_config as t_get_config
from stmask_torch.models import STMask as TSTMask
from stmask_torch.ops.anchors import all_priors

from torch_eval_common import KW
from torch_eval_common import few_torch_threads  # noqa: F401


def _reduced(cfg):
    """One block a stage where the preset's backbone takes a depth
    (DarkNet53 and VGG16 have fixed ones)."""
    if cfg.backbone.name.lower().startswith('resnet'):
        return cfg.replace(backbone=dataclasses.replace(
            cfg.backbone, layers=(1,) * len(cfg.backbone.layers),
            dcn_layers=tuple(min(1, d) for d in cfg.backbone.dcn_layers)))
    return cfg


@pytest.mark.parametrize('name', sorted(REGISTRY))
def test_every_preset_builds_and_forwards(name):
    """Every preset builds at its full depth (on the meta device: no
    weights drawn), and forwards a 96x128 frame at one block a stage:
    finite outputs, one anchor per prior (VGG16: 912 against 771, C.8)."""
    cfg = t_get_config(name).replace(**KW)
    with torch.device('meta'):
        TSTMask(cfg)
    cfg = _reduced(cfg)
    torch.manual_seed(0)
    model = TSTMask(cfg).eval()
    x = torch.randn(1, cfg.pad_h, cfg.pad_w, 3,
                    generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        out = model(x)
    for k, v in out.items():
        assert bool(torch.isfinite(v.float()).all()), (name, k)
    n = len(all_priors(cfg))
    assert out['loc'].shape[1] == (912 if name == 'STMask_vgg16' else n)
