"""STMask model assembly, eval branch (port of
``stmask_tpu/models/stmask.py``; reference ``STMask.py:19-330``).

backbone -> FPN(P3..P7) -> { ProtoNet on P3, shared FCA head per level,
TemporalNet for the TF branch }.  Inputs and outputs keep the JAX package's
layouts (NHWC images, flat [B, P, D] predictions, NHWC feature maps); inside,
the network runs NCHW tensors in the channels-last memory format, so the
NHWC views handed to the deformable gather and the correlation cost no copy.
Parameter names are the reference ``state_dict`` keys.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import STMaskConfig
from .backbone import DCNConv, ResNetBackbone
from .fpn import FPN
from .heads import PredictionHead
from .layers import MakeNet
from .temporal import TemporalNet

# ProtoNet spec (reference config.py:667 'mask_proto_net'): 3x conv(256,3)
# -> bilinear x2 -> conv(256,3) -> conv(32,1), last relu stripped.
_PROTO_SPEC = ((256, 3, 1), (256, 3, 1), (256, 3, 1), (None, -2, 0),
               (256, 3, 1), (32, 1, 0))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class STMask(nn.Module):
    def __init__(self, cfg: STMaskConfig):
        super().__init__()
        if cfg.head_type != 'fc' or cfg.use_maskiou \
                or cfg.use_semantic_segmentation_loss \
                or cfg.use_class_existence_loss:
            raise NotImplementedError(
                f'{cfg.name}: only the FCA head with TF is ported '
                '(ROADMAP A.12)')
        if not cfg.temporal_fusion_module:
            raise NotImplementedError(
                f'{cfg.name}: the no-TF tracker is not ported yet')
        self.cfg = cfg
        self.backbone = ResNetBackbone(cfg.backbone)
        in_ch = [(256, 512, 1024, 2048)[i]
                 for i in cfg.backbone.selected_layers]
        self.fpn = FPN(cfg.fpn, in_ch)
        nf = cfg.fpn.num_features
        self.proto_net = MakeNet(nf, _PROTO_SPEC, include_last_relu=False)
        self.prediction_layers = nn.ModuleList([PredictionHead(cfg, nf)])
        self.TemporalNet = TemporalNet(
            2 * nf + cfg.correlation_patch_size ** 2, cfg.mask_proto_n)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        """Eval forward of NHWC frames [B, H, W, 3] (mirrors the JAX eval
        branch, ``stmask.py:152-174``)."""
        if train:
            raise NotImplementedError(
                'the training forward is not ported yet (ROADMAP A.9)')
        c = self.cfg
        x = x.permute(0, 3, 1, 2)      # channels-last NCHW view, no copy
        bb = self.backbone(x)
        fpn_outs = self.fpn([bb[i] for i in c.backbone.selected_layers])
        proto = F.relu(self.proto_net(fpn_outs[c.mask_proto_src]))

        head = self.prediction_layers[0]
        preds: Dict[str, list] = {}
        t2s = []
        for f in fpn_outs:
            p = head(f)
            t2s.append(p.pop('T2S_feat'))
            for k, v in p.items():
                preds.setdefault(k, []).append(v)
        out = {k: torch.cat(v, dim=1).float() for k, v in preds.items()}
        out['conf'] = torch.softmax(out['conf'], dim=-1)
        out['proto'] = _nhwc(proto).float()
        sel = c.correlation_selected_layer
        out['T2S_feat'] = _nhwc(t2s[sel])
        out['fpn_feat'] = _nhwc(fpn_outs[sel])
        return out

    def temporal_shift(self, bbox_feats: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """TemporalNet on RoIAligned [N, 7, 7, C] features."""
        return self.TemporalNet(bbox_feats)


def init_random(model: STMask, generator: torch.Generator) -> STMask:
    """Seeded random weights for runs without a checkpoint.

    Convs and linears are He-normal with zero bias; BatchNorm keeps the
    identity statistics and each bottleneck's last BN scale is 0.2, so the
    residual stream stays O(1) through the untrained backbone.  The DCN
    offset predictors get small weights and a bias of std 0.5 pixels, so
    the deformable gather samples off the grid.  Parameters are
    drawn on the CPU, in module order, so a seed gives the same weights on
    every device.
    """
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(normal(m.weight.shape,
                                      math.sqrt(2.0 / fan_in)))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, DCNConv):
                fan_in = m.weight[0].numel()
                m.weight.copy_(normal(m.weight.shape,
                                      math.sqrt(2.0 / fan_in)))
                m.bias.zero_()
        for m in model.modules():
            if isinstance(m, DCNConv):
                om = m.conv_offset_mask
                om.weight.copy_(normal(om.weight.shape, 0.01))
                om.bias.copy_(normal(om.bias.shape, 0.5))
        for layer in model.backbone.layers:
            for block in layer:
                block.bn3.weight.fill_(0.2)
    return model


def build_model(cfg: STMaskConfig, device: torch.device,
                seed: int) -> STMask:
    """The model on ``device`` in eval mode and channels-last, with random
    weights drawn from ``seed``."""
    model = init_random(STMask(cfg), torch.Generator().manual_seed(seed))
    return model.to(device=device, memory_format=torch.channels_last).eval()

