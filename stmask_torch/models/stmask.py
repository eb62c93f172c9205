"""STMask model assembly, eval and train branches (port of
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
from ..ops.correlation import correlate
from .backbone import DCNConv, ResNetBackbone
from .fpn import FPN
from .heads import DeformAdaption, FeatureAlign, PredictionHead
from .layers import FrozenBatchNorm, MakeNet
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

    def _forward_single(self, x: torch.Tensor, train: bool):
        """NHWC frames [B, H, W, 3] -> (fpn_outs, flat predictions, NCHW
        T2S features per level) (``stmask.py:74-105``)."""
        c = self.cfg
        x = x.permute(0, 3, 1, 2)      # channels-last NCHW view, no copy
        bb = self.backbone(x, train=train)
        fpn_outs = self.fpn([bb[i] for i in c.backbone.selected_layers])
        proto = F.relu(self.proto_net(fpn_outs[c.mask_proto_src]))

        head = self.prediction_layers[0]
        preds: Dict[str, list] = {}
        t2s = []
        for f in fpn_outs:
            p = head(f, train)
            t2s.append(p.pop('T2S_feat'))
            for k, v in p.items():
                preds.setdefault(k, []).append(v)
        out = {k: torch.cat(v, dim=1).float() for k, v in preds.items()}
        out['proto'] = _nhwc(proto).float()
        return fpn_outs, out, t2s

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        """Eval: NHWC frames [B, H, W, 3] -> decode-ready outputs (softmaxed
        conf, ``fpn_feat``; ``stmask.py:152-174``).  Train: two-frame clips
        [B, 2, H, W, 3], flattened clip-major, -> raw conf logits and
        ``T2S_concat_feat`` = relu(cat[correlation(ref, next), T2S_ref,
        T2S_next]) on FPN level ``correlation_selected_layer``
        (``stmask.py:126-151``); even rows are the ref frames."""
        c = self.cfg
        sel = c.correlation_selected_layer
        if train:
            b, nf, h, w, _ = x.shape
            fpn_outs, out, t2s = self._forward_single(
                x.reshape(b * nf, h, w, 3), train=True)
            f = fpn_outs[sel].permute(0, 2, 3, 1)     # NHWC view
            corr = correlate(f[0::2].contiguous(), f[1::2].contiguous(),
                             c.correlation_patch_size)
            t = t2s[sel].permute(0, 2, 3, 1)
            out['T2S_concat_feat'] = F.relu(torch.cat(
                [corr, t[0::2], t[1::2]], dim=-1))
            return out
        fpn_outs, out, t2s = self._forward_single(x, train=False)
        out['conf'] = torch.softmax(out['conf'], dim=-1)
        out['T2S_feat'] = _nhwc(t2s[sel])
        out['fpn_feat'] = _nhwc(fpn_outs[sel])
        return out

    def temporal_shift(self, bbox_feats: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """TemporalNet on RoIAligned [N, 7, 7, C] features."""
        return self.TemporalNet(bbox_feats)


def init_random(model: STMask, generator: torch.Generator) -> STMask:
    """Seeded random weights for eval runs without a checkpoint.

    Convs and linears are He-normal with zero bias; BatchNorm keeps the
    identity statistics and each bottleneck's last BN scale is 0.2, so the
    residual stream stays O(1) through the untrained backbone.  The DCN
    offset predictors get small weights and a bias of std 0.5 pixels, so
    the deformable gather samples off the grid; FCB's deformable kernels
    are He-normal and its ``conv_offset`` predictors of std 0.1, so that
    ada's offsets are not integers.  Parameters are drawn on the CPU, in
    module order, so a seed gives the same weights on every device.  Training from these weights loses the ProtoNet (its last
    ReLU goes dead within tens of steps, in the JAX package alike): the
    training entry points start from ``init_flax``.
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
            elif isinstance(m, (DCNConv, DeformAdaption)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(normal(m.weight.shape,
                                      math.sqrt(2.0 / fan_in)))
                if isinstance(m, DCNConv):
                    m.bias.zero_()
        for m in model.modules():
            if isinstance(m, DCNConv):
                om = m.conv_offset_mask
                om.weight.copy_(normal(om.weight.shape, 0.01))
                om.bias.copy_(normal(om.bias.shape, 0.5))
            elif isinstance(m, FeatureAlign) and m.conv_offset is not None:
                m.conv_offset.weight.copy_(
                    normal(m.conv_offset.weight.shape, 0.1))
        for layer in model.backbone.layers:
            for block in layer:
                block.bn3.weight.fill_(0.2)
    return model


def init_flax(model: STMask, generator: torch.Generator) -> STMask:
    """Seeded initial weights drawn as the JAX package's ``model.init``
    draws them (flax's initializers; the training entry points start
    here, as ``train.py`` and ``scripts/overfit_sanity.py`` do).

    Conv and linear kernels are LeCun-normal (variance 1 / fan-in), the
    DCN kernels He-normal (variance 2 / fan-in), both truncated at two
    standard deviations as flax's ``variance_scaling`` draws them; biases
    are zero; the DCN offset predictors are zero, so training starts from
    a plain conv (``backbone.py:41-47``); BatchNorm is the identity.  FCB
    (``heads.py:84-129``): ``conv_offset`` zero, the deformable kernel
    ``normal(0.01)`` (not truncated), ``conv`` LeCun-normal with a zero
    bias.  Parameters are drawn on the CPU, in module order.
    """
    def truncated(shape, scale: float, fan_in: int):
        # flax's truncated_normal: the stddev corrected for the truncation
        std = math.sqrt(scale / fan_in) / .87962566103423978
        return nn.init.trunc_normal_(torch.empty(shape), std=std,
                                     a=-2 * std, b=2 * std,
                                     generator=generator)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear, DCNConv)):
                scale = 2.0 if isinstance(m, DCNConv) else 1.0
                m.weight.copy_(truncated(m.weight.shape, scale,
                                         m.weight[0].numel()))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, FrozenBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        for m in model.modules():
            if isinstance(m, DCNConv):
                m.conv_offset_mask.weight.zero_()
                m.conv_offset_mask.bias.zero_()
            elif isinstance(m, FeatureAlign):
                if m.conv_offset is not None:
                    m.conv_offset.weight.zero_()
                w = m.conv_adaption.weight
                w.copy_(torch.randn(w.shape, generator=generator) * 0.01)
    return model


def build_model(cfg: STMaskConfig, device: torch.device,
                seed: int) -> STMask:
    """The model on ``device`` in eval mode and channels-last, with random
    weights drawn from ``seed``."""
    model = init_random(STMask(cfg), torch.Generator().manual_seed(seed))
    return model.to(device=device, memory_format=torch.channels_last).eval()

