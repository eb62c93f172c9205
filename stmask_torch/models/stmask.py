"""STMask model assembly, eval and train branches (port of
``stmask_tpu/models/stmask.py``; reference ``STMask.py:19-330``).

backbone (ResNet, ResNet-GN, DarkNet53 or VGG16, by the preset's name)
-> FPN(P3..P7) -> { ProtoNet on P3, shared FCA head per level (or the
legacy YOLACT head), TemporalNet for the TF branch }, and the optional
semantic-seg conv, class-existence linear and mask-IoU net.  Inputs and
outputs keep the JAX package's layouts (NHWC images, flat [B, P, D]
predictions, NHWC feature maps); inside, the network runs NCHW tensors in
the channels-last memory format, so the NHWC views handed to the
deformable gather and the correlation cost no copy.
Parameter names are the reference ``state_dict`` keys, where the JAX
package's converter has them; the other backbones, ``class_existence_fc``
and ``maskiou_net`` carry the flax names.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import STMaskConfig
from ..ops.correlation import correlate
from .backbone import Bottleneck, DCNConv
from .backbones_extra import (DarkBlock, GNBottleneck, GroupNorm,
                              construct_backbone)
from .fpn import FPN
from .heads import (DeformAdaption, FeatureAlign, PredictionHead,
                    focal_conf_bias)
from .layers import FrozenBatchNorm, MakeNet
from .legacy_head import PredictionModule
from .maskiou import FastMaskIoUNet
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
        if cfg.head_type not in ('fc', 'legacy'):
            raise ValueError(f'{cfg.name}: head_type {cfg.head_type!r}, '
                             "'fc' or 'legacy'")
        self.cfg = cfg
        # dispatch on the preset's backbone name (stmask.py:45)
        self.backbone = construct_backbone(cfg.backbone)
        in_ch = [self.backbone.channels[i]
                 for i in cfg.backbone.selected_layers]
        self.fpn = FPN(cfg.fpn, in_ch)
        nf = cfg.fpn.num_features
        self.proto_net = MakeNet(nf, _PROTO_SPEC, include_last_relu=False)
        if cfg.head_type == 'legacy':
            head = PredictionModule(nf, cfg.num_classes, cfg.mask_proto_n,
                                    num_priors=len(cfg.pred_scales[0]) * 3)
        else:
            head = PredictionHead(cfg, nf)
        self.prediction_layers = nn.ModuleList([head])
        if cfg.temporal_fusion_module:
            self.TemporalNet = TemporalNet(
                2 * nf + cfg.correlation_patch_size ** 2, cfg.mask_proto_n)
        if cfg.use_semantic_segmentation_loss:
            self.semantic_seg_conv = nn.Conv2d(nf, cfg.num_classes - 1, 1)
        if cfg.use_class_existence_loss:
            # a linear on the mean-pooled P7 (reference STMask.py:114-117)
            self.class_existence_fc = nn.Linear(nf, cfg.num_classes - 1)
        if cfg.use_maskiou:
            self.maskiou_net = FastMaskIoUNet(cfg.num_classes)

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
            if c.head_type == 'legacy':
                p = head(f)
            else:
                p = head(f, train)
            # the legacy head has no T2S feature: the FPN level stands in
            t2s.append(p.pop('T2S_feat', f))
            for k, v in p.items():
                preds.setdefault(k, []).append(v)
        out = {k: torch.cat(v, dim=1).float() for k, v in preds.items()}
        out['proto'] = _nhwc(proto).float()
        return fpn_outs, out, t2s

    def forward(self, x: torch.Tensor, train: bool = False,
                return_fpn_outs: bool = False) -> Dict[str, torch.Tensor]:
        """Eval: NHWC frames [B, H, W, 3] -> decode-ready outputs (softmaxed
        conf, ``fpn_feat`` with TF; ``stmask.py:152-174``);
        ``return_fpn_outs`` (eval only) adds the P3..P7 pyramid as
        ``fpn_outs``, a tuple of NHWC [B, h, w, C] maps (the
        ``--display_fpn_outs`` surface, ``stmask.py:107-111``).  Train: two-frame
        clips [B, 2, H, W, 3], flattened clip-major, -> raw conf logits and,
        with TF, ``T2S_concat_feat`` = relu(cat[correlation(ref, next),
        T2S_ref, T2S_next]) on FPN level ``correlation_selected_layer``
        (``stmask.py:126-151``); even rows are the ref frames."""
        c = self.cfg
        sel = c.correlation_selected_layer
        if train:
            b, nf, h, w, _ = x.shape
            fpn_outs, out, t2s = self._forward_single(
                x.reshape(b * nf, h, w, 3), train=True)
            if c.temporal_fusion_module:
                f = fpn_outs[sel].permute(0, 2, 3, 1)     # NHWC view
                # K1 writes fp32 from bf16 features; JAX's bf16 correlation
                # is bf16, and so is its concatenation with T2S
                t = t2s[sel].permute(0, 2, 3, 1)
                corr = correlate(f[0::2].contiguous(), f[1::2].contiguous(),
                                 c.correlation_patch_size).to(t.dtype)
                out['T2S_concat_feat'] = F.relu(torch.cat(
                    [corr, t[0::2], t[1::2]], dim=-1))
            if c.use_semantic_segmentation_loss:
                out['segm'] = _nhwc(self.semantic_seg_conv(fpn_outs[0]))
            if c.use_class_existence_loss:
                # image-level class logits from the mean-pooled P7
                # (reference STMask.py:300-301)
                out['classes'] = self.class_existence_fc(
                    fpn_outs[-1].mean(dim=(2, 3)))
            return out
        fpn_outs, out, t2s = self._forward_single(x, train=False)
        # the legacy head has no centerness or track branch: neutral values
        # keep the detect and track stages uniform (stmask.py:154-163)
        b, n_anchor = out['loc'].shape[:2]
        if 'centerness' not in out:
            out['centerness'] = out['loc'].new_ones((b, n_anchor, 1))
        if 'track' not in out:
            out['track'] = out['loc'].new_full(
                (b, n_anchor, c.embed_dim), 1.0 / c.embed_dim ** 0.5)
        out['conf'] = torch.softmax(out['conf'], dim=-1)
        out['T2S_feat'] = _nhwc(t2s[sel])
        if c.temporal_fusion_module:
            out['fpn_feat'] = _nhwc(fpn_outs[sel])
        if return_fpn_outs:
            out['fpn_outs'] = tuple(_nhwc(f) for f in fpn_outs)
        return out

    def temporal_shift(self, bbox_feats: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """TemporalNet on RoIAligned [N, 7, 7, C] features."""
        return self.TemporalNet(bbox_feats)

    def maskiou(self, masks: torch.Tensor) -> torch.Tensor:
        """FastMaskIoUNet on [N, H, W, 1] soft masks -> [N, C - 1] (the 'I'
        loss and the eval re-scoring; reference STMask.py:71-72)."""
        return self.maskiou_net(masks)


def _conf_bias(model: STMask):
    """The conf layers' biases, each with its bank's prior count: the FCA
    head's per bank (FCB's ``conv`` where a bank aligns), or the legacy
    head's one."""
    c, head = model.cfg, model.prediction_layers[0]
    if isinstance(head, PredictionModule):
        return [(head.conf_layer.bias, len(c.pred_scales[0]) * 3)]
    return [((m.conv if isinstance(m, FeatureAlign) else m).bias,
             len(c.pred_scales[0])) for m in head.conf_layer]


def _init_focal_bias(model: STMask) -> None:
    """Under ``use_sigmoid_focal_loss`` the conf biases start at
    ``heads.focal_conf_bias``, as the JAX package's initializers set them;
    otherwise they stay zero."""
    if model.cfg.use_sigmoid_focal_loss:
        for bias, n in _conf_bias(model):
            bias.copy_(torch.from_numpy(focal_conf_bias(model.cfg, n)))


def _fan_in(w: torch.Tensor, transposed: bool) -> int:
    """Inputs summed into each output: torch's ConvTranspose2d weight is
    [in, out, kh, kw], every other kernel [out, in, ...]."""
    return w.shape[0] * w[0, 0].numel() if transposed else w[0].numel()


def init_random(model: STMask, generator: torch.Generator) -> STMask:
    """Seeded random weights for eval runs without a checkpoint.

    Convs and linears are He-normal with zero bias; BatchNorm and
    GroupNorm keep the identity and the last norm scale of each residual
    branch (a bottleneck's ``bn3`` or ``gn3``, a DarkNet block's ``bn2``)
    is 0.2, so the residual stream stays O(1) through the untrained
    backbone.  The DCN offset predictors get small weights and a bias of
    std 0.5 pixels, so the deformable gather samples off the grid; FCB's
    deformable kernels are He-normal and its ``conv_offset`` predictors of
    std 0.1, so that ada's offsets are not integers.  Parameters are drawn on the CPU, in
    module order, so a seed gives the same weights on every device.  Under
    ``use_sigmoid_focal_loss`` the conf biases are the focal init.  Training
    from these weights loses the ProtoNet (its last ReLU goes dead within
    tens of steps, in the JAX package alike): the training entry points
    start from ``init_flax``.
    """
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = _fan_in(m.weight,
                                 isinstance(m, nn.ConvTranspose2d))
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
        for m in model.modules():
            last = {Bottleneck: 'bn3', GNBottleneck: 'gn3',
                    DarkBlock: 'bn2'}.get(type(m))
            if last:
                getattr(m, last).weight.fill_(0.2)
        _init_focal_bias(model)
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
    bias.  GroupNorm is the identity (scale 1, bias 0); a transposed conv's
    fan-in is its input channels times its taps, as flax counts it.  Under
    ``use_sigmoid_focal_loss`` the conf biases are the focal init
    (``heads.py:62``).  Parameters are drawn on the CPU, in module order.
    """
    def truncated(shape, scale: float, fan_in: int):
        # flax's truncated_normal: the stddev corrected for the truncation
        std = math.sqrt(scale / fan_in) / .87962566103423978
        return nn.init.trunc_normal_(torch.empty(shape), std=std,
                                     a=-2 * std, b=2 * std,
                                     generator=generator)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear,
                              DCNConv)):
                scale = 2.0 if isinstance(m, DCNConv) else 1.0
                m.weight.copy_(truncated(m.weight.shape, scale, _fan_in(
                    m.weight, isinstance(m, nn.ConvTranspose2d))))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, GroupNorm):
                m.weight.fill_(1.0)
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
        _init_focal_bias(model)
    return model


def build_model(cfg: STMaskConfig, device: torch.device,
                seed: int) -> STMask:
    """The model on ``device`` in eval mode and channels-last, with random
    weights drawn from ``seed``."""
    model = init_random(STMask(cfg), torch.Generator().manual_seed(seed))
    return model.to(device=device, memory_format=torch.channels_last).eval()

