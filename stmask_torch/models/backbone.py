"""ResNet-50/101 backbone with interval deformable-conv stages (port of
``stmask_tpu/models/backbone.py``).

Bottleneck stacks where ``use_dcn`` swaps the 3x3 conv2 for the modulated
deformable conv v2, applied to the last ``dcn_layers[s]`` blocks of each
stage at ``dcn_interval`` (reference ``backbone.py:124-131``).  Parameter
names are the reference ``state_dict`` keys
(``backbone.layers.S.B.conv2.conv_offset_mask.weight``, ...).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import BackboneConfig
from ..kernels.deform_conv import deform_conv
from ..ops.deform_conv import (dcn_v2_offsets, deform_conv_exact,
                               deform_conv_window)
from .layers import FrozenBatchNorm


class DCNConv(nn.Module):
    """Modulated deformable conv v2, 3x3, as in CharlesShang DCNv2
    (parameters ``weight`` [out, in, 3, 3], ``bias`` and the offset+mask
    predictor ``conv_offset_mask``).  ``radius`` 0 takes the exact
    unclamped gather (the JAX package's eval path; in training, at
    ``dcn_window_radius`` 0, with the exact gather's backward); ``radius``
    > 0 the window-clamped one with its backward (training, or eval under
    ``dcn_window_eval``; ``backbone.py:127``).

    The fused kernel reads ``weight`` as [out, 3, 3, in]; in the
    channels-last layout the model is kept in (``build_model``,
    ``build_video_step``, ``build_train_step``) that permutation is a view,
    so no copy is made, and the weight's gradient comes back in the same
    layout."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.conv_offset_mask = nn.Conv2d(in_ch, 27, 3, stride=stride,
                                          padding=dilation,
                                          dilation=dilation)

    def forward(self, x: torch.Tensor, radius: int = 0,
                train: bool = False) -> torch.Tensor:
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1)     # NHWC
        offset, mask = dcn_v2_offsets(om, 9)
        x = x.permute(0, 2, 3, 1).contiguous()
        weight = self.weight.permute(0, 2, 3, 1).contiguous()
        if radius > 0:
            out = deform_conv_window(x, offset, weight, mask, self.bias,
                                     self.stride, self.dilation, radius)
        elif train:
            out = deform_conv_exact(x, offset, weight, mask, self.bias,
                                    self.stride, self.dilation)
        else:
            out = deform_conv(x, offset, weight, mask, self.bias,
                              self.stride, self.dilation)
        return out.permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """ResNet bottleneck (reference backbone.py:8-58), expansion 4."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_dcn: bool = False, has_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        if use_dcn:
            self.conv2 = DCNConv(planes, planes, stride=stride)
        else:
            self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                                   padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride,
                          bias=False),
                FrozenBatchNorm(planes * 4))

    def forward(self, x: torch.Tensor, radius: int = 0,
                train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        conv2 = self.conv2(out, radius, train) if isinstance(
            self.conv2, DCNConv) else self.conv2(out)
        out = F.relu(self.bn2(conv2))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


def _dcn_flags(blocks: int, dcn_layers: int, dcn_interval: int) -> List[bool]:
    """Which blocks of a stage use DCN (reference backbone.py:124-131)."""
    flags = [dcn_layers >= blocks]
    for i in range(1, blocks):
        flags.append(((i + dcn_layers) >= blocks) and (i % dcn_interval == 0))
    return flags


class ResNetBackbone(nn.Module):
    """Returns (C2, C3, C4, C5) feature maps."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.layers = nn.ModuleList()
        planes, in_ch = 64, 64
        for s, blocks in enumerate(cfg.layers):
            flags = _dcn_flags(blocks, cfg.dcn_layers[s], cfg.dcn_interval)
            mods = []
            for b in range(blocks):
                stride = (1 if s == 0 else 2) if b == 0 else 1
                has_ds = b == 0 and (stride != 1 or in_ch != planes * 4)
                mods.append(Bottleneck(in_ch, planes, stride, flags[b],
                                       has_ds))
                in_ch = planes * 4
            self.layers.append(nn.Sequential(*mods))
            planes *= 2
        self.channels = tuple(256 * 2 ** s for s in range(len(cfg.layers)))

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, ...]:
        # training takes the window-clamped DCN, or the exact gather at
        # dcn_window_radius 0; eval opts in to the window via
        # dcn_window_eval (reference backbone.py:127)
        c = self.cfg
        radius = c.dcn_window_radius if (train or c.dcn_window_eval) else 0
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for layer in self.layers:
            for block in layer:
                x = block(x, radius, train)
            outs.append(x)
        return tuple(outs)
