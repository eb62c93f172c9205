"""The other backbones: ResNet-GN, DarkNet53 and VGG16 (port of
``stmask_tpu/models/backbones_extra.py``; reference ``backbone.py:188-239``
ResNet with GroupNorm, ``:271-337`` DarkNet53, ``:339-460`` VGG16 with the
SSD 'reducedfc' tail).

The JAX package's converter maps no reference ``state_dict`` key to these
backbones (``stmask_tpu/convert.py::map_torch_key``), so their modules and
parameters are named after the flax modules: ``backbone.layer0_0.gn1.weight``
for flax's ``backbone/layer0_0/gn1/scale``, ``backbone.stem_conv.weight``,
``backbone.conv_fc6.bias``, and so on; ``convert.state_dict_from_flax``
joins the flax path with dots.  Modules take and return NCHW tensors (the
model keeps them channels-last).  None of these backbones has a
deformable conv: ``train`` is accepted and ignored, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import BackboneConfig
from .layers import FrozenBatchNorm


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` (its defaults: epsilon 1e-6, the fast variance
    E[x^2] - E[x]^2 clipped at 0), not torch's (1e-5, two passes).

    The statistics are taken in fp32 whatever the input's dtype; then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32, cast back
    to the input's dtype (flax promotes to fp32 against the fp32 statistics
    and casts to the dtype of the input and parameters, which share a dtype
    on every path of the model)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.num_groups
        # NHWC view (no copy in the channels-last format), groups split off
        xf = x.permute(0, 2, 3, 1).float().reshape(b, h * w, g, c // g)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=(1, 3), keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float().reshape(
            g, c // g)
        y = (xf - mean) * mul + self.bias.float().reshape(g, c // g)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2).to(x.dtype)


class GNBottleneck(nn.Module):
    """ResNet bottleneck with GroupNorm (``backbones_extra.py:23-48``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, num_groups: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.gn1 = GroupNorm(num_groups, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.gn2 = GroupNorm(num_groups, planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.gn3 = GroupNorm(num_groups, planes * 4)
        self.downsample_conv = self.downsample_gn = None
        if has_downsample:
            self.downsample_conv = nn.Conv2d(inplanes, planes * 4, 1,
                                             stride=stride, bias=False)
            self.downsample_gn = GroupNorm(num_groups, planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.gn1(self.conv1(x)))
        out = F.relu(self.gn2(self.conv2(out)))
        out = self.gn3(self.conv3(out))
        residual = x if self.downsample_conv is None else \
            self.downsample_gn(self.downsample_conv(x))
        return F.relu(out + residual)


class ResNetBackboneGN(nn.Module):
    """ResNet with GroupNorm (``backbones_extra.py:51-78``); returns the
    four stages' outputs.  Blocks are ``layer{s}_{b}``."""

    def __init__(self, cfg: BackboneConfig, num_groups: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.gn1 = GroupNorm(num_groups, 64)
        self.stages = []
        planes, in_ch = 64, 64
        for s, blocks in enumerate(cfg.layers):
            names = []
            for b in range(blocks):
                stride = (1, 2, 2, 2)[s] if b == 0 else 1
                has_ds = b == 0 and (stride != 1 or in_ch != planes * 4)
                self.add_module(f'layer{s}_{b}', GNBottleneck(
                    in_ch, planes, stride, has_ds, num_groups))
                names.append(f'layer{s}_{b}')
                in_ch = planes * 4
            self.stages.append(names)
            planes *= 2
        self.channels = tuple(64 * 4 * 2 ** s for s in range(len(cfg.layers)))

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.gn1(self.conv1(x)))
        # flax's max_pool pads with -inf, as torch's does
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for names in self.stages:
            for n in names:
                x = getattr(self, n)(x)
            outs.append(x)
        return tuple(outs)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu(x, 0.1)``: ``where(x >= 0, x, 0.1 x)``, whose
    derivative at exactly 0 is 1 (torch's ``F.leaky_relu`` gives 0.1)."""
    return torch.where(x >= 0, x, x * 0.1)


class DarkBlock(nn.Module):
    """DarkNet residual block: 1x1 squeeze + 3x3 expand
    (``backbones_extra.py:81-96``)."""

    def __init__(self, channels: int):
        super().__init__()
        half = channels // 2
        self.conv1 = nn.Conv2d(channels, half, 1, bias=False)
        self.bn1 = FrozenBatchNorm(half)
        self.conv2 = nn.Conv2d(half, channels, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = leaky_relu(self.bn1(self.conv1(x)))
        y = leaky_relu(self.bn2(self.conv2(y)))
        return x + y


class DarkNetBackbone(nn.Module):
    """DarkNet-53 (``backbones_extra.py:99-122``); returns the five stages'
    outputs.  The JAX package builds it without the preset's settings, so
    its stages are always (1, 2, 8, 8, 4)."""

    def __init__(self, layers: Tuple[int, ...] = (1, 2, 8, 8, 4)):
        super().__init__()

        def conv_bn(cin: int, ch: int, k: int, s: int, name: str):
            self.add_module(f'{name}_conv', nn.Conv2d(
                cin, ch, k, stride=s, padding=(k - 1) // 2, bias=False))
            self.add_module(f'{name}_bn', FrozenBatchNorm(ch))
            return name

        self.stem = conv_bn(3, 32, 3, 1, 'stem')
        self.stages = []
        ch = 32
        for s, blocks in enumerate(layers):
            down = conv_bn(ch, 2 * ch, 3, 2, f'down{s}')
            ch *= 2
            names = []
            for b in range(blocks):
                self.add_module(f'layer{s}_{b}', DarkBlock(ch))
                names.append(f'layer{s}_{b}')
            self.stages.append((down, names))
        self.channels = tuple(64 * 2 ** s for s in range(len(layers)))

    def _conv_bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f'{name}_conv')(x)
        return leaky_relu(getattr(self, f'{name}_bn')(x))

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, ...]:
        x = self._conv_bn(self.stem, x)
        outs = []
        for down, names in self.stages:
            x = self._conv_bn(down, x)
            for n in names:
                x = getattr(self, n)(x)
            outs.append(x)
        return tuple(outs)


class VGGBackbone(nn.Module):
    """VGG16 with the SSD 'reducedfc' tail (``backbones_extra.py:125-155``):
    3x3 conv + ReLU stages (with biases) behind 2x2 max pools, then a 3x3
    stride-1 pool, ``conv_fc6`` (1024, 3x3, dilation 6) and ``conv_fc7``
    (1024, 1x1).  Returns the five stages' outputs and the tail's.  The
    tail keeps stride 16, so outputs 4 and 5 share a size."""

    ARCH = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
            (512, 512, 512))

    def __init__(self):
        super().__init__()
        self.stages = []
        idx, cin = 0, 3
        for stage in self.ARCH:
            names = []
            for ch in stage:
                self.add_module(f'conv{idx}', nn.Conv2d(cin, ch, 3,
                                                        padding=1))
                names.append(f'conv{idx}')
                idx, cin = idx + 1, ch
            self.stages.append(names)
        self.conv_fc6 = nn.Conv2d(cin, 1024, 3, padding=6, dilation=6)
        self.conv_fc7 = nn.Conv2d(1024, 1024, 1)
        self.channels = tuple(s[-1] for s in self.ARCH) + (1024,)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, ...]:
        outs = []
        for s, names in enumerate(self.stages):
            if s > 0:
                x = F.max_pool2d(x, 2, stride=2)       # flax VALID
            for n in names:
                x = F.relu(getattr(self, n)(x))
            outs.append(x)
        x = F.max_pool2d(x, 3, stride=1, padding=1)
        x = F.relu(self.conv_fc6(x))
        outs.append(F.relu(self.conv_fc7(x)))
        return tuple(outs)


def construct_backbone(cfg: BackboneConfig) -> nn.Module:
    """Backbone dispatch on the preset's backbone name
    (``backbones_extra.py:158``; reference ``backbone.py:462``)."""
    from .backbone import ResNetBackbone
    name = cfg.name.lower()
    if 'darknet' in name:
        return DarkNetBackbone()
    if 'vgg' in name:
        return VGGBackbone()
    if 'gn' in name:
        return ResNetBackboneGN(cfg)
    return ResNetBackbone(cfg)
