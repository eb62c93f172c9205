"""Feature Pyramid Network P3-P7 (port of ``stmask_tpu/models/fpn.py``;
reference ``layers/modules/FPN.py:22-108``).

Top-down pathway with 1x1 laterals, bilinear upsampling to the lateral's
size, 3x3 (relu'd) prediction convs, and two stride-2 conv downsamples for
P6/P7.  Laterals are stored reversed, as in the reference.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import FPNConfig
from .layers import resize_bilinear


class FPN(nn.Module):
    def __init__(self, cfg: FPNConfig,
                 in_channels: Sequence[int] = (512, 1024, 2048)):
        super().__init__()
        self.cfg = cfg
        nf = cfg.num_features
        pad = 1 if cfg.pad else 0
        self.lat_layers = nn.ModuleList(
            [nn.Conv2d(c, nf, 1) for c in reversed(in_channels)])
        self.pred_layers = nn.ModuleList(
            [nn.Conv2d(nf, nf, 3, padding=pad) for _ in in_channels])
        if cfg.use_conv_downsample:
            self.downsample_layers = nn.ModuleList(
                [nn.Conv2d(nf, nf, 3, stride=2, padding=1)
                 for _ in range(cfg.num_downsample)])

    def forward(self, convouts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        c = self.cfg
        n = len(convouts)
        out: List[torch.Tensor] = [None] * n
        x = None
        for i, lat in enumerate(self.lat_layers):
            j = n - 1 - i
            lat_out = lat(convouts[j])
            x = lat_out if x is None else (
                resize_bilinear(x, convouts[j].shape[-2:]) + lat_out)
            out[j] = x
        for i, pred in enumerate(self.pred_layers):
            j = n - 1 - i
            y = pred(out[j])
            out[j] = F.relu(y) if c.relu_pred_layers else y
        for d in range(c.num_downsample):
            if c.use_conv_downsample:
                y = self.downsample_layers[d](out[-1])
                if c.relu_downsample_layers:
                    y = F.relu(y)
            else:
                y = F.max_pool2d(out[-1], 1, stride=2)
            out.append(y)
        return out
