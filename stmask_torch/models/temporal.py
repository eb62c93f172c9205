"""Temporal-fusion net (port of ``stmask_tpu/models/temporal.py``;
reference ``layers/modules/track_to_segment_head.py:10-37``): three 3x3
convs, a 7x7 average pool and two FC heads for the box shift and the
mask-coefficient shift."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class TemporalNet(nn.Module):
    def __init__(self, corr_channels: int, mask_proto_n: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(corr_channels, 512, 3, padding=1)
        self.conv2 = nn.Conv2d(512, 512, 3, padding=1)
        self.conv3 = nn.Conv2d(512, 1024, 3, padding=1)
        self.fc = nn.Linear(1024, 4)
        self.fc_coeff = nn.Linear(1024, mask_proto_n)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [N, 7, 7, C] NHWC -> (box_shift [N, 4], coeff_shift [N, 32])."""
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = F.relu(self.conv3(x))
        x = x.mean(dim=(2, 3))        # 7x7 avg pool, stride 1 == mean
        return self.fc(x), self.fc_coeff(x)
