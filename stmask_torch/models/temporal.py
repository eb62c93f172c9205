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
        """x: [N, 7, 7, C] NHWC -> (box_shift [N, 4], coeff_shift [N, 32]).

        Computes in x's dtype, the weights cast to it, as flax promotes a
        layer's parameters to its input: with bf16 weights the tracker
        hands it fp32 features (``tracker.candidate_shift``), so it runs
        in fp32 on the bf16-rounded weights, as on the TPU."""
        def conv(m: nn.Conv2d, t: torch.Tensor) -> torch.Tensor:
            return F.relu(F.conv2d(t, m.weight.to(t.dtype),
                                   m.bias.to(t.dtype), padding=1))

        def fc(m: nn.Linear, t: torch.Tensor) -> torch.Tensor:
            return F.linear(t, m.weight.to(t.dtype), m.bias.to(t.dtype))

        x = x.permute(0, 3, 1, 2)
        x = conv(self.conv3, conv(self.conv2, conv(self.conv1, x)))
        x = x.mean(dim=(2, 3))        # 7x7 avg pool, stride 1 == mean
        return fc(self.fc, x), fc(self.fc_coeff, x)
