"""Legacy single-kernel YOLACT prediction module (port of
``stmask_tpu/models/legacy_head.py``; reference
``layers/modules/prediction_head.py:15-239``), the head of
``YOLACT_legacy_resnet50``.

One 3x3 bank shared by all FPN levels, aspect-ratio x scale anchors per
position (``ops/anchors.py::make_yolact_priors``).  Parameter names are
the reference ``state_dict`` keys under ``prediction_layers.0``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn


class PredictionModule(nn.Module):
    """Single-kernel YOLACT head: ``upfeature`` 3x3 + ReLU, then 3x3 box,
    class and mask-coefficient convs; the coefficients stay raw (tanh is
    applied downstream, as for the FCA head)."""

    def __init__(self, in_channels: int, num_classes: int,
                 mask_dim: int = 32, num_priors: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.mask_dim = mask_dim
        ch = 256                # the JAX module's extra_head_channels
        self.upfeature = nn.Sequential(
            nn.Conv2d(in_channels, ch, 3, padding=1), nn.ReLU())
        self.bbox_layer = nn.Conv2d(ch, num_priors * 4, 3, padding=1)
        self.conf_layer = nn.Conv2d(ch, num_priors * num_classes, 3,
                                    padding=1)
        self.mask_layer = nn.Conv2d(ch, num_priors * mask_dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] -> flat [B, H*W*A, D] loc, conf, mask_coeff."""
        b = x.shape[0]
        x = self.upfeature(x)

        def flat(layer: nn.Module, dim: int) -> torch.Tensor:
            return layer(x).permute(0, 2, 3, 1).reshape(b, -1, dim)

        return {'loc': flat(self.bbox_layer, 4),
                'conf': flat(self.conf_layer, self.num_classes),
                'mask_coeff': flat(self.mask_layer, self.mask_dim)}
