"""FastMaskIoUNet, the optional mask re-scoring subnet (port of
``stmask_tpu/models/maskiou.py``; reference
``layers/modules/FastMaskIoUNet.py:22-33``, after Mask Scoring R-CNN).

Five stride-2 3x3 conv + ReLU layers over a soft mask, a 1x1 classifier
with ReLU, then a global max: the predicted mask IoU of each class.  The
JAX package's converter maps no reference key to it, so its modules carry
the flax names (``maskiou_net.conv0`` .. ``conv4``, ``classifier``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# (channels, ksize, stride) of the conv stack before the classifier
NET_SPEC = ((8, 3, 2), (16, 3, 2), (32, 3, 2), (64, 3, 2), (128, 3, 2))


class FastMaskIoUNet(nn.Module):
    def __init__(self, num_classes: int,
                 net_spec: Tuple[Tuple[int, int, int], ...] = NET_SPEC):
        super().__init__()
        self.convs = []
        cin = 1
        for i, (ch, k, s) in enumerate(net_spec):
            self.add_module(f'conv{i}', nn.Conv2d(cin, ch, k, stride=s,
                                                  padding=(k - 1) // 2))
            self.convs.append(f'conv{i}')
            cin = ch
        self.classifier = nn.Conv2d(cin, num_classes - 1, 1)

    def forward(self, masks: torch.Tensor) -> torch.Tensor:
        """masks: [N, H, W, 1] soft masks -> [N, num_classes - 1] IoU
        predictions.  Computes in the promoted type of the masks and the
        weights, as flax does: fp32 masks on bf16 weights run in fp32."""
        dt = torch.promote_types(masks.dtype, self.classifier.weight.dtype)
        x = masks.permute(0, 3, 1, 2).to(dt)
        for conv in [getattr(self, n) for n in self.convs] + [
                self.classifier]:
            x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                                conv.stride, conv.padding))
        return x.amax(dim=(2, 3))
