"""FCA multi-kernel prediction head (port of
``stmask_tpu/models/heads.py::PredictionHead``; reference
``layers/modules/prediction_head_FC.py:13-247``).

One module is applied to every FPN level.  Per head bank k in
{3x3, 3x5, 5x3} it emits box regression, class scores, centerness (tanh),
a 128-d L2-normalized tracking embedding and 32 mask coefficients.  FCB
(``FeatureAlign``) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import STMaskConfig


class PredictionHead(nn.Module):
    """Shared FCA head; parameter names follow ``prediction_layers.0.*``."""

    def __init__(self, cfg: STMaskConfig, in_channels: int = 256):
        super().__init__()
        if cfg.use_dcn_class or cfg.use_dcn_track or cfg.use_dcn_mask:
            raise NotImplementedError(
                'FCB deformable alignment (use_dcn_*) is not ported yet '
                '(ROADMAP A.10)')
        if not (cfg.train_centerness and cfg.train_track):
            raise NotImplementedError(
                'the ported FCA head always has centerness and track banks')
        self.cfg = cfg
        ch = cfg.extra_head_net_channels
        n_scales = len(cfg.pred_scales[0])
        self.upfeature = nn.Sequential(nn.Conv2d(in_channels, ch, 3,
                                                 padding=1))

        def extra(n_layers: int) -> nn.Sequential:
            mods = []
            for _ in range(n_layers):
                mods += [nn.Conv2d(ch, ch, 3, padding=1), nn.ReLU()]
            return nn.Sequential(*mods)

        self.conf_extra = extra(cfg.extra_layers[0])
        self.bbox_extra = extra(cfg.extra_layers[1])
        self.track_extra = extra(cfg.extra_layers[2])
        self.mask_extra = extra(cfg.extra_layers[3])

        def bank(out_ch: int) -> nn.ModuleList:
            return nn.ModuleList([
                nn.Conv2d(ch, out_ch, (kh, kw),
                          padding=((kh - 1) // 2, (kw - 1) // 2))
                for kh, kw in cfg.head_kernel_sizes])

        self.bbox_layer = bank(n_scales * 4)
        self.centerness_layer = bank(n_scales)
        self.conf_layer = bank(n_scales * cfg.num_classes)
        self.track_layer = bank(n_scales * cfg.embed_dim)
        self.mask_layer = bank(n_scales * cfg.mask_proto_n)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] -> flat [B, H*W*A, D] outputs plus ``T2S_feat``
        (NCHW)."""
        c = self.cfg
        b, _, h, w = x.shape
        n_scales = len(c.pred_scales[0])
        x = F.relu(self.upfeature(x))
        conf_x = self.conf_extra(x)
        bbox_x = self.bbox_extra(x)
        track_x = self.track_extra(x)
        mask_x = self.mask_extra(x)

        def nhwc(layers: nn.ModuleList, inp: torch.Tensor
                 ) -> List[torch.Tensor]:
            return [m(inp).permute(0, 2, 3, 1) for m in layers]

        # Anchor interleave: per spatial position, banks are contiguous,
        # then scales (reference prediction_head_FC.py:185-195).
        def interleave(banks: List[torch.Tensor], dim: int) -> torch.Tensor:
            banks = [bk.reshape(b, h * w, n_scales, dim) for bk in banks]
            return torch.stack(banks, dim=2).reshape(b, -1, dim)

        # Reference quirk kept for checkpoint parity: centerness banks are
        # concatenated along H (bank-major over the whole level), NOT
        # position-interleaved like every other branch.
        cent = torch.cat(nhwc(self.centerness_layer, bbox_x), dim=1)
        track = interleave(nhwc(self.track_layer, track_x), c.embed_dim)
        return {
            'loc': interleave(nhwc(self.bbox_layer, bbox_x), 4),
            'conf': interleave(nhwc(self.conf_layer, conf_x), c.num_classes),
            'mask_coeff': interleave(nhwc(self.mask_layer, mask_x),
                                     c.mask_proto_n),
            'centerness': torch.tanh(cent.reshape(b, -1, 1)),
            'track': track / torch.clamp(
                torch.linalg.vector_norm(track, dim=-1, keepdim=True),
                min=1e-12),
            'T2S_feat': x,
        }
