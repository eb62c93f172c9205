"""FCA multi-kernel prediction head and FCB feature alignment (port of
``stmask_tpu/models/heads.py``: ``PredictionHead``, ``FeatureAlign``,
``_ali_offsets``; reference ``layers/modules/prediction_head_FC.py:13-247``
and ``layers/modules/Featurealign.py:6-74``).

One module is applied to every FPN level.  Per head bank k in
{3x3, 3x5, 5x3} it emits box regression, class scores, centerness (tanh),
a 128-d L2-normalized tracking embedding and 32 mask coefficients.  FCB
(``use_dcn_class`` / ``_track`` / ``_mask``) replaces a bank's conv with a
``FeatureAlign``: a v1 deformable conv whose offsets come from the bank's
detached box regression, predicted by a 1x1 conv (``ada``) or derived from
the box deltas (``ali``), then ReLU and the bank's conv.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import STMaskConfig
from ..kernels.deform_conv import deform_conv
from ..ops.deform_conv import deform_conv_window


def _ali_offsets(shape: torch.Tensor, ks: Tuple[int, int]) -> torch.Tensor:
    """Analytic FCB offsets from box deltas (``heads.py:29-59``; reference
    ``Featurealign.py:46-69``).

    Args:
      shape: [B, H, W, >= 4] detached box regression (dx, dy, dw, dh).
    Returns:
      [B, H, W, 2*kh*kw] float32 offsets, (dy, dx) interleaved per tap,
      taps row-major.  From bf16 deltas the JAX package rounds
      ``shape * 0.1 * k`` and ``exp(shape * 0.2) - 1`` to bf16 at each
      operation (its Python scalars take the array's type), and the float32
      tap grid promotes the rest to float32; so does this.
    """
    ks_h, ks_w = ks
    dt, dev = shape.dtype, shape.device

    def c(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=dt, device=dev)

    dx = shape[..., 0] * c(0.1) * c(ks_w)                 # [B, H, W]
    dy = shape[..., 1] * c(0.1) * c(ks_h)
    dw = torch.exp(shape[..., 2] * c(0.2)) - c(1.0)
    dh = torch.exp(shape[..., 3] * c(0.2)) - c(1.0)
    f32 = dict(dtype=torch.float32, device=dev)
    grid_y = torch.arange(-(ks_h // 2), ks_h // 2 + 1, **f32
                          ).repeat_interleave(ks_w)       # [k] row-major
    grid_x = torch.arange(-(ks_w // 2), ks_w // 2 + 1, **f32).repeat(ks_h)
    off_y = dy[..., None] + dh[..., None] * grid_y        # [B, H, W, k]
    off_x = dx[..., None] + dw[..., None] * grid_x
    return torch.stack([off_y, off_x], dim=-1).reshape(
        shape.shape[:-1] + (2 * ks_h * ks_w,))


class DeformAdaption(nn.Module):
    """The reference's mmcv ``DeformConv2d`` (v1, no bias, one deform
    group): a bare ``weight`` [Cin, Cin, kh, kw] under
    ``conv_adaption.weight``."""

    def __init__(self, channels: int, kh: int, kw: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels, channels, kh, kw))


class FeatureAlign(nn.Module):
    """FCB for one bank (``heads.py:84-129``): ``conv_offset`` (ada only),
    ``conv_adaption`` and ``conv``, as the reference names them.

    Eval takes the exact gather (``kernels.deform_conv.deform_conv``, no
    clamp; the JAX package ignores ``dcn_window_eval`` here); training the
    window-clamped op at ``radius`` with its backward.  The fused kernel
    reads the weight as [Cout, kh, kw, Cin]: the channels-last OIHW
    parameter's view, no copy."""

    def __init__(self, channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], use_pred_offset: bool,
                 radius: int, shape_channels: int = 4):
        super().__init__()
        kh, kw = kernel_size
        self.kernel_size = (kh, kw)
        self.radius = radius
        self.conv_offset = (nn.Conv2d(shape_channels, 2 * kh * kw, 1,
                                      bias=False)
                            if use_pred_offset else None)
        self.conv_adaption = DeformAdaption(channels, kh, kw)
        self.conv = nn.Conv2d(channels, out_channels, (kh, kw),
                              padding=((kh - 1) // 2, (kw - 1) // 2))

    def forward(self, x: torch.Tensor, shape: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """x: [B, C, H, W] features; shape: [B, 4, H, W] the bank's box
        regression (detached here) -> [B, out, H, W]."""
        shape = shape.detach()
        if self.conv_offset is not None:
            offset = self.conv_offset(shape).permute(0, 2, 3, 1)
        else:
            offset = _ali_offsets(shape.permute(0, 2, 3, 1),
                                  self.kernel_size)
        xh = x.permute(0, 2, 3, 1).contiguous()          # NHWC, no copy
        weight = self.conv_adaption.weight.permute(0, 2, 3, 1).contiguous()
        if not train:
            out = deform_conv(xh, offset, weight, None, None)
        elif self.radius > 0:
            out = deform_conv_window(xh, offset, weight, None, None,
                                     radius=self.radius)
        else:
            raise NotImplementedError(
                'training FCB through the exact gather (fcb_window_radius '
                '0) is not ported (ROADMAP A.9e)')
        return self.conv(F.relu(out.permute(0, 3, 1, 2)))


class PredictionHead(nn.Module):
    """Shared FCA head; parameter names follow ``prediction_layers.0.*``."""

    def __init__(self, cfg: STMaskConfig, in_channels: int = 256):
        super().__init__()
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

        def bank(out_ch: int, align: bool = False) -> nn.ModuleList:
            if align:           # FCB: the reference's FeatureAlign banks
                return nn.ModuleList([
                    FeatureAlign(ch, out_ch, ks, cfg.use_pred_offset,
                                 cfg.fcb_window_radius, n_scales * 4)
                    for ks in cfg.head_kernel_sizes])
            return nn.ModuleList([
                nn.Conv2d(ch, out_ch, (kh, kw),
                          padding=((kh - 1) // 2, (kw - 1) // 2))
                for kh, kw in cfg.head_kernel_sizes])

        self.bbox_layer = bank(n_scales * 4)
        self.centerness_layer = bank(n_scales)
        self.conf_layer = bank(n_scales * cfg.num_classes, cfg.use_dcn_class)
        self.track_layer = bank(n_scales * cfg.embed_dim, cfg.use_dcn_track)
        self.mask_layer = bank(n_scales * cfg.mask_proto_n, cfg.use_dcn_mask)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] -> flat [B, H*W*A, D] outputs plus ``T2S_feat``
        (NCHW).  ``train`` takes FCB's window-clamped deformable conv."""
        c = self.cfg
        b, _, h, w = x.shape
        n_scales = len(c.pred_scales[0])
        x = F.relu(self.upfeature(x))
        conf_x = self.conf_extra(x)
        bbox_x = self.bbox_extra(x)
        track_x = self.track_extra(x)
        mask_x = self.mask_extra(x)

        bbox = [m(bbox_x) for m in self.bbox_layer]

        def nhwc(layers: nn.ModuleList, inp: torch.Tensor
                 ) -> List[torch.Tensor]:
            return [(m(inp, bb, train) if isinstance(m, FeatureAlign)
                     else m(inp)).permute(0, 2, 3, 1)
                    for m, bb in zip(layers, bbox)]

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
            'loc': interleave([bb.permute(0, 2, 3, 1) for bb in bbox], 4),
            'conf': interleave(nhwc(self.conf_layer, conf_x), c.num_classes),
            'mask_coeff': interleave(nhwc(self.mask_layer, mask_x),
                                     c.mask_proto_n),
            'centerness': torch.tanh(cent.reshape(b, -1, 1)),
            'track': track / torch.clamp(
                torch.linalg.vector_norm(track, dim=-1, keepdim=True),
                min=1e-12),
            'T2S_feat': x,
        }
