"""Lincomb mask assembly: ``proto @ coeff.T`` + box crop (port of
``stmask_tpu/ops/masks.py``; reference ``layers/mask_utils.py:111-128``)."""

from __future__ import annotations

from typing import Optional

import torch

from .boxes import crop


def coeff_activation(coeff: torch.Tensor, kind: str = 'tanh'
                     ) -> torch.Tensor:
    if kind == 'tanh':
        return torch.tanh(coeff)
    if kind == 'none':
        return coeff
    raise ValueError(kind)


def generate_mask(proto: torch.Tensor, mask_coeff: torch.Tensor,
                  bbox: Optional[torch.Tensor] = None,
                  apply_coeff_activation: bool = True) -> torch.Tensor:
    """Assemble instance masks from prototypes.

    Args:
      proto: [..., h, w, k] prototype masks (already through proto
        activation); the leading dims (e.g. a lane axis) are shared with
        the coefficients and boxes, and the product is one (batched)
        matmul.
      mask_coeff: [..., n, k] raw coefficients (tanh applied here).
      bbox: optional [..., n, 4] normalized point-form boxes for cropping.
    Returns:
      [..., n, h, w] soft masks in [0, 1].
    """
    if apply_coeff_activation:
        mask_coeff = torch.tanh(mask_coeff)
    lead = proto.shape[:-3]
    h, w, k = proto.shape[-3:]
    masks = (proto.reshape(*lead, h * w, k) @ mask_coeff.transpose(-1, -2)
             ).reshape(*lead, h, w, -1)
    masks = torch.sigmoid(masks)
    if bbox is not None:
        _, masks = crop(masks, bbox)
    return masks.movedim(-1, -3)
