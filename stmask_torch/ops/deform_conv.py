"""Modulated deformable conv, eval path (port of the exact, unclamped
``stmask_tpu/ops/deform_conv.py::deform_conv2d`` and ``dcn_v2_offsets``).

Per kernel tap k, sample x bilinearly at ``p*stride - pad + k*dilation +
offset_k`` (zero outside the image), scale by the modulation m_k, contract
the [K*Cin] gathered values with the weight and add the bias.  On the card
that is one fused kernel (``kernels.deform_conv``, no ``cols`` matrix in
device memory); on the CPU its plain version, the gather of
``kernels.deform_im2col_reference`` and one matmul.  The window-clamped
training path and its custom backward are not ported (ROADMAP B1b).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.deform_conv import deform_conv


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                  weight: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None, stride: int = 1,
                  dilation: int = 1) -> torch.Tensor:
    """Deformable conv (v2 when ``mask`` is given, else v1), NHWC.

    Args:
      x: [B, H, W, Cin].
      offset: [B, Ho, Wo, 2*K] with (dy, dx) interleaved per tap.
      weight: [kh, kw, Cin, Cout] (HWIO).
      mask: optional [B, Ho, Wo, K] modulation (already sigmoid-ed).
    Returns:
      [B, Ho, Wo, Cout].

    The kernel reads the weight as [Cout, kh, kw, Cin]; a module that keeps
    its weight in that layout calls ``kernels.deform_conv.deform_conv``
    directly and copies nothing.
    """
    return deform_conv(x.contiguous(), offset,
                       weight.permute(3, 0, 1, 2).contiguous(), mask,
                       None if bias is None else bias.contiguous(), stride,
                       dilation)


def dcn_v2_offsets(conv_out: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a DCNv2 ``conv_offset_mask`` output [B, H, W, 3K] into
    (offset [B, H, W, 2K], mask [B, H, W, K]).

    The first 2K channels already are the (dy, dx)-interleaved offsets the
    DCNv2 CUDA kernel reads; no permutation is applied."""
    return conv_out[..., :2 * k], torch.sigmoid(conv_out[..., 2 * k:])
