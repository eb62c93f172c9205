"""Modulated deformable conv (port of ``stmask_tpu/ops/deform_conv.py``:
the exact ``deform_conv2d``, the window-clamped ``deform_conv2d_window``
that training runs, here ``deform_conv_window``, and ``dcn_v2_offsets``).

Per kernel tap k, sample x bilinearly at ``p*stride - pad + k*dilation +
offset_k`` (zero outside the image), scale by the modulation m_k, contract
the [K*Cin] gathered values with the weight and add the bias.  On the card
that is one fused kernel (``kernels.deform_conv``, no ``cols`` matrix in
device memory); on the CPU its plain version.

The window path clamps the offsets to [-r, r] first.  Bilinear sampling at
a clamped offset is exactly the JAX package's hat-weight window sum, so the
forward is the same fused kernel.  Its backward (``_DeformConvWindow``)
follows the JAX package's gradient, not DCNv2's: K2 rebuilds ``cols``, two
matmuls give the weight and column gradients, and K4 (``kernels.
deform_col2im``) gives those of x, offset and mask with JAX's subgradients
at integer offsets.  The clamp's own gradient is JAX's ``jnp.clip``'s: 1
inside, 0.5 at +-r, 0 beyond.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.deform_col2im import deform_col2im
from ..kernels.deform_conv import deform_conv
from ..kernels.deform_im2col import deform_im2col


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


class _WindowClamp(torch.autograd.Function):
    """``clip(offset, -r, r)`` with ``jnp.clip``'s gradient."""

    @staticmethod
    def forward(ctx, offset, radius):
        ctx.save_for_backward(offset)
        ctx.radius = radius
        return torch.clamp(offset, -radius, radius)

    @staticmethod
    def backward(ctx, g):
        (offset,) = ctx.saved_tensors
        a = offset.abs()
        r = ctx.radius
        fac = torch.where(a < r, 1.0, torch.where(a == r, 0.5, 0.0))
        return g * fac, None


class _DeformConvWindow(torch.autograd.Function):
    """The fused deformable conv on clamped offsets, with the JAX package's
    window backward.  ``weight`` is [Cout, kh, kw, Cin] (a channels-last
    OIHW parameter's view); its gradient comes back contiguous in that
    layout, so autograd hands the parameter a channels-last gradient
    without a copy."""

    @staticmethod
    def forward(ctx, x, offset, weight, mask, bias, stride, dilation,
                radius):
        ctx.conf = (stride, dilation, radius)
        ctx.save_for_backward(x, offset, weight, mask)
        ctx.has_bias = bias is not None
        return deform_conv(x, offset, weight, mask, bias, stride, dilation)

    @staticmethod
    def backward(ctx, g):
        x, offset, weight, mask = ctx.saved_tensors
        stride, dilation, radius = ctx.conf
        cout, kh, kw, cin = weight.shape
        g = g.contiguous().reshape(-1, cout)              # [M, Cout]
        w2 = weight.reshape(cout, kh * kw * cin)
        cols = deform_im2col(x, offset, mask, kh, kw, stride, dilation)
        d_w = (g.t() @ cols).reshape(cout, kh, kw, cin)
        del cols                                          # free per site
        dcols = g @ w2                                    # [M, K*Cin]
        dx, d_off, d_mask = deform_col2im(dcols, x, offset, mask, kh, kw,
                                          stride, dilation, radius)
        d_b = g.sum(dim=0) if ctx.has_bias else None
        return dx, d_off, d_w, d_mask, d_b, None, None, None


def deform_conv_window(x: torch.Tensor, offset: torch.Tensor,
                       weight: torch.Tensor, mask: Optional[torch.Tensor],
                       bias: Optional[torch.Tensor], stride: int = 1,
                       dilation: int = 1, radius: int = 2) -> torch.Tensor:
    """Window-clamped deformable conv, differentiable, in the kernels'
    layouts: x [B, H, W, Cin] contiguous, offset [B, Ho, Wo, 2K], weight
    [Cout, kh, kw, Cin] contiguous, mask [B, Ho, Wo, K] or None, bias
    [Cout] or None -> [B, Ho, Wo, Cout]."""
    if radius < 1:
        raise ValueError(f'window radius {radius} < 1')
    offset = _WindowClamp.apply(offset, radius).contiguous()
    if mask is not None:
        mask = mask.contiguous()
    return _DeformConvWindow.apply(x, offset, weight, mask, bias, stride,
                                   dilation, radius)


def dcn_v2_offsets(conv_out: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a DCNv2 ``conv_offset_mask`` output [B, H, W, 3K] into
    (offset [B, H, W, 2K], mask [B, H, W, K]).

    The first 2K channels already are the (dy, dx)-interleaved offsets the
    DCNv2 CUDA kernel reads; no permutation is applied."""
    return conv_out[..., :2 * k], torch.sigmoid(conv_out[..., 2 * k:])
