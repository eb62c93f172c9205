"""Cross-frame local correlation, differentiable (port of
``stmask_tpu/ops/correlation.py::correlate``).

For every site, the channel dot product between frame-1 features and
frame-2 features displaced by (dy, dx) in [-r, r]^2, zero outside the image,
output channel ``(dy+r)*patch + (dx+r)``, divided by the channel count and
passed through leaky-relu(0.1) (reference
``layers/modules/track_to_segment_head.py:40-62``).  A CPU tensor takes the
plain PyTorch versions; a CUDA tensor takes kernel K1 forward and kernel K3
backward, one launch each.

The leaky ReLU's derivative is JAX's: 1 where the output is >= 0 (so 1 at
exactly 0, where ``F.leaky_relu``'s backward gives 0.1), else 0.1.  Border
displacements produce exact zeros, so the difference is real.  K3 (and its
plain version) applies it from the saved output.
"""

from __future__ import annotations

import torch

from ..kernels.correlation import correlate as _correlate
from ..kernels.correlation_bwd import correlation_bwd, pixel_stride


class _Correlate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, patch_size, apply_activation):
        out = _correlate(x1, x2, patch_size, apply_activation)
        ctx.patch_size = patch_size
        ctx.apply_activation = apply_activation
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x1, x2, out = ctx.saved_tensors
        if pixel_stride(g) is None:      # K3 reads channel slices in place
            g = g.contiguous()
        dx1, dx2 = correlation_bwd(g, x1, x2, ctx.patch_size,
                                   out if ctx.apply_activation else None)
        return dx1, dx2, None, None


def correlate(x1: torch.Tensor, x2: torch.Tensor, patch_size: int = 11,
              apply_activation: bool = True) -> torch.Tensor:
    """[B, H, W, C] x2 -> [B, H, W, patch^2] cost volume.  On the card both
    inputs must be contiguous fp32."""
    return _Correlate.apply(x1, x2, patch_size, apply_activation)
