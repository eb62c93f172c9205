"""Shared NN building blocks (port of ``stmask_tpu/models/layers.py``).

Modules take and return NCHW tensors (the model keeps them in the
channels-last memory format); parameter names follow the reference
PyTorch ``state_dict``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize, ``align_corners=False`` (the JAX side's
    ``jax.image.resize(method='bilinear')``; on the model's path every
    resize is an exact x2 upsample, where the two agree)."""
    return F.interpolate(x, size=tuple(size), mode='bilinear',
                         align_corners=False)


class FrozenBatchNorm(nn.Module):
    """BatchNorm evaluated with stored statistics, folded in fp32.

    Tensors carry the reference BatchNorm2d names (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``) so a
    reference checkpoint loads with plain ``load_state_dict``.  All are
    buffers; ``set_bn_affine_trainable`` makes ``weight`` and ``bias``
    parameters (``freeze_bn=False``), and the statistics stay buffers.
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer('weight', torch.ones(features))
        self.register_buffer('bias', torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))
        self.register_buffer('num_batches_tracked',
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight.float() * torch.rsqrt(self.running_var.float()
                                                + self.eps)
        shift = self.bias.float() - self.running_mean.float() * inv
        return (x * inv.to(x.dtype)[None, :, None, None]
                + shift.to(x.dtype)[None, :, None, None])


def set_bn_affine_trainable(model: nn.Module, trainable: bool) -> None:
    """Turn every ``FrozenBatchNorm``'s ``weight`` and ``bias`` into
    parameters (``trainable``) or back into buffers, in place, keeping
    their tensors.  The ``state_dict`` keys do not change; the running
    statistics are never trained (JAX ``train_step.py:35-48``)."""
    for m in model.modules():
        if not isinstance(m, FrozenBatchNorm):
            continue
        for name in ('weight', 'bias'):
            t = getattr(m, name)
            if trainable and not isinstance(t, nn.Parameter):
                del m._buffers[name]
                m.register_parameter(name, nn.Parameter(t))
            elif not trainable and isinstance(t, nn.Parameter):
                del m._parameters[name]
                m.register_buffer(name, t.detach())


class Upsample(nn.Module):
    """Bilinear x``factor`` upsample (the make_net ``(None, -k)`` entry)."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        return resize_bilinear(x, (h * self.factor, w * self.factor))


class MakeNet(nn.Sequential):
    """Sequential net from a make_net-style spec (reference
    ``layers/modules/make_net.py:5-57``).

    spec entries: (channels, ksize, pad); ksize > 0 is a conv, ksize < 0
    with channels None a bilinear x|ksize| upsample.  Every layer is
    followed by ReLU (optionally except the last), so Sequential indices
    match the reference ``state_dict`` (``proto_net.0``, ``.2``, ...).
    """

    def __init__(self, in_channels: int,
                 spec: Sequence[Tuple[Optional[int], int, int]],
                 include_last_relu: bool = True):
        layers = []
        ch = in_channels
        for i, (out_ch, k, pad) in enumerate(spec):
            if k > 0:
                layers.append(nn.Conv2d(ch, out_ch, k, padding=pad))
                ch = out_ch
            elif out_ch is None:
                layers.append(Upsample(-k))
            else:
                raise NotImplementedError(
                    'make_net deconv entries are not ported (no preset '
                    'uses them)')
            if i < len(spec) - 1 or include_last_relu:
                layers.append(nn.ReLU())
        super().__init__(*layers)
