"""Model-FLOP count of a call, taken from shapes: the count a model-FLOP
share of the step reads (``scripts/mfu.py``).

The counting rule:

* ATen's convolutions and matrix products (``convolution`` and its
  backward, ``mm``, ``addmm``, ``bmm``, ``baddbmm``, and what decomposes
  into them: ``linear``, ``matmul``, ``einsum``) count as
  ``torch.utils.flop_counter.FlopCounterMode`` counts them, two FLOPs a
  multiply-add.
* Each ``stmask::`` custom op counts once, at the op, from its arguments'
  shapes, whichever implementation runs: the kernel on a CUDA tensor or
  the plain version on a CPU tensor.  The counter sees the op and nothing
  of what runs inside it, so a plain version's own matrix products are not
  counted again.  The ops' public entries (``ops/correlation.py``,
  ``ops/deform_conv.py``, and the backward they call) always pass through
  the op with autograd off, so the forward and the backward count the same
  on both devices:

  - ``stmask::deform_conv`` (fp32 and the bf16 entries):
    2 B Ho Wo K Cin Cout, the product of the gathered [B Ho Wo, K Cin]
    columns with the [K Cin, Cout] weight;
  - ``stmask::deform_wgrad``: 2 B Ho Wo K Cin Cout, the transposed
    product that gives the weight gradient;
  - ``stmask::correlate``: 2 B H W P^2 C (P the patch, 11);
  - ``stmask::correlation_bwd``: 4 B H W P^2 C, the two contractions of
    the forward's size that give dx1 and dx2;
  - ``stmask::deform_col2im`` and ``stmask::deform_exact_bwd``: 0, the
    adjoint of the bilinear gather;
  - the greedy-NMS ops: not counted (comparisons).
* The bilinear gather, its adjoint, resizes, reductions and every other
  elementwise op count nothing: ``FlopCounterMode`` counts no elementwise
  op, so neither the kernel nor the plain version counts them.  (The JAX
  package's ``jax.image.resize`` runs as products with interpolation
  matrices; a count of its jaxpr leaves them out for the same reason.)

Bytes are the sum over the counted ops (the ops with a formula, 0 ones
included) of each distinct input tensor read once and each output
written once: what the counted work must move at the least, not what the
whole step moves.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from .. import kernels  # noqa: F401  (registers the stmask:: ops)

# published peaks of one NVIDIA H100 SXM (dense, at the 700 W limit)
PEAK_FLOPS = {'bf16': 989e12, 'tf32': 495e12, 'fp32': 67e12}
PEAK_BYTES_PER_S = 3.35e12


def deform_conv_flops(b: int, ho: int, wo: int, k: int, cin: int,
                      cout: int) -> int:
    return 2 * b * ho * wo * k * cin * cout


def correlate_flops(b: int, h: int, w: int, c: int, patch: int = 11) -> int:
    return 2 * b * h * w * patch * patch * c


def _deform_conv(x, offset, weight, *args, out_shape=None, **kwargs):
    b, ho, wo, _ = offset
    cout, kh, kw, cin = weight
    return deform_conv_flops(b, ho, wo, kh * kw, cin, cout)


def _deform_wgrad(g, x, offset, mask, kh, kw, *args, out_shape=None,
                  **kwargs):
    return deform_conv_flops(1, 1, g[0], kh * kw, x[3], g[1])


def _correlate(x1, x2, patch_size, *args, out_shape=None, **kwargs):
    b, h, w, c = x1
    return correlate_flops(b, h, w, c, patch_size)


def _correlation_bwd(g, x1, x2, patch_size, *args, out_shape=None,
                     **kwargs):
    b, h, w, c = x1
    return 2 * correlate_flops(b, h, w, c, patch_size)


def _gather_adjoint(*args, out_shape=None, **kwargs):
    return 0


for _op, _formula in ((torch.ops.stmask.deform_conv, _deform_conv),
                      (torch.ops.stmask.deform_wgrad, _deform_wgrad),
                      (torch.ops.stmask.correlate, _correlate),
                      (torch.ops.stmask.correlation_bwd, _correlation_bwd),
                      (torch.ops.stmask.deform_col2im, _gather_adjoint),
                      (torch.ops.stmask.deform_exact_bwd, _gather_adjoint)):
    register_flop_formula(_op)(_formula)


def _nbytes(tree) -> int:
    seen, n = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            n += t.numel() * t.element_size()
    return n


@dataclass
class Count:
    """What a call counted: model FLOPs, the bytes of the counted ops, and
    the FLOPs and bytes by op (``aten.convolution``, ``stmask.correlate``,
    ...)."""
    flops: int = 0
    bytes: int = 0
    flops_by_op: Dict[str, int] = field(default_factory=dict)
    bytes_by_op: Dict[str, int] = field(default_factory=dict)


class _Counter(FlopCounterMode):
    """``FlopCounterMode`` that also adds up the bytes of the ops it
    counts."""

    def __init__(self):
        super().__init__(display=False)
        self.bytes_by_op: Dict[Any, int] = defaultdict(int)

    def _count_flops(self, func_packet, out, args, kwargs):
        if func_packet in self.flop_registry:
            self.bytes_by_op[func_packet] += (_nbytes((args, kwargs))
                                              + _nbytes(out))
        return super()._count_flops(func_packet, out, args, kwargs)


def count(fn: Callable, *args, **kwargs) -> Tuple[Any, Count]:
    """Run ``fn(*args, **kwargs)`` once under the counter; returns (its
    result, the Count)."""
    with _Counter() as counter:
        result = fn(*args, **kwargs)
    by_op = {str(k): v for k, v in
             counter.get_flop_counts().get('Global', {}).items()}
    nbytes = {str(k): v for k, v in counter.bytes_by_op.items()}
    flops = counter.get_total_flops()
    if by_op and not nbytes:
        raise RuntimeError('the flop counter counted ops but no bytes: '
                           "this torch's FlopCounterMode no longer calls "
                           '_count_flops')
    return result, Count(flops, sum(nbytes.values()), by_op, nbytes)
