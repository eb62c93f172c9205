"""The bf16 training ops of the port against the JAX package's on the CPU:
``ops.deform_conv.deform_conv_window`` against ``deform_conv2d_window``,
and ``ops.correlation.correlate`` (cast to bf16, as the training forward
casts it) against JAX's XLA ``correlate``, forward and VJP, with bf16 data.

The port's CPU path runs the plain versions of the kernels' bf16 entries
(``deform_wgrad``, K4 and K3), which sum in fp32 and round each result
once; JAX sums its window gather and its correlation's transpose in bf16
(``stmask_tpu/ops/deform_conv.py:130-264``), rounding at every add.  So the
two differ by JAX's accumulated roundings: a bf16 value carries a relative
error of up to 2^-9, and a sum of n bf16 adds up to n of them.  Each result
is held to JAX's within TOL of max|JAX| (the window sums have 16 to 36
terms a tap; measured differences are 2^-9 to 2^-6 of max|JAX|), and to
the types JAX gives: bf16 for x, the weight, the mask and the bias, the
offsets' own type for the offsets (bf16, or FCB's fp32).  The 3x3 stride-1
case runs at the trained window radius 2; the others at radius 1, which
halves JAX's compile ((2r + 2)^2 static slices a tap).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.ops.correlation import correlate as j_correlate
from stmask_tpu.ops.deform_conv import deform_conv2d_window as j_window

from stmask_torch.ops.correlation import correlate
from stmask_torch.ops.deform_conv import deform_conv_window
from torch_eval_common import few_torch_threads  # noqa: F401

TOL = 2.0 ** -5

# (H, W, Cin, Cout, kh, kw, stride, modulated and biased, window radius):
# the backbone's 3x3 sites at stride 1 and 2 (DCNv2), FCB's 3x5 and 5x3
# (v1, no bias)
WINDOW_CASES = {'3x3_s1': (9, 11, 16, 8, 3, 3, 1, True, 2),
                '3x3_s2': (9, 11, 16, 8, 3, 3, 2, True, 1),
                '3x5': (7, 9, 16, 8, 3, 5, 1, False, 1),
                '5x3': (7, 9, 16, 8, 5, 3, 1, False, 1)}


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, held in fp32."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _inputs(case: str):
    h, w, cin, cout, kh, kw, stride, modulated, _ = WINDOW_CASES[case]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    k = kh * kw
    rng = np.random.RandomState(sorted(WINDOW_CASES).index(case))
    x = _bf16(rng.randn(2, h, w, cin))
    # offsets of a few pixels, some past the window (clamped)
    off = (rng.randn(2, ho, wo, 2 * k) * 1.5).astype(np.float32)
    wt = _bf16(rng.randn(kh, kw, cin, cout) / np.sqrt(k * cin))
    mask = _bf16(rng.rand(2, ho, wo, k)) if modulated else None
    bias = _bf16(rng.randn(cout) * 0.1) if modulated else None
    ct = _bf16(rng.randn(2, ho, wo, cout))
    return x, off, wt, mask, bias, ct, stride, WINDOW_CASES[case][-1]


_JAX_WINDOW = {}


def _jax_window(case: str, x, off, wt, mask, bias, ct, stride, radius):
    """JAX's bf16 forward and VJP (jit), the offsets fp32 (their type only
    sets d_offset's, which the caller rounds for bf16 offsets)."""
    if case not in _JAX_WINDOW:
        modulated = mask is not None

        def f(x, off, wt, *mb):
            return j_window(x, off, wt, *(mb if modulated else (None, None)),
                            stride=stride, radius=radius)

        @jax.jit
        def fwd_vjp(x, off, wt, mb, ct):
            out, vjp = jax.vjp(f, x, off, wt, *mb)
            return out, vjp(ct)
        _JAX_WINDOW[case] = fwd_vjp
    bf = jnp.bfloat16
    mb = (jnp.asarray(mask, bf), jnp.asarray(bias, bf)) \
        if mask is not None else ()
    out, grads = _JAX_WINDOW[case](jnp.asarray(x, bf), jnp.asarray(off),
                                   jnp.asarray(wt, bf), mb,
                                   jnp.asarray(ct, bf))
    return out, grads


def _close(got: torch.Tensor, want, what: str):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize('off_dtype', ['bf16', 'fp32'])
@pytest.mark.parametrize('case', sorted(WINDOW_CASES))
def test_deform_conv_window_bf16_matches_jax(case, off_dtype):
    x, off, wt, mask, bias, ct, stride, radius = _inputs(case)
    if off_dtype == 'bf16':
        off = _bf16(off)
    j_out, j_grads = _jax_window(case, x, off, wt, mask, bias, ct, stride,
                                 radius)
    assert j_out.dtype == jnp.bfloat16

    bf = torch.bfloat16
    t_off = torch.tensor(off, dtype=bf if off_dtype == 'bf16'
                         else torch.float32)
    leaves = [torch.tensor(x, dtype=bf), t_off,
              torch.tensor(wt).permute(3, 0, 1, 2).contiguous().to(bf)]
    if mask is not None:
        leaves += [torch.tensor(mask, dtype=bf),
                   torch.tensor(bias, dtype=bf)]
    leaves = [t.requires_grad_(True) for t in leaves]
    args = leaves if mask is not None else leaves + [None, None]
    out = deform_conv_window(*args, stride=stride, radius=radius)
    assert out.dtype == bf
    _close(out, j_out, 'out')
    out.backward(torch.tensor(ct, dtype=bf))

    names = ['x', 'offset', 'weight', 'mask', 'bias']
    for name, t, jg in zip(names, leaves, j_grads):
        assert t.grad.dtype == t.dtype, (name, t.grad.dtype)
        g = t.grad.permute(1, 2, 3, 0) if name == 'weight' else t.grad
        if name == 'offset' and off_dtype == 'bf16':
            jg = jnp.asarray(jg).astype(jnp.bfloat16)   # JAX's astype VJP
        _close(g, jg, name)


def test_correlate_bf16_matches_jax():
    """The training forward's bf16 correlation (K1's fp32 output cast to
    bf16) and its VJP (K3's bf16 plain version) against JAX's XLA form in
    bf16, leaky ReLU included."""
    rng = np.random.RandomState(5)
    x1, x2 = (_bf16(rng.randn(2, 6, 8, 32)) for _ in range(2))
    ct = _bf16(rng.randn(2, 6, 8, 25))
    bf = jnp.bfloat16

    @jax.jit
    def fwd_vjp(a, b, c):
        out, vjp = jax.vjp(lambda a, b: j_correlate(a, b, 5), a, b)
        return out, vjp(c)
    j_out, (j1, j2) = fwd_vjp(jnp.asarray(x1, bf), jnp.asarray(x2, bf),
                              jnp.asarray(ct, bf))
    assert j_out.dtype == bf

    a = torch.tensor(x1, dtype=torch.bfloat16).requires_grad_(True)
    b = torch.tensor(x2, dtype=torch.bfloat16).requires_grad_(True)
    out = correlate(a, b, 5).to(torch.bfloat16)
    _close(out, j_out, 'out')
    out.backward(torch.tensor(ct, dtype=torch.bfloat16))
    for name, t, jg in (('x1', a, j1), ('x2', b, j2)):
        assert t.grad.dtype == torch.bfloat16
        _close(t.grad, jg, name)
