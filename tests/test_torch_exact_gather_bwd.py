"""K5's plain version (``kernels.deform_exact_bwd``) and the exact
deformable conv's CPU backward (``ops.deform_conv._DeformConvExact``)
against ``jax.vjp`` of ``stmask_tpu.ops.deform_conv.deform_conv2d``: dx,
d_offset, d_mask, d_w and d_b.

The exact gather's offset gradient is decided by JAX's subgradients at
ties (an integer row or column, an origin clipped to the image; see
``kernels/deform_exact_bwd.py``), so the cases put samples there: zero
offsets (every sample on a tie), integer samples at rows and columns -1,
0, H-1 and H, N(0, 3) offsets, 1-pixel dimensions, stride 2 with dilation
2, and v1 3x5 / 5x3 taps without the mask.  Inputs come from a numpy seed;
the JAX side runs under ``jax.jit``, one compile a shape.

Tolerances: fp32 within 1e-5 of max|ref| (they agree to ~3e-7); a torch
transcription of the gather differentiated by autograd (``torch.clamp``
and ``torch.abs`` take other subgradients) misses that by O(1) at zero
offsets.  bf16 in the form of ROADMAP C.11: each gradient within 3x the
port's fp32 distance to JAX's bf16 VJP plus 2^-7 of max|ref|.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.ops.deform_conv import deform_conv2d

from stmask_torch.kernels.deform_exact_bwd import (deform_exact_bwd,
                                                   deform_exact_bwd_cuda,
                                                   deform_exact_bwd_reference)
from stmask_torch.ops.deform_conv import deform_conv_exact
from torch_eval_common import few_torch_threads  # noqa: F401

REL = 1e-5
NAMES = ('dx', 'd_offset', 'd_w', 'd_mask', 'd_b')
# (B, H, W, Cin, Cout, kh, kw, stride, dilation, modulated)
BASE = (2, 6, 7, 8, 5, 3, 3, 1, 1, True)
SHAPES = {
    'h1': (2, 1, 7, 8, 5, 3, 3, 1, 1, True),
    'w1': (2, 6, 1, 8, 5, 3, 3, 1, 1, True),
    'h1w1': (2, 1, 1, 4, 3, 3, 3, 1, 1, True),
    'stride2_dil2': (2, 9, 8, 8, 5, 3, 3, 2, 2, True),
    'v1_3x5': (1, 7, 9, 6, 5, 3, 5, 1, 1, False),
    'v1_5x3': (1, 7, 9, 6, 5, 5, 3, 1, 1, False),
}


def _grid(shape):
    """Each (site, tap)'s integer grid position (rows, cols), [Ho, Wo, K]."""
    _, h, w, _, _, kh, kw, st, dil, _ = shape
    ho, wo = (h - 1) // st + 1, (w - 1) // st + 1
    oy = np.arange(ho) * st - (kh - 1) // 2 * dil
    ox = np.arange(wo) * st - (kw - 1) // 2 * dil
    ky, kx = np.meshgrid(np.arange(kh) * dil, np.arange(kw) * dil,
                         indexing='ij')
    rows = oy[:, None, None] + ky.reshape(1, 1, -1) + 0 * ox[None, :, None]
    cols = ox[None, :, None] + kx.reshape(1, 1, -1) + 0 * oy[:, None, None]
    return rows, cols


def _inputs(shape, kind, seed):
    """x, offset, weight [Cout, kh, kw, Cin], mask or None, bias and the
    output's cotangent as numpy fp32.  ``kind``: 'zero' offsets; 'edge'
    offsets that put every sample on an integer row in {-1, 0, 1, H-1, H}
    and column in {-1, 0, 1, W-1, W}; 'normal' N(0, 3)."""
    b, h, w, cin, cout, kh, kw, st, _, v2 = shape
    rng = np.random.RandomState(seed)
    rows, cols = _grid(shape)
    ho, wo, k = rows.shape
    x = rng.randn(b, h, w, cin)
    if kind == 'zero':
        off = np.zeros((b, ho, wo, 2 * k))
    elif kind == 'edge':
        ty = rng.choice([-1, 0, 1, h - 1, h], size=(b, ho, wo, k))
        tx = rng.choice([-1, 0, 1, w - 1, w], size=(b, ho, wo, k))
        off = np.stack([ty - rows, tx - cols], -1).reshape(b, ho, wo, 2 * k)
    else:
        off = rng.randn(b, ho, wo, 2 * k) * 3.0
    mask = rng.rand(b, ho, wo, k) if v2 else None
    wt = rng.randn(cout, kh, kw, cin) / np.sqrt(k * cin)
    bias = rng.randn(cout)
    cot = rng.randn(b, ho, wo, cout)
    f32 = functools.partial(np.asarray, dtype=np.float32)
    return (f32(x), f32(off), f32(wt), None if mask is None else f32(mask),
            f32(bias), f32(cot))


@functools.lru_cache(maxsize=None)
def _jax_vjp(stride, dilation, modulated):
    """jit of (x, offset, weight [kh, kw, Cin, Cout], mask, bias, cot) ->
    JAX's gradients in NAMES' order (d_w as [Cout, kh, kw, Cin]; no d_mask
    without the mask)."""
    def grads(x, off, w, m, b, cot):
        if modulated:
            f = lambda x_, o_, w_, m_, b_: deform_conv2d(  # noqa: E731
                x_, o_, w_, m_, b_, stride, dilation)
            _, vjp = jax.vjp(f, x, off, w, m, b)
            dx, doff, dw, dm, db = vjp(cot)
        else:
            f = lambda x_, o_, w_, b_: deform_conv2d(  # noqa: E731
                x_, o_, w_, None, b_, stride, dilation)
            _, vjp = jax.vjp(f, x, off, w, b)
            (dx, doff, dw, db), dm = vjp(cot), None
        return dx, doff, jnp.transpose(dw, (3, 0, 1, 2)), dm, db
    return jax.jit(grads)


def _jax_grads(shape, arrays, dtype=jnp.float32, off_dtype=None):
    x, off, wt, mask, bias, cot = arrays
    _, _, _, _, _, _, _, st, dil, v2 = shape
    cast = lambda a, d=dtype: None if a is None else jnp.asarray(  # noqa
        a, d)
    out = _jax_vjp(st, dil, v2)(
        cast(x), cast(off, off_dtype or dtype),
        cast(np.transpose(wt, (1, 2, 3, 0))), cast(mask), cast(bias),
        cast(cot))
    return [None if g is None else np.asarray(g, np.float32) for g in out]


def _port_grads(shape, arrays, dtype=torch.float32, off_dtype=None):
    """The port's gradients in NAMES' order through ``deform_conv_exact``
    (the forward's fused conv, K5's plain version, ``deform_wgrad``'s)."""
    x, off, wt, mask, bias, cot = arrays
    _, _, _, _, _, _, _, st, dil, _ = shape
    ts = [None if a is None else torch.from_numpy(a).to(d).requires_grad_()
          for a, d in ((x, dtype), (off, off_dtype or dtype), (wt, dtype),
                       (mask, dtype), (bias, dtype))]
    out = deform_conv_exact(*ts, stride=st, dilation=dil)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    for t, a in zip(ts, (x, off, wt, mask, bias)):
        assert t is None or t.grad.dtype == t.dtype
    return [None if t is None else t.grad.float().numpy() for t in ts]


def _worst(got, want):
    """max over the gradients of max|got - want| / max|want|."""
    return max(float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                                1e-30)
               for g, w in zip(got, want) if w is not None)


def _check(got, want, label):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, (label, name)
            continue
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=REL * float(np.abs(w).max()),
                                   err_msg=f'{label} {name}')


def test_exact_gather_backward_matches_jax():
    """The 3x3 v2 conv at zero, edge and N(0, 3) offsets; then each shape of
    SHAPES at zero and edge offsets (v1 at N(0, 3) too); K5's plain version
    called alone with JAX's own dcols gives the same dx, d_offset and
    d_mask."""
    cases = [(BASE, kind) for kind in ('zero', 'edge', 'normal')]
    cases += [(s, kind) for s in SHAPES.values()
              for kind in ('zero', 'edge', 'normal')]
    for i, (shape, kind) in enumerate(cases):
        arrays = _inputs(shape, kind, i)
        want = _jax_grads(shape, arrays)
        _check(_port_grads(shape, arrays), want, f'{shape} {kind}')
    # K5 alone: dcols = g @ w2 of the last case with the mask
    shape = SHAPES['stride2_dil2']
    x, off, wt, mask, bias, cot = _inputs(shape, 'edge', 99)
    b, h, w, cin, cout, kh, kw, st, dil, _ = shape
    dcols = torch.from_numpy(cot).reshape(-1, cout) @ torch.from_numpy(
        wt).reshape(cout, -1)
    got = deform_exact_bwd_reference(
        dcols, torch.from_numpy(x), torch.from_numpy(off),
        torch.from_numpy(mask), kh, kw, st, dil)
    want = _jax_grads(shape, (x, off, wt, mask, bias, cot))
    _check([got[0].numpy(), got[1].numpy(), None, got[2].numpy(), None],
           [want[0], want[1], None, want[3], None], 'K5 alone')
    assert deform_exact_bwd(dcols, torch.from_numpy(x), torch.from_numpy(off),
                            torch.from_numpy(mask), kh, kw, st, dil)[1].equal(
        got[1])


def _transcribed(x, off, wt, mask, bias, stride, dilation):
    """``bilinear_sample_block`` and ``deform_conv2d`` transcribed to torch
    ops (``torch.clamp``, ``torch.abs``), for autograd to differentiate."""
    b, h, w, cin = x.shape
    cout, kh, kw, _ = wt.shape
    _, ho, wo, _ = off.shape
    k = kh * kw
    rows, cols = _grid((b, h, w, cin, cout, kh, kw, stride, dilation, True))
    o = off.reshape(b, ho, wo, k, 2)
    py = torch.from_numpy(rows).float() + o[..., 0]
    px = torch.from_numpy(cols).float() + o[..., 1]
    y0 = torch.clamp(torch.floor(py), 0, h - 2).detach()
    x0 = torch.clamp(torch.floor(px), 0, w - 2).detach()
    flat = x.reshape(b, h * w, cin)
    vals = 0.0
    for r in (0, 1):
        wy = torch.clamp(1 - torch.abs(py - (y0 + r)), 0, 1)
        for q in (0, 1):
            wx = torch.clamp(1 - torch.abs(px - (x0 + q)), 0, 1)
            idx = ((y0 + r) * w + x0 + q).long().reshape(b, -1)
            v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, cin))
            vals = vals + v.reshape(b, ho, wo, k, cin) * (wy * wx)[..., None]
    vals = vals * mask[..., None]
    return vals.reshape(b, ho, wo, k * cin) @ wt.reshape(cout, -1).t() + bias


def test_plain_autograd_transcription_misses_the_ties():
    """The tie rules matter: autograd through a torch transcription of the
    gather misses JAX's offset gradient by O(1) of max|ref| at zero
    offsets, where K5's plain version is within REL."""
    arrays = _inputs(BASE, 'zero', 0)
    want = _jax_grads(BASE, arrays)
    x, off, wt, mask, bias, cot = [torch.from_numpy(a).requires_grad_()
                                   for a in arrays]
    (_transcribed(x, off, wt, mask, bias, 1, 1) * cot).sum().backward()
    scale = float(np.abs(want[1]).max())
    miss = float(np.abs(off.grad.numpy() - want[1]).max()) / scale
    assert miss > 0.1, miss
    got = _port_grads(BASE, arrays)
    assert float(np.abs(got[1] - want[1]).max()) / scale <= REL
    with pytest.raises(AssertionError):
        _check([x.grad.numpy(), off.grad.numpy(),
                wt.grad.numpy(), mask.grad.numpy(), bias.grad.numpy()],
               want, 'transcription')


@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16_offsets', 'f32_offsets'])
def test_bf16_entries_against_jax_bf16(off_dtype):
    """bf16 x, weight, mask and bias with bf16 or fp32 offsets (FCB's
    ``_ali``): each gradient comes back in its input's type, within 3x the
    port's fp32 distance to JAX's bf16 VJP plus 2^-7 of max|ref|, at zero,
    edge and N(0, 3) offsets, with the mask and without it (v1 3x5)."""
    j_off = jnp.bfloat16 if off_dtype == torch.bfloat16 else jnp.float32
    for i, (shape, kind) in enumerate(
            [(BASE, k) for k in ('zero', 'edge', 'normal')]
            + [(SHAPES['v1_3x5'], 'normal')]):
        arrays = list(_inputs(shape, kind, 50 + i))
        # the values as bf16 holds them, so that both sides start equal
        for j in (0, 2, 3, 4):
            if arrays[j] is not None:
                arrays[j] = arrays[j].astype(jnp.bfloat16).astype(np.float32)
        if off_dtype == torch.bfloat16:
            arrays[1] = arrays[1].astype(jnp.bfloat16).astype(np.float32)
        want = _jax_grads(shape, arrays, jnp.bfloat16, j_off)
        got16 = _port_grads(shape, arrays, torch.bfloat16, off_dtype)
        got32 = _port_grads(shape, arrays)
        for name, g16, g32, w in zip(NAMES, got16, got32, want):
            if w is None:
                continue
            gap = float(np.abs(g32 - w).max())
            d = float(np.abs(g16 - w).max())
            lim = 3 * gap + 2.0 ** -7 * float(np.abs(w).max())
            assert d <= lim, (shape, kind, name, d, gap, lim)


def test_wrapper_dispatch():
    """CPU tensors take the plain version (fp32 and bf16, types kept); the
    CUDA wrapper refuses CPU tensors and a wrong dcols shape."""
    x, off, wt, mask, bias, cot = _inputs(BASE, 'normal', 3)
    b, h, w, cin, cout, kh, kw, _, _, _ = BASE
    dcols = torch.from_numpy(cot).reshape(-1, cout) @ torch.from_numpy(
        wt).reshape(cout, -1)
    xt, ot, mt = (torch.from_numpy(a) for a in (x, off, mask))
    for dt, odt in ((torch.float32, torch.float32),
                    (torch.bfloat16, torch.bfloat16),
                    (torch.bfloat16, torch.float32)):
        dx, doff, dm = deform_exact_bwd(dcols.to(dt), xt.to(dt), ot.to(odt),
                                        mt.to(dt), kh, kw)
        assert (dx.dtype, doff.dtype, dm.dtype) == (dt, odt, dt)
        assert dx.shape == xt.shape and doff.shape == ot.shape
    with pytest.raises(ValueError, match='CUDA'):
        deform_exact_bwd_cuda(dcols, xt, ot, mt, kh, kw)
    with pytest.raises(TypeError, match='offsets'):
        deform_exact_bwd_cuda(dcols, xt, ot.bfloat16(), mt, kh, kw)
