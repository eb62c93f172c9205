"""K5's fast route and its launch plan, on the CPU.

``exact_bwd_fast`` says which calls of K5 (the exact deformable gather's
backward) take the fast route (tiles of output sites whose footprint is
staged in shared memory), ``exact_bwd_plan`` how a call is cut (tile,
footprint with its halo, channel split, shared memory), and
``exact_bwd_inside`` which (site, tap)s the fast route keeps in shared
memory (the others overflow into device memory).  These tests hold the plan
at the training sites of 384x640 and at the 96x128 test sites, the inside
rule against ``exact_geometry``, the predicate, the wrapper (its CUDA
checks and launches replaced by recorders) to the route and plan it hands
each entry, and the split specs to the bits the source reads."""

import re

import numpy as np
import pytest
import torch

from stmask_torch.kernels import deform_exact_bwd as K5
from stmask_torch.kernels import split as KS
from stmask_torch.kernels.build import CSRC
from stmask_torch.kernels.deform_col2im import (FAST_SMEM, SMEM_LIMIT,
                                                footprint, footprint_origin)
from stmask_torch.kernels.deform_exact_bwd import (
    CHUNK, FAST_HALO, exact_bwd_fast, exact_bwd_inside, exact_bwd_plan,
    exact_geometry, fast_smem)

FRAMES = 8                   # a training step's 4 clips of 2 frames
# (H, W, Cin, stride, kh, kw) of the DCN input: R50's 7 sites and FCB's 15
# (P3..P7 under 3x3, 3x5 and 5x3 v1 taps, Cin 256) at 384x640, and at the
# 96x128 of the CPU tests (a quarter of the height, a fifth of the width)
SITES_384 = ([(96, 160, 128, 2, 3, 3), (48, 80, 128, 1, 3, 3),
              (48, 80, 256, 2, 3, 3), (24, 40, 256, 1, 3, 3),
              (24, 40, 512, 2, 3, 3), (12, 20, 512, 1, 3, 3)]
             + [(h, w, 256, 1, kh, kw)
                for h, w in ((48, 80), (24, 40), (12, 20), (6, 10), (3, 5))
                for kh, kw in ((3, 3), (3, 5), (5, 3))])
SITES_96 = ([(24, 32, 128, 2, 3, 3), (12, 16, 128, 1, 3, 3),
             (12, 16, 256, 2, 3, 3), (6, 8, 256, 1, 3, 3),
             (6, 8, 512, 2, 3, 3), (3, 4, 512, 1, 3, 3)]
            + [(h, w, 256, 1, kh, kw)
               for h, w in ((12, 16), (6, 8), (3, 4), (2, 2))
               for kh, kw in ((3, 3), (3, 5), (5, 3))])
ALIGNED = 4096               # a 16-byte aligned byte address


def test_plans_fit_and_cover_the_maps():
    """At every training site of 384x640 and of the 96x128 tests, in fp32
    and bf16: the fast route, a tile of at most 8 x 8 sites whose blocks
    cover the map, its footprint (the tap grid and the halo), shared memory
    that lets two blocks share an SM, no tile count beaten by another tile
    that fits, and no channel split without a chunk.  FCB's P7 (1 x 1 at
    96x128) takes the general route."""
    for frames, sites in ((FRAMES, SITES_384), (1, SITES_96)):
        for h, w, cin, stride, kh, kw in sites:
            ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
            k = kh * kw
            for elem in (4, 2):
                assert exact_bwd_fast(h, w, cin, elem, frames * h * w * cin,
                                      frames * ho * wo * k * cin, ALIGNED,
                                      ALIGNED, ALIGNED)
                plan = exact_bwd_plan(frames, ho, wo, cin, kh, kw, stride, 1,
                                      elem)
                assert plan.halo == FAST_HALO >= 2
                assert 1 <= plan.ty <= 8 and 1 <= plan.tx <= 8
                ny, nx = -(-ho // plan.ty), -(-wo // plan.tx)
                assert (ny - 1) * plan.ty < ho <= ny * plan.ty
                assert (nx - 1) * plan.tx < wo <= nx * plan.tx
                tiles = ny * nx
                assert (plan.fh, plan.fw) == footprint(
                    plan.ty, plan.tx, kh, kw, stride, 1, FAST_HALO)
                assert plan.smem == fast_smem(plan.fh * plan.fw,
                                              plan.ty * plan.tx * k, elem)
                assert plan.smem <= FAST_SMEM < SMEM_LIMIT
                for ty in range(1, 9):
                    for tx in range(1, 9):
                        fh, fw = footprint(ty, tx, kh, kw, stride, 1,
                                           FAST_HALO)
                        if fast_smem(fh * fw, ty * tx * k,
                                     elem) <= FAST_SMEM:
                            assert -(-ho // ty) * -(-wo // tx) >= tiles
                chunks = -(-cin // CHUNK)
                per = -(-chunks // plan.n_split)
                assert per * (plan.n_split - 1) < chunks
                assert plan.blocks == frames * tiles * plan.n_split
    assert not exact_bwd_fast(1, 1, 256, 2, 256, 9 * 256, ALIGNED, ALIGNED,
                              ALIGNED)


def _offsets(kind, rng, b, h, w, ho, wo, kh, kw, stride):
    k = kh * kw
    if kind == 'zero':
        return np.zeros((b, ho, wo, 2 * k))
    if kind == 'edge':        # samples at rows -1, 0, H-1, H (columns too)
        rows = (np.arange(ho)[:, None, None] * stride - (kh - 1) // 2
                + np.arange(kh)[None, None, :, None].repeat(kw, 3).reshape(
                    1, 1, k))
        cols = (np.arange(wo)[None, :, None] * stride - (kw - 1) // 2
                + np.tile(np.arange(kw), kh)[None, None, :])
        ty = rng.choice([-1, 0, h - 1, h], (b, ho, wo, k))
        tx = rng.choice([-1, 0, w - 1, w], (b, ho, wo, k))
        return np.stack([ty - rows, tx - cols], -1).reshape(b, ho, wo, 2 * k)
    return rng.normal(0.0, 1.5 if kind == 'normal' else 6.0,
                      (b, ho, wo, 2 * k))


def test_inside_items_have_every_corner_in_the_footprint():
    """exact_bwd_inside says inside exactly where both rows and both
    columns of a (site, tap)'s block, as exact_geometry gives it, lie in
    its tile's footprint, so every weighted or tie corner of an inside item
    lies there.  No item overflows at zero offsets, a few at N(0, 1.5), a
    fifth or more at N(0, 6) (samples clipped to the image's edge stay in
    the edge tiles' footprints), some at the image's edges."""
    rng = np.random.RandomState(0)
    shares = {}
    for h, w, stride, kh, kw in ((29, 37, 1, 3, 3), (29, 37, 2, 3, 3),
                                 (23, 31, 1, 3, 5), (23, 31, 1, 5, 3)):
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        k = kh * kw
        plan = exact_bwd_plan(2, ho, wo, 64, kh, kw, stride, 1, 2)
        assert -(-ho // plan.ty) * -(-wo // plan.tx) > 4
        # each item's footprint origin, from its tile
        oy = np.arange(ho) // plan.ty * plan.ty
        ox = np.arange(wo) // plan.tx * plan.tx
        fy, fx = footprint_origin(oy, ox, kh, kw, stride, 1, plan.halo)
        fy = torch.from_numpy(np.repeat(fy[:, None, None], wo * k, 1)
                              .reshape(1, -1))
        fx = torch.from_numpy(np.tile(np.repeat(fx[:, None], k, 1), (ho, 1))
                              .reshape(1, -1))
        for kind in ('zero', 'edge', 'normal', 'normal6'):
            off = torch.from_numpy(_offsets(kind, rng, 2, h, w, ho, wo, kh,
                                            kw, stride)).float()
            inside = exact_bwd_inside(off, h, w, kh, kw, stride, 1, plan)
            rows, cols = exact_geometry(off, h, w, kh, kw, stride)
            want = torch.ones_like(inside)
            for blk, first, span in ((rows, fy, plan.fh), (cols, fx, plan.fw)):
                assert len(blk) == 2
                want &= (blk[0][0] >= first) & (blk[1][0] <= first + span - 1)
            assert torch.equal(inside, want), (kind, h, w, stride)
            for ry, wy, dwy in rows:
                for rx, wx, dwx in cols:
                    live = (wy * wx != 0) | (dwy * wx != 0) | (wy * dwx != 0)
                    pick = inside & live
                    assert bool((ry[pick] >= fy.expand_as(ry)[pick]).all())
                    assert bool((ry[pick] < (fy + plan.fh).expand_as(
                        ry)[pick]).all())
                    assert bool((rx[pick] >= fx.expand_as(rx)[pick]).all())
                    assert bool((rx[pick] < (fx + plan.fw).expand_as(
                        rx)[pick]).all())
            shares.setdefault(kind, []).append(
                1.0 - float(inside.float().mean()))
    assert max(shares['zero']) == 0.0
    assert 0.0 < max(shares['normal']) < 0.1 < 0.2 < min(shares['normal6'])
    assert 0.0 < min(shares['edge'])


def test_route_predicate():
    """On the route: H and W of 2 or more, Cin a multiple of 4 (fp32) or
    8 (bf16), every pointer 16-byte aligned.  Off it: a 1-pixel map, ragged
    Cin, a pointer off a 16-byte boundary (dcols, x, dx's sums or the bf16
    dx), an image of 2^27 pixels, tensors past 32-bit offsets."""
    def fast(h=24, w=40, cin=64, elem=2, x_numel=1000, dcols_numel=9000,
             ptrs=(0, 0, 0, 0)):
        return exact_bwd_fast(h, w, cin, elem, x_numel, dcols_numel,
                              *(ALIGNED + p for p in ptrs))

    assert fast() and fast(cin=8) and fast(cin=256) and fast(h=2, w=2)
    assert fast(elem=4, cin=4, ptrs=(0, 0, 0)) and fast(elem=4, cin=36,
                                                        ptrs=(0, 0, 0))
    assert fast(ptrs=(16, 32, 48, 64))
    assert not fast(h=1) and not fast(w=1)
    assert not fast(cin=12) and not fast(cin=6) and not fast(elem=4, cin=6)
    for i, step in enumerate((2, 2, 4, 2)):
        assert not fast(ptrs=tuple(step if j == i else 0 for j in range(4)))
    assert not fast(elem=4, ptrs=(0, 4, 0))
    assert not fast(h=2 ** 14, w=2 ** 13)
    assert not fast(x_numel=2 ** 31) and not fast(dcols_numel=2 ** 31)


class _Stream:
    cuda_stream = 0


def test_wrapper_routes_calls(monkeypatch):
    """deform_exact_bwd_cuda hands the entry of its types (fp32, bf16, bf16
    with fp32 offsets) the route exact_bwd_fast decides, 1 with
    exact_bwd_plan's plan and, under a channel split, a scratch for the
    partials, or 0 with no plan; the pointers in the C order.  Checked on
    the CPU with the CUDA checks and the launches replaced by recorders."""
    calls = []
    n_args = {n: len(getattr(K5, n).argtypes)
              for n in ('KERNEL', 'KERNEL_BF16', 'KERNEL_BF16_F32OFF')}
    assert list(n_args.values()) == [27, 28, 28]
    monkeypatch.setattr(K5, 'check_cuda', lambda *a, **k: None)
    for name in ('KERNEL', 'KERNEL_BF16', 'KERNEL_BF16_F32OFF'):
        monkeypatch.setattr(K5, name, lambda *a, _n=name: calls.append(
            (_n, a)))
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda d=None: _Stream)
    for (h, w, cin, stride, x_off), dt, odt, masked in (
            ((24, 40, 256, 1, 0), torch.bfloat16, torch.bfloat16, True),
            ((24, 40, 256, 1, 0), torch.bfloat16, torch.float32, False),
            ((12, 20, 512, 1, 0), torch.float32, torch.float32, True),
            ((9, 11, 6, 2, 0), torch.float32, torch.float32, True),
            ((9, 11, 12, 1, 0), torch.bfloat16, torch.bfloat16, True),
            ((1, 7, 8, 1, 0), torch.bfloat16, torch.bfloat16, True),
            ((24, 40, 64, 1, 1), torch.float32, torch.float32, False)):
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        buf = torch.zeros(2 * h * w * cin + 8, dtype=dt)
        x = buf[x_off:x_off + 2 * h * w * cin].view(2, h, w, cin)
        dcols = torch.zeros(2 * ho * wo, 9 * cin, dtype=dt)
        off = torch.zeros(2, ho, wo, 18, dtype=odt)
        mask = torch.zeros(2, ho, wo, 9, dtype=dt) if masked else None
        dx, d_off, d_mask = K5.deform_exact_bwd_cuda(dcols, x, off, mask, 3,
                                                     3, stride)
        assert (dx.dtype, d_off.dtype) == (dt, odt)
        assert (d_mask is None) == (mask is None)
        name, args = calls.pop()
        bf16 = dt == torch.bfloat16
        assert name == ('KERNEL' if not bf16 else 'KERNEL_BF16'
                        if odt == dt else 'KERNEL_BF16_F32OFF')
        n_ptr = 9 if bf16 else 8
        assert args[:4] == (dcols.data_ptr(), x.data_ptr(), off.data_ptr(),
                            None if mask is None else mask.data_ptr())
        assert args[4 + bf16:6 + bf16] == (dx.data_ptr(), d_off.data_ptr())
        assert args[n_ptr:n_ptr + 10] == (2, h, w, cin, ho, wo, 3, 3, stride,
                                          1)
        fast = exact_bwd_fast(h, w, cin, x.element_size(), x.numel(),
                              dcols.numel(), dcols.data_ptr(), x.data_ptr(),
                              *args[4:5 + bf16])
        assert fast == (h >= 2 and cin % (8 if bf16 else 4) == 0
                        and x_off == 0), (h, w, cin, dt)
        route = args[n_ptr + 10:n_ptr + 18]
        part = args[n_ptr - 1]
        if fast:
            plan = exact_bwd_plan(2, ho, wo, cin, 3, 3, stride, 1,
                                  x.element_size())
            assert route == (1, plan.ty, plan.tx, plan.fh, plan.fw,
                             plan.halo, plan.n_split, plan.smem)
            assert (part is None) == (plan.n_split == 1)
        else:
            assert route == (0,) * 8 and part is None
        assert args[-1] == 0 and len(args) == n_args[name]


def test_split_specs_name_the_bits_in_the_source():
    """K5's split: bits 1 (x reads and dot products), 2 (dx reductions), 4
    (dcols reads), 16 (the fast route's dx pass) in every entry, 8 (dx
    zeroing and rounding) in the bf16 ones, behind the route predicate
    exact_bwd_fast; the source defines the macro 0 and reads each bit."""
    src = (CSRC / 'deform_exact_bwd.cu').read_text()
    assert re.search(r'#define STMASK_EXACTBWD_DROP 0', src)
    for spec, entry in ((KS.EXACT_BWD, 'KERNEL_BF16'),
                        (KS.EXACT_BWD_F32, 'KERNEL')):
        assert (spec.library, spec.macro, spec.entry, spec.predicate) == (
            'deform_exact_bwd', 'STMASK_EXACTBWD_DROP', entry,
            'exact_bwd_fast')
        assert getattr(K5, spec.entry).library == spec.library
        assert KS.labels(spec) == ['whole'] + [lb for _, lb in spec.parts]
    assert [b for b, _ in KS.EXACT_BWD.parts] == [1, 2, 4, 16, 8]
    assert [b for b, _ in KS.EXACT_BWD_F32.parts] == [1, 2, 4, 16]
    for bit in (1, 2, 4, 8, 16):
        assert re.search(rf'DROP & {bit}\b', src), bit


def test_plan_refuses_a_footprint_over_shared_memory():
    with pytest.raises(ValueError, match='shared memory'):
        exact_bwd_plan(1, 8, 8, 64, 3, 3, 1, 60, 4)
