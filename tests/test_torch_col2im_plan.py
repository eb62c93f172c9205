"""K4's bf16 fast route and its launch plan, on the CPU.

``col2im_fast`` says which bf16 calls take the fast route (bf16 rows in
shared memory, copied by ``cp.async`` into a ring, tiles of up to 8 x 8
sites) and ``col2im_plan(..., fast=True)`` how a call is cut (tile,
footprint, stages, channel split, shared memory).  These tests hold both at
the training sites of R50 and FCB (8 frames) and at shapes off the route,
the footprint of the fast tiles against the plain col2im, and the wrapper,
with its CUDA checks and launches replaced by recorders, to the route it
hands each entry."""

import pytest
import torch

from stmask_torch.kernels import deform_col2im as K4
from stmask_torch.kernels.deform_col2im import (CHUNK, FAST_SETUP, FAST_SMEM,
                                                SMEM_LIMIT, SMEM_SM, SMS,
                                                col2im_fast, col2im_plan,
                                                fast_smem, footprint)
from test_torch_kernels_geometry import check_footprint
from torch_eval_common import few_torch_threads  # noqa: F401

RADIUS = 2
FRAMES = 8                   # a training step's 4 clips of 2 frames
# (H, W, Cin, stride) of the DCN input at 384x640: R50's 7 sites
# (dcn_layers (0, 4, 6, 3), interval 2; R101's 11 have these shapes)
R50_SITES = [(96, 160, 128, 2), (48, 80, 128, 1), (48, 80, 256, 2),
             (24, 40, 256, 1), (24, 40, 256, 1), (24, 40, 512, 2),
             (12, 20, 512, 1)]
# FCB's 15 sites: P3..P7 under 3x3, 3x5 and 5x3 v1 taps, Cin 256
FCB_SITES = [(h, w, kh, kw) for h, w in ((48, 80), (24, 40), (12, 20),
                                         (6, 10), (3, 5))
             for kh, kw in ((3, 3), (3, 5), (5, 3))]
ALIGNED = 4096               # a 16-byte aligned byte address


def _check_fast_plan(ho, wo, cin, kh, kw, stride):
    """The fast plan of a training site: two blocks share an SM, it fills
    the SMs unless a further split would add a wave for no fewer
    chunk-times, never splits without a chunk, and has tiles no smaller
    than the general plan's."""
    plan = col2im_plan(FRAMES, ho, wo, cin, kh, kw, stride, 1, RADIUS,
                       fast=True)
    gen = col2im_plan(FRAMES, ho, wo, cin, kh, kw, stride, 1, RADIUS)
    assert plan.route == 'fast' and plan.stages == 2
    assert gen.route == 'general' and gen.stages == 1
    assert (plan.fh, plan.fw) == footprint(plan.ty, plan.tx, kh, kw, stride,
                                           1, RADIUS)
    assert plan.smem == fast_smem(plan.fh * plan.fw,
                                  plan.ty * plan.tx * kh * kw)
    assert plan.smem <= FAST_SMEM < SMEM_LIMIT
    assert 2 * (plan.smem + 1024) <= SMEM_SM
    assert 1 <= plan.ty <= 8 and 1 <= plan.tx <= 8
    # no tile of at most 8 x 8 sites that two blocks an SM allow cuts the
    # map into fewer tiles
    for ty in range(1, 9):
        for tx in range(1, 9):
            fh, fw = footprint(ty, tx, kh, kw, stride, 1, RADIUS)
            if fast_smem(fh * fw, ty * tx * kh * kw) <= FAST_SMEM:
                assert -(-ho // ty) * -(-wo // tx) >= (
                    -(-ho // plan.ty) * -(-wo // plan.tx))
    tiles = FRAMES * -(-ho // plan.ty) * -(-wo // plan.tx)
    assert plan.blocks == tiles * plan.n_split
    # no split without a chunk
    chunks = -(-cin // CHUNK)
    per = -(-chunks // plan.n_split)
    assert per * (plan.n_split - 1) < chunks
    # the split that fills the card where that costs no more: the fewest
    # waves of blocks (one or two an SM) times chunks a block and its
    # set-up, the smaller split on a tie
    per_sm = min(2, SMEM_SM // (plan.smem + 1024))

    def cost(s):
        return -(-tiles * s // (SMS * per_sm)) * (-(-chunks // s)
                                                  + FAST_SETUP)

    assert all(cost(s) > cost(plan.n_split) for s in range(1, plan.n_split))
    assert all(cost(s) >= cost(plan.n_split)
               for s in range(plan.n_split, chunks + 1))
    # tiles no smaller than the general plan's: no more of them, and each
    # covers at least as many of the map's sites
    assert -(-ho // plan.ty) * -(-wo // plan.tx) <= (
        -(-ho // gen.ty) * -(-wo // gen.tx))
    assert min(plan.ty, ho) * min(plan.tx, wo) >= (
        min(gen.ty, ho) * min(gen.tx, wo))
    return plan, gen


@pytest.mark.parametrize('site', R50_SITES[1:],
                         ids=lambda s: 'x'.join(map(str, s)))
def test_backbone_sites_plan(site):
    """R50's DCN sites (R101's have the same shapes) at 8 frames: the fast
    route, and a plan that fits, with tiles of 30 sites or more (the
    general one's take 16)."""
    h, w, cin, stride = site
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    assert col2im_fast(cin, FRAMES * h * w * cin, FRAMES * ho * wo * 9 * cin,
                       ALIGNED, ALIGNED, ALIGNED, ALIGNED)
    plan, gen = _check_fast_plan(ho, wo, cin, 3, 3, stride)
    assert plan.ty * plan.tx >= 30 and gen.ty * gen.tx == 16


def test_first_backbone_site_plan():
    """layer1_0 (stride 2: a footprint of 20 x 16 pixels for 7 x 5 sites)
    fits two blocks an SM, unsplit."""
    plan, _ = _check_fast_plan(48, 80, 128, 3, 3, 2)
    assert (plan.ty, plan.tx, plan.fh, plan.fw) == (7, 5, 20, 16)
    assert plan.n_split == 1 and plan.blocks == FRAMES * 7 * 16


@pytest.mark.parametrize('site', FCB_SITES,
                         ids=lambda s: f'{s[0]}x{s[1]}-{s[2]}x{s[3]}')
def test_fcb_sites_plan(site):
    """FCB's 15 sites at 8 frames: the fast route and a plan that fits; the
    small maps take one tile a frame, split over the channels."""
    h, w, kh, kw = site
    assert col2im_fast(256, FRAMES * h * w * 256,
                       FRAMES * h * w * kh * kw * 256, ALIGNED, ALIGNED,
                       ALIGNED, ALIGNED)
    plan, _ = _check_fast_plan(h, w, 256, kh, kw, 1)
    if h <= 8 and w <= 8:
        assert (plan.ty, plan.tx) == (h, w) and plan.n_split > 1


@pytest.mark.parametrize('kh,kw,stride,dilation', [
    (3, 3, 1, 1), (3, 3, 2, 1), (3, 5, 1, 1), (5, 3, 1, 1), (3, 3, 1, 2)])
def test_fast_footprint_holds_every_corner(kh, kw, stride, dilation):
    """The fast route's footprint holds every corner that the plain col2im
    touches from its tiles (of 5 to 8 sites a side here, ragged last)."""
    plan = check_footprint(kh, kw, stride, dilation, fast=True, hw=(29, 37))
    assert plan.route == 'fast' and min(plan.ty, plan.tx) >= 5


@pytest.mark.parametrize('case', [
    dict(cin=48), dict(cin=8), dict(cin=256), dict(cin=6, on=False),
    dict(cin=3, on=False), dict(cin=36, on=False),
    dict(dcols_off=2, on=False), dict(x_off=2, on=False),
    dict(dx32_off=4, on=False), dict(dx_off=2, on=False), dict(x_off=16),
    dict(x_numel=2 ** 31, on=False), dict(dcols_numel=2 ** 31, on=False)],
    ids=str)
def test_route_predicate(case):
    """On the route: Cin a multiple of 8 and every pointer 16-byte aligned
    (Cin 48 is on it).  Off it: ragged Cin (6), a tensor one element into
    its buffer, and tensors past 32-bit offsets."""
    a = dict(cin=64, dcols_off=0, x_off=0, dx32_off=0, dx_off=0,
             x_numel=1000, dcols_numel=9000, on=True)
    a.update(case)
    assert col2im_fast(a['cin'], a['x_numel'], a['dcols_numel'],
                       ALIGNED + a['dcols_off'], ALIGNED + a['x_off'],
                       ALIGNED + a['dx32_off'],
                       ALIGNED + a['dx_off']) == a['on']


def test_fast_plan_refuses_a_footprint_over_shared_memory():
    with pytest.raises(ValueError, match='shared memory'):
        col2im_plan(1, 8, 8, 64, 3, 3, 1, 1, radius=20, fast=True)


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(24, 40, 256, 1, 0), (9, 11, 6, 1, 0),
                                   (24, 40, 48, 2, 0), (24, 40, 256, 1, 1)],
                         ids=str)
def test_wrapper_routes_calls(monkeypatch, shape, off_dtype):
    """deform_col2im_cuda hands the bf16 entry of the offsets' type the
    route that col2im_fast decides (1 fast, 0 general) with that route's
    plan; fp32 calls keep the fp32 entry and its arguments.  Checked on the
    CPU with the CUDA checks and the launches replaced by recorders."""
    calls = []
    monkeypatch.setattr(K4, 'check_cuda', lambda *a, **k: None)
    for name in ('KERNEL', 'KERNEL_BF16', 'KERNEL_BF16_F32OFF'):
        monkeypatch.setattr(K4, name, lambda *a, _n=name: calls.append(
            (_n, a)))
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda d=None: _Stream)
    h, w, cin, stride, x_off = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    buf = torch.zeros(2 * h * w * cin + 8, dtype=torch.bfloat16)
    x = buf[x_off:x_off + 2 * h * w * cin].view(2, h, w, cin)
    dcols = torch.zeros(2 * ho * wo, 9 * cin, dtype=torch.bfloat16)
    off = torch.zeros(2, ho, wo, 18, dtype=off_dtype)
    mask = torch.zeros(2, ho, wo, 9, dtype=torch.bfloat16)
    dx, d_off, d_mask = K4.deform_col2im_cuda(dcols, x, off, mask, 3, 3,
                                              stride)
    assert dx.dtype == torch.bfloat16 and d_off.dtype == off_dtype
    name, args = calls.pop()
    assert name == ('KERNEL_BF16' if off_dtype == torch.bfloat16
                    else 'KERNEL_BF16_F32OFF')
    assert len(args) == len(K4._BF16) == 28
    fast = col2im_fast(cin, x.numel(), dcols.numel(), dcols.data_ptr(),
                       x.data_ptr(), args[4], args[5])
    assert fast == (cin % 8 == 0 and x_off == 0)
    # the route handed to the entry names the predicate's decision, and the
    # plan is that route's
    assert args[-2] == int(fast)
    plan = col2im_plan(2, ho, wo, cin, 3, 3, stride, 1, RADIUS, fast)
    assert args[20:26] == (plan.ty, plan.tx, plan.fh, plan.fw,
                           plan.n_split, plan.smem)
    assert args[:4] == (dcols.data_ptr(), x.data_ptr(), off.data_ptr(),
                        mask.data_ptr())
    assert args[5] == dx.data_ptr()
    # fp32: its own entry, its arguments as before (no route)
    fp32 = [t.float() for t in (dcols, x, off, mask)]
    dx, _, _ = K4.deform_col2im_cuda(*fp32, 3, 3, stride)
    name, args = calls.pop()
    assert name == 'KERNEL' and len(args) == 8 + len(K4._INTS) == 26
    gen = col2im_plan(2, ho, wo, cin, 3, 3, stride, 1, RADIUS)
    assert args[19:25] == (gen.ty, gen.tx, gen.fh, gen.fw, gen.n_split,
                           gen.smem)
    assert args[:5] == tuple(t.data_ptr() for t in fp32 + [dx])
