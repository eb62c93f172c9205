"""The fused deformable conv's launch plan and routes, on the CPU.

``conv_fast`` says which bf16 calls take the fast route (the Hopper kernel:
a warp-specialised gather ring feeding bf16 ``wgmma``) and ``conv_plan`` how
a call is cut (tile, ring stages, K-split, shared memory).  These tests hold
both at every DCN site of R50 and R101 (1 and 8 lanes) and FCB (8 frames),
and at shapes off the route; and hold the wrapper, with its CUDA checks and
launches replaced by recorders, to the plan's route, entry and split."""

import pytest
import torch

from stmask_torch.kernels import deform_conv as KD
from stmask_torch.kernels.deform_conv import (MAX_SPLIT, SMS, conv_fast,
                                              conv_plan, smem_bytes)

SMEM_LIMIT = 232448          # dynamic shared memory one block may take
# (H, W, Cin = Cout, stride) of the DCN input at 384x640: R50's 7 sites
# (dcn_layers (0, 4, 6, 3), interval 2) and R101's 11 (STMask_plus_base:
# (0, 4, 23, 3), interval 3), each site once, in the backbone's order
R50_SITES = [(96, 160, 128, 2), (48, 80, 128, 1), (48, 80, 256, 2),
             (24, 40, 256, 1), (24, 40, 256, 1), (24, 40, 512, 2),
             (12, 20, 512, 1)]
R101_SITES = ([(96, 160, 128, 2), (48, 80, 128, 1), (48, 80, 256, 2)]
              + [(24, 40, 256, 1)] * 7 + [(24, 40, 512, 2)])
# FCB's 15 sites: P3..P7 under 3x3, 3x5 and 5x3 v1 taps, Cin = Cout = 256
FCB_SITES = [(h, w, kh, kw) for h, w in ((48, 80), (24, 40), (12, 20),
                                         (6, 10), (3, 5))
             for kh, kw in ((3, 3), (3, 5), (5, 3))]
ALIGNED = 4096               # a 16-byte aligned byte address


def _check_fast_plan(m, cin, cout, kh, kw):
    plan = conv_plan(m, cin, cout, kh, kw, fast=True)
    nk = kh * kw * cin // plan.bk
    tiles = -(-m // plan.bm) * (cout // plan.bn)
    assert plan.route == 'fast' and plan.threads == 512
    assert (plan.bm, plan.bn) == ((64, 256) if cout % 256 == 0
                                  else (128, 128))
    assert plan.blocks == tiles * plan.split
    assert plan.smem == smem_bytes(True, taps=kh * kw, bm=plan.bm)
    assert plan.smem <= SMEM_LIMIT
    # the split's partial tile [bm][bn] fp32 fits in the ring
    assert plan.bm * plan.bn * 4 <= plan.stages * (plan.bm + plan.bn) * 128
    # a power of two, no split without chunks: every block two or more
    assert plan.split & (plan.split - 1) == 0
    assert 1 <= plan.split <= MAX_SPLIT
    assert nk >= 2 * plan.split
    # the grid fills the card, or a larger split would add a wave for no
    # fewer waves a share of K (or leave a block less than two chunks)

    def cost(s):
        return -(-tiles * s // SMS) / s

    s2 = 2 * plan.split
    assert (plan.blocks >= SMS or s2 > MAX_SPLIT or nk < 2 * s2
            or cost(s2) >= cost(plan.split))
    return plan


@pytest.mark.parametrize('lanes', [1, 8])
@pytest.mark.parametrize('site', R50_SITES + R101_SITES[:3],
                         ids=lambda s: 'x'.join(map(str, s)))
def test_backbone_sites_plan(site, lanes):
    """Every R50 and R101 DCN site (R101's shapes are R50's), one lane and
    the eval CLI's eight: the fast route, and a plan that fits."""
    h, w, cin, stride = site
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    assert conv_fast(cin, cin, 3, 3, 1, ALIGNED, ALIGNED, ALIGNED)
    plan = _check_fast_plan(lanes * ho * wo, cin, cin, 3, 3)
    if lanes == 8 and cin <= 256:
        # the tiles alone give every SM a block, or nearly: no split
        assert plan.split == 1


def test_r101_sites_are_r50_shapes():
    """R101's 11 sites have R50's shapes (so the cases above cover them)."""
    assert set(R101_SITES) <= set(R50_SITES) and len(R101_SITES) == 11


@pytest.mark.parametrize('site', FCB_SITES,
                         ids=lambda s: f'{s[0]}x{s[1]}-{s[2]}x{s[3]}')
def test_fcb_sites_plan(site):
    """FCB's 15 sites at 8 frames: the fast route, and a plan that fits;
    the small maps (P5..P7) split K over a cluster, the large ones not."""
    h, w, kh, kw = site
    assert conv_fast(256, 256, kh, kw, 1, ALIGNED, ALIGNED, ALIGNED)
    plan = _check_fast_plan(8 * h * w, 256, 256, kh, kw)
    assert (plan.split > 1) == (h * w < 24 * 40)


@pytest.mark.parametrize('case', [
    dict(cin=3, cout=128), dict(cin=6, cout=128), dict(cin=48, cout=128),
    dict(cin=256, cout=5), dict(cin=64, cout=36), dict(cin=64, cout=96),
    dict(dilation=2), dict(x_off=2), dict(w_off=2), dict(out_off=8),
    dict(kh=5, kw=5)], ids=str)
def test_off_route_shapes(case):
    """Ragged Cin and Cout, dilation 2, a pointer off 16 bytes or more than
    16 taps: the general route, whose plan is the general kernel's own."""
    a = dict(cin=64, cout=128, kh=3, kw=3, dilation=1, x_off=0, w_off=0,
             out_off=0)
    a.update(case)
    assert not conv_fast(a['cin'], a['cout'], a['kh'], a['kw'],
                         a['dilation'], ALIGNED + a['x_off'],
                         ALIGNED + a['w_off'], ALIGNED + a['out_off'])
    assert conv_fast(64, 128, 3, 3, 1, ALIGNED, ALIGNED, ALIGNED)
    plan = conv_plan(2 * 9 * 11, a['cin'], a['cout'], a['kh'], a['kw'],
                     fast=False)
    assert plan.route == 'general' and (plan.bm, plan.bn) == (64, 128)
    assert plan.smem == smem_bytes(False, bf16=True) <= SMEM_LIMIT


def test_general_plan_is_the_kernels_rule():
    """The general route's plan leaves the split to the general kernel's
    own rule, in its launcher: split 0, which also names the route to the
    bf16 entry, over the general kernel's 64 x 128 tiles."""
    # (sites, Cin, Cout, tiles of 64 sites x 128 channels)
    for m, cin, cout, tiles in ((4 * 24 * 40, 64, 36, 60),
                                (12 * 20, 64, 36, 4), (2 * 9 * 11, 6, 5, 4),
                                (3 * 5, 512, 128, 1)):
        plan = conv_plan(m, cin, cout, 3, 3, fast=False)
        assert (plan.route, plan.split, plan.blocks) == ('general', 0, tiles)
        assert (plan.bk, plan.stages, plan.threads) == (32, 3, 256)
    # no fast plan names the general route
    assert conv_plan(15, 512, 128, 3, 3).split >= 1


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(24, 40, 256, 256, 1, 0),
                                   (9, 11, 6, 5, 1, 0),
                                   (24, 40, 64, 128, 2, 0),
                                   (24, 40, 256, 256, 1, 1)], ids=str)
def test_wrapper_routes_bf16_calls(monkeypatch, shape, off_dtype):
    """deform_conv_cuda hands the bf16 entry of the offsets' type the
    plan's split for conv_fast's decision (from shapes and pointers alone),
    0 for the general route; fp32 calls keep the fp32 entry without a
    split.  Checked on the CPU
    with the CUDA checks and the launches replaced by recorders."""
    calls = []
    monkeypatch.setattr(KD, 'check_cuda', lambda *a, **k: None)
    for name in ('KERNEL', 'KERNEL_BF16', 'KERNEL_BF16_F32OFF'):
        monkeypatch.setattr(KD, name, lambda *a, _n=name: calls.append(
            (_n, a)))
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda d=None: _Stream)
    h, w, cin, cout, dil, x_off = shape
    buf = torch.zeros(2 * h * w * cin + 8, dtype=torch.bfloat16)
    x = buf[x_off:x_off + 2 * h * w * cin].view(2, h, w, cin)
    wt = torch.zeros(cout, 3, 3, cin, dtype=torch.bfloat16)
    off = torch.zeros(2, h, w, 18, dtype=off_dtype)
    mask = torch.zeros(2, h, w, 9, dtype=torch.bfloat16)
    KD.deform_conv_cuda(x, off, wt, mask, None, 1, dil)
    name, args = calls.pop()
    assert name == ('KERNEL_BF16' if off_dtype == torch.bfloat16
                    else 'KERNEL_BF16_F32OFF')
    fast = conv_fast(cin, cout, 3, 3, dil, x.data_ptr(), wt.data_ptr(),
                     args[5])
    assert fast == (cin % 64 == 0 and cout % 128 == 0 and dil == 1
                    and x_off == 0)
    plan = conv_plan(2 * h * w, cin, cout, 3, 3, fast)
    # the split handed to the entry names the route: 0 the general one
    assert len(args) == 21 and args[19] == plan.split
    assert (args[19] > 0) == fast == (plan.route == 'fast')
    assert args[:2] == (x.data_ptr(), off.data_ptr())
    # fp32: its own entry, its arguments as before (no split)
    KD.deform_conv_cuda(x.float(), off.float(), wt.float(), mask.float(),
                        None, 1, dil)
    name, args = calls.pop()
    assert name == 'KERNEL' and len(args) == 20
