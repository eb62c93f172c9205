"""The DCN weight gradient on the CPU: ``deform_wgrad`` (there its plain
version, ``deform_wgrad_reference``) against ``jax.grad`` of the JAX
package's window-clamped deformable conv with respect to its weight; and
the kernel's launch plan (``wgrad_plan``) at the flagship's training sites
and FCB's, fp32 and bf16, and the wrapper's choice of the fast path
(``wgrad_fast``).  The same tolerance as the DCN window op's backward
test: 2e-6 relative to max|ref|."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.ops.deform_conv import deform_conv2d_window as j_dcn_window

from stmask_torch.kernels.deform_wgrad import (BS, MAX_SPLIT, deform_wgrad,
                                               deform_wgrad_reference,
                                               smem_bytes, wgrad_fast,
                                               wgrad_plan)
from torch_eval_common import few_torch_threads  # noqa: F401

# (stride, kh, kw, dilation, modulated, Cin, Cout): v2 3x3 at strides 1
# and 2, FCB's v1 3x5 and 5x3, dilation 2; Cin 3 or 6 and Cout 5 (ragged)
CASES = [(1, 3, 3, 1, True, 6, 5), (2, 3, 3, 1, True, 6, 5),
         (1, 3, 5, 1, False, 3, 5), (1, 5, 3, 1, False, 6, 5),
         (1, 3, 3, 2, True, 3, 5)]
RADIUS = 2
# the 7 DCN sites of the flagship's training step (8 frames at 384x640):
# (H, W, Cin = Cout), stride
TRAIN_SITES = [((96, 160, 128), 2), ((48, 80, 128), 1), ((48, 80, 256), 2),
               ((24, 40, 256), 1), ((24, 40, 256), 1), ((24, 40, 512), 2),
               ((12, 20, 512), 1)]
# FCB's sites at 8 frames: the 48x80 and 24x40 maps under its three taps,
# Cin = Cout = 256, stride 1
FCB_SITES = [((h, w, 256), kh, kw) for h, w in ((48, 80), (24, 40))
             for kh, kw in ((3, 3), (3, 5), (5, 3))]
SMEM_LIMIT = 227 * 1024      # shared memory one block may take on sm_90
SM_SMEM = 228 * 1024         # shared memory of one SM on sm_90
SMS = 132                    # the H100's SMs


def _offsets(kind, rng, shape):
    if kind == 'random':       # non-integer, some beyond +-2 (clamped)
        return (rng.randn(*shape) * 1.5).astype(np.float32)
    if kind == 'zero':         # the from-scratch state: every tap on a kink
        return np.zeros(shape, np.float32)
    return rng.choice([-2.0, -1.0, 1.0, 2.0], size=shape).astype(np.float32)


@pytest.mark.parametrize('kind', ['random', 'zero', 'integer'])
@pytest.mark.parametrize('case', CASES, ids=lambda c: (
    f's{c[0]}-{c[1]}x{c[2]}-d{c[3]}-{"v2" if c[4] else "v1"}-cin{c[5]}'))
def test_wgrad_reference_matches_jax_weight_grad(case, kind):
    stride, kh, kw, dilation, modulated, cin, cout = case
    rng = np.random.RandomState(100 * stride + 10 * kh + kw + dilation)
    b, h, w, k = 2, 7, 9, kh * kw
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(b, h, w, cin).astype(np.float32)
    off = _offsets(kind, rng, (b, ho, wo, 2 * k))
    mask = rng.rand(b, ho, wo, k).astype(np.float32) if modulated else None
    wt = (rng.randn(kh, kw, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    cot = rng.randn(b, ho, wo, cout).astype(np.float32)

    def loss(weight):
        out = j_dcn_window(jnp.asarray(x), jnp.asarray(off), weight,
                           None if mask is None else jnp.asarray(mask),
                           stride=stride, dilation=dilation, radius=RADIUS)
        return jnp.sum(out * cot)

    want = np.asarray(jax.grad(loss)(jnp.asarray(wt)))   # [kh, kw, Cin, Cout]
    # the window op hands the backward its clamped offsets
    args = (torch.from_numpy(cot.reshape(-1, cout)), torch.from_numpy(x),
            torch.from_numpy(np.clip(off, -RADIUS, RADIUS)),
            None if mask is None else torch.from_numpy(mask), kh, kw, stride,
            dilation)
    got = deform_wgrad(*args)
    assert tuple(got.shape) == (cout, kh, kw, cin)
    assert torch.equal(got, deform_wgrad_reference(*args))
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.permute(1, 2, 3, 0).numpy(), want, rtol=0,
                               atol=2e-6 * scale)


@pytest.mark.parametrize('shape,stride', TRAIN_SITES)
def test_wgrad_plan_fills_the_card_at_the_training_sites(shape, stride):
    h, w, cin = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    plan = wgrad_plan(8 * ho * wo, cin, 9 * cin)
    assert 1 <= plan.split <= MAX_SPLIT
    assert plan.split & (plan.split - 1) == 0     # it divides the tile
    assert plan.blocks >= SMS
    assert plan.smem <= SMEM_LIMIT
    # two blocks an SM with the 128-channel tile (256 threads), one with
    # the 256-channel tile (512 threads); 1 KB of each block is the system's
    per_sm = 256 // plan.tm
    assert per_sm * (plan.smem + 1024) <= SM_SMEM
    assert plan.tm == (256 if cin >= 256 else 128)
    # every block of a cluster has at least 8 chunks of sites
    assert -(-8 * ho * wo // BS) >= 8 * plan.split


def test_wgrad_plan_off_the_fast_path():
    """Shapes off the fast path keep the 128-channel tile, and tiny calls
    no split."""
    assert wgrad_plan(30720, 256, 2304, fast=False).tm == 128
    small = wgrad_plan(2 * 5 * 5, 5, 54)
    assert (small.tm, small.split, small.blocks) == (128, 1, 1)


@pytest.mark.parametrize('site', [(shape, stride, 3, 3)
                                  for shape, stride in TRAIN_SITES]
                         + [(shape, 1, kh, kw) for shape, kh, kw in FCB_SITES])
def test_wgrad_plan_bf16_fast_path(site):
    """The bf16 fast path at the flagship's 7 training sites and FCB's
    48x80 / 24x40 sites: the tile (256 channels where Cout allows), a split
    that gives every SM a block, shared memory for two blocks an SM at the
    128-channel tile and under the block limit at 256."""
    (h, w, cin), stride, kh, kw = site
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    m = 8 * ho * wo
    plan = wgrad_plan(m, cin, kh * kw * cin, fast=True, bf16=True)
    assert plan.tm == (256 if cin % 256 == 0 else 128)
    assert plan.split & (plan.split - 1) == 0
    assert 1 <= plan.split <= MAX_SPLIT * 128 // plan.tm
    assert plan.blocks >= SMS
    assert -(-m // BS) >= 8 * plan.split
    assert plan.smem == smem_bytes(plan.tm, bf16=True)
    assert plan.smem <= SMEM_LIMIT
    if plan.tm == 128:
        assert 2 * (plan.smem + 1024) <= SM_SMEM
    # the split's partial tile [TM][64] fp32 fits behind the alignment
    assert plan.tm * 64 * 4 <= plan.smem - 1024
    # the same tile and split as the fp32 entry takes there
    f32 = wgrad_plan(m, cin, kh * kw * cin, fast=True)
    assert (plan.tm, plan.split, plan.blocks) == (f32.tm, f32.split,
                                                  f32.blocks)


def test_wgrad_plan_bf16_off_the_fast_path():
    """The bf16 general path keeps the fp32 layout's shared memory and the
    128-channel tile."""
    plan = wgrad_plan(30720, 256, 2304, fast=False, bf16=True)
    assert plan.tm == 128 and plan.smem == smem_bytes(128)


@pytest.mark.parametrize('cin,cout,x_off,g_off,fast', [
    (128, 128, 0, 0, True), (256, 256, 0, 0, True), (512, 512, 0, 0, True),
    (32, 128, 0, 0, True), (48, 128, 0, 0, False), (256, 96, 0, 0, False),
    (256, 64, 0, 0, False), (256, 256, 2, 0, False),
    (256, 256, 0, 2, False), (256, 256, 16, 32, True)])
def test_wgrad_fast_decision(cin, cout, x_off, g_off, fast):
    """Both types take the fast path exactly where Cin is a multiple of
    32, Cout of 128, and x and g (byte addresses) of 16."""
    assert wgrad_fast(cin, cout, 4096 + x_off, 8192 + g_off) is fast


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_wrapper_routes_the_fast_path(monkeypatch, dtype):
    """deform_wgrad_cuda hands the launcher wgrad_plan's tile and split for
    ``wgrad_fast``'s decision and the entry of its types; checked on the
    CPU with the CUDA checks and the launch replaced by recorders."""
    from stmask_torch.kernels import deform_wgrad as KW
    calls = []
    monkeypatch.setattr(KW, 'check_cuda', lambda *a, **k: None)
    for name in ('KERNEL', 'KERNEL_BF16', 'KERNEL_BF16_F32OFF'):
        monkeypatch.setattr(KW, name, lambda *a, _n=name: calls.append(
            (_n, a)))

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, 'current_stream', lambda d=None: _Stream)
    for cin, cout in ((256, 256), (48, 96)):
        x = torch.zeros(2, 24, 40, cin, dtype=dtype)
        g = torch.zeros(2 * 24 * 40, cout, dtype=dtype)
        for off_dtype in {dtype, torch.float32}:
            off = torch.zeros(2, 24, 40, 18, dtype=off_dtype)
            KW.deform_wgrad_cuda(g, x, off, None, 3, 3)
            name, args = calls.pop()
            want = ('KERNEL' if dtype == torch.float32 else
                    'KERNEL_BF16' if off_dtype == dtype
                    else 'KERNEL_BF16_F32OFF')
            assert name == want
            fast = wgrad_fast(cin, cout, x.data_ptr(), g.data_ptr())
            assert fast == (cin == 256 and x.data_ptr() % 16 == 0
                            and g.data_ptr() % 16 == 0)
            plan = wgrad_plan(2 * 24 * 40, cout, 9 * cin, fast,
                              bf16=dtype == torch.bfloat16)
            assert args[16:18] == (plan.tm, plan.split)
