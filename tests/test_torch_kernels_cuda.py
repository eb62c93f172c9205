"""CUDA kernels K1 (correlation, fp32 and bf16), K2 (deformable gather),
the fused deformable conv (fp32 and bf16), K3 (correlation backward), K4
(deformable col2im), the DCN weight gradient (deform_wgrad), K5 (the
exact gather's backward) and B5 (greedy NMS) against their plain PyTorch
versions, on the card.  Marked
``cuda``; without a GPU every test skips with its reason.  Run on a GPU
machine with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``."""

import pytest
import torch

# B5's shapes and inputs are chip_smoke.py phase 10a's; the bf16 backward
# entries' check is its phase 14a's (one bf16 ulp of each value plus 2^-12
# of max|ref|, bit for bit over two launches where no atomics sum)
from chip_smoke import (GREEDY_SHAPES, _bf16_err, _boxes_args,
                        _degenerate_boxes, _exact_check, _exact_inputs,
                        _exact_typed, _general_route, _greedy_boxes,
                        _greedy_inputs, _near_threshold_boxes)
from stmask_torch.kernels import correlation as K1
from stmask_torch.kernels import correlation_bwd as K3
from stmask_torch.kernels import deform_col2im as K4
from stmask_torch.kernels import deform_conv as KD
from stmask_torch.kernels import deform_im2col as K2
from stmask_torch.kernels import deform_wgrad as KW
from stmask_torch.ops.correlation import correlate
from stmask_torch.ops.deform_conv import (deform_conv2d, deform_conv_exact,
                                          deform_conv_window)

pytestmark = pytest.mark.cuda

# (B, H, W, C): ragged borders, and the main path's FPN level 1 at 384x640
CORR_SHAPES = [(2, 7, 9, 96), (1, 3, 2, 5), (1, 24, 40, 256),
               (1, 5, 70, 40)]
# the fused kernel's tolerance: 3xTF32 holds ~3e-7 of the fp32 plain
# version here, a single TF32 product (weights scaled by 1/K) 2e-5 to 5e-5
FUSED_ATOL = 5e-6
# (H, W, Cin, stride): small ragged shapes and the 7 main-path DCN sites
DCN_SHAPES = [(9, 11, 6, 1), (9, 11, 6, 2), (5, 4, 3, 2),
              (96, 160, 128, 2), (48, 80, 128, 1), (48, 80, 256, 2),
              (24, 40, 256, 1), (24, 40, 512, 2), (12, 20, 512, 1)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.parametrize('shape', CORR_SHAPES)
@pytest.mark.parametrize('patch', [5, 11, 17, 31])
def test_correlation_kernel(device, shape, patch):
    g = torch.Generator(device=device).manual_seed(0)
    x1 = torch.randn(shape, device=device, generator=g)
    x2 = torch.randn(shape, device=device, generator=g)
    for act in (True, False):
        got = K1.correlate_cuda(x1, x2, patch, act)
        want = K1.correlate_reference(x1, x2, patch, act)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('shape', DCN_SHAPES)
def test_deform_gather_kernel(device, shape):
    h, w, cin, stride = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(1, h, w, cin, device=device, generator=g)
    off = torch.randn(1, ho, wo, 18, device=device, generator=g) * 2.0
    mask = torch.rand(1, ho, wo, 9, device=device, generator=g)
    for m in (mask, None):
        got = K2.deform_im2col_cuda(x, off, m, 3, 3, stride)
        want = K2.deform_im2col_reference(x, off, m, 3, 3, stride)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    wt = torch.randn(3, 3, cin, 64, device=device, generator=g) / (3 * cin)
    cols = K2.deform_im2col_cuda(x, off, mask, 3, 3, stride)
    want = (K2.deform_im2col_reference(x, off, mask, 3, 3, stride)
            @ wt.reshape(-1, 64))
    torch.cuda.synchronize()
    torch.testing.assert_close(cols @ wt.reshape(-1, 64), want, atol=1e-4,
                               rtol=0)


def _dcn_case(device, h, w, cin, cout, kh, kw, stride, dilation, seed,
              frames=1):
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(frames, h, w, cin, device=device, generator=g)
    off = torch.randn(frames, ho, wo, 2 * kh * kw, device=device,
                      generator=g) * 2.0
    mask = torch.rand(frames, ho, wo, kh * kw, device=device, generator=g)
    wt = torch.randn(cout, kh, kw, cin, device=device,
                     generator=g) / (kh * kw * cin)
    bias = torch.randn(cout, device=device, generator=g)
    return x, off, mask, wt, bias


# FCB's 15 sites at 384x640: P3..P7 under 3x3, 3x5 and 5x3 v1 taps,
# Cin = Cout = 256, stride 1 (P7's 3x5 under 5x3 taps: every footprint past
# both edges; P6's 6x10 off K4's 4x4 tile)
FCB_SITES = [(h, w, kh, kw) for h, w in ((48, 80), (24, 40), (12, 20),
                                         (6, 10), (3, 5))
             for kh, kw in ((3, 3), (3, 5), (5, 3))]
# (H, W, Cin, Cout, kh, kw, stride, dilation): the 7 DCN sites, ragged
# channels and strides, rectangular v1 taps, dilation 2, then the FCB sites
# not among them
FUSED_SHAPES = [(h, w, cin, cin, 3, 3, s, 1) for h, w, cin, s in DCN_SHAPES
                ] + [(9, 11, 6, 5, 3, 5, 1, 1), (9, 11, 6, 5, 5, 3, 2, 1),
                     (13, 7, 64, 36, 3, 3, 1, 2)]
FUSED_SHAPES += [s for s in ((h, w, 256, 256, kh, kw, 1, 1)
                             for h, w, kh, kw in FCB_SITES)
                 if s not in FUSED_SHAPES]


@pytest.mark.parametrize('shape', FUSED_SHAPES)
def test_fused_deform_conv_kernel(device, shape):
    h, w, cin, cout, kh, kw, stride, dil = shape
    x, off, mask, wt, bias = _dcn_case(device, h, w, cin, cout, kh, kw,
                                       stride, dil, 2)
    for m in (mask, None):
        for b in (bias, None):
            launches = KD.KERNEL.launches
            got = KD.deform_conv_cuda(x, off, wt, m, b, stride, dil)
            assert KD.KERNEL.launches == launches + 1
            want = KD.deform_conv_reference(x, off, wt, m, b, stride, dil)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=FUSED_ATOL, rtol=0)


def test_fused_kernel_reads_strided_offset_and_mask(device):
    """The DCN module hands over channel slices of one [.., 27] tensor."""
    x, _, _, wt, bias = _dcn_case(device, 24, 40, 256, 256, 3, 3, 1, 1, 3)
    om = torch.randn(1, 24, 40, 27, device=device)
    off, mask = om[..., :18], torch.sigmoid(om[..., 18:])
    got = KD.deform_conv_cuda(x, off, wt, om[..., 18:], bias)
    want = KD.deform_conv_reference(x, off, wt, om[..., 18:], bias)
    torch.testing.assert_close(got, want, atol=FUSED_ATOL, rtol=0)
    got = KD.deform_conv_cuda(x, off, wt, mask, bias)
    want = KD.deform_conv_reference(x, off, wt, mask, bias)
    torch.testing.assert_close(got, want, atol=FUSED_ATOL, rtol=0)


@pytest.mark.parametrize('shape', DCN_SHAPES)
def test_deform_conv2d_takes_the_fused_kernel(device, shape):
    h, w, cin, stride = shape
    x, off, mask, wt, bias = _dcn_case(device, h, w, cin, 64, 3, 3, stride,
                                       1, 4)
    fused, gather = KD.KERNEL.launches, K2.KERNEL.launches
    got = deform_conv2d(x, off, wt.permute(1, 2, 3, 0), mask, bias,
                        stride=stride)                        # HWIO weight
    assert KD.KERNEL.launches == fused + 1
    assert K2.KERNEL.launches == gather
    want = KD.deform_conv_reference(x, off, wt, mask, bias, stride)
    torch.testing.assert_close(got, want, atol=FUSED_ATOL, rtol=0)


def _bf16_atol(want: torch.Tensor) -> float:
    """Two to four bf16 ulps of max|want|: the kernel and the plain bf16
    version round at the same points and sum the product in fp32 in another
    order, so a sum near a rounding boundary can round the other way."""
    return float(want.float().abs().max()) * 2.0 ** -6


@pytest.mark.parametrize('shape', CORR_SHAPES)
@pytest.mark.parametrize('patch', [5, 11])
def test_correlation_kernel_bf16(device, shape, patch):
    """bf16 inputs: every product rounded to bf16 on both sides, so only
    the fp32 sum's order differs (fp32 tolerance)."""
    g = torch.Generator(device=device).manual_seed(5)
    x1 = torch.randn(shape, device=device, generator=g).bfloat16()
    x2 = torch.randn(shape, device=device, generator=g).bfloat16()
    for act in (True, False):
        fp32, bf16 = K1.KERNEL.launches, K1.KERNEL_BF16.launches
        got = K1.correlate_cuda(x1, x2, patch, act)
        assert (K1.KERNEL.launches, K1.KERNEL_BF16.launches) == (fp32,
                                                                 bf16 + 1)
        want = K1.correlate_reference(x1, x2, patch, act)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# K1 bf16's fast route: the eval shape, C 8, 16 and 264, W below and above
# the 64-column tile, H below the patch
CORR_FAST_SHAPES = [(1, 24, 40, 256), (2, 7, 9, 8), (1, 5, 70, 16),
                    (1, 6, 9, 264), (2, 3, 130, 8)]


@pytest.mark.parametrize('shape', CORR_FAST_SHAPES)
@pytest.mark.parametrize('patch', [1, 5, 11, 31])
def test_correlation_kernel_bf16_fast_route(device, shape, patch):
    """The fast route (C % 8 == 0, aligned maps) against the plain version
    at the fp32 tolerance, bit for bit over two launches."""
    g = torch.Generator(device=device).manual_seed(7)
    x1 = torch.randn(shape, device=device, generator=g).bfloat16()
    x2 = torch.randn(shape, device=device, generator=g).bfloat16()
    assert K1.corr_fast(shape[-1], x1.data_ptr(), x2.data_ptr())
    for act in (True, False):
        got = K1.correlate_cuda(x1, x2, patch, act)
        again = K1.correlate_cuda(x1, x2, patch, act)
        want = K1.correlate_reference(x1, x2, patch, act)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        assert torch.equal(got, again)


@pytest.mark.parametrize('shape', [(1, 24, 40, 256), (2, 7, 9, 8)])
def test_correlation_kernel_bf16_unaligned_takes_the_general_route(device,
                                                                   shape):
    """Maps one element into their buffers go to the general route (the
    predicate says no), and it agrees with the plain version; the entry
    refuses a fast call such maps, or C % 8 != 0, cannot take."""
    n = torch.Size(shape).numel()
    g = torch.Generator(device=device).manual_seed(8)
    buf = torch.randn(2 * n + 2, device=device, generator=g).bfloat16()
    x1, x2 = buf[1:n + 1].view(shape), buf[n + 1:2 * n + 1].view(shape)
    assert not K1.corr_fast(shape[-1], x1.data_ptr(), x2.data_ptr())
    got = K1.correlate_cuda(x1, x2, 11)
    want = K1.correlate_reference(x1, x2, 11)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    out = torch.empty(shape[:3] + (121,), device=device)
    stream = torch.cuda.current_stream().cuda_stream
    with pytest.raises(RuntimeError, match='CUDA error'):
        K1.KERNEL_BF16(x1.data_ptr(), x2.data_ptr(), out.data_ptr(),
                       *shape, 11, 1, 1, stream)
    y = torch.zeros(1, 4, 5, 12, device=device, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match='CUDA error'):
        K1.KERNEL_BF16(y.data_ptr(), y.data_ptr(), out.data_ptr(), 1, 4, 5,
                       12, 11, 1, 1, stream)


def test_correlation_fast_and_general_routes_agree(device):
    """At the eval shape the two routes sum in other orders: both within
    the fp32 tolerance of the plain version and of each other."""
    g = torch.Generator(device=device).manual_seed(9)
    x1 = torch.randn(1, 24, 40, 256, device=device,
                     generator=g).bfloat16()
    x2 = torch.randn(1, 24, 40, 256, device=device,
                     generator=g).bfloat16()
    fast = K1.correlate_cuda(x1, x2, 11)
    own = K1.corr_fast
    try:
        K1.corr_fast = lambda *a: False
        general = K1.correlate_cuda(x1, x2, 11)
    finally:
        K1.corr_fast = own
    torch.cuda.synchronize()
    torch.testing.assert_close(fast, general, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', FUSED_SHAPES)
def test_fused_deform_conv_kernel_bf16(device, shape, off_dtype):
    """bf16 x, weight, mask and bias with bf16 offsets (the bf16 entry)
    or fp32 offsets (the entry FCB's ali offsets take)."""
    h, w, cin, cout, kh, kw, stride, dil = shape
    x, off, mask, wt, bias = _dcn_case(device, h, w, cin, cout, kh, kw,
                                       stride, dil, 6)
    x, mask, wt, bias = (t.bfloat16() for t in (x, mask, wt, bias))
    off = off.to(off_dtype)
    entries = (KD.KERNEL, KD.KERNEL_BF16, KD.KERNEL_BF16_F32OFF)
    once = tuple(int(k is (KD.KERNEL_BF16 if off_dtype == torch.bfloat16
                           else KD.KERNEL_BF16_F32OFF)) for k in entries)
    for m in (mask, None):
        for b in (bias, None):
            n = [k.launches for k in entries]
            got = KD.deform_conv_cuda(x, off, wt, m, b, stride, dil)
            assert tuple(k.launches - n_ for k, n_ in zip(entries, n)) == once
            want = KD.deform_conv_reference(x, off, wt, m, b, stride, dil)
            torch.cuda.synchronize()
            assert got.dtype == torch.bfloat16
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=_bf16_atol(want), rtol=0)


def test_fused_kernel_bf16_reads_strided_offset_and_mask(device):
    """bf16 offset and mask as channel slices of one [.., 27] tensor: site
    rows 54 bytes apart, not 16-byte aligned."""
    x, _, _, wt, bias = (t.bfloat16() for t in _dcn_case(
        device, 24, 40, 256, 256, 3, 3, 1, 1, 7))
    om = torch.randn(1, 24, 40, 27, device=device).bfloat16()
    off, mask = om[..., :18], torch.sigmoid(om[..., 18:])
    for m in (om[..., 18:], mask):
        got = KD.deform_conv_cuda(x, off, wt, m, bias)
        want = KD.deform_conv_reference(x, off, wt, m, bias)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=_bf16_atol(want), rtol=0)


def test_wrappers_reject_bad_inputs(device):
    x = torch.zeros(1, 4, 5, 8, device=device)
    with pytest.raises(TypeError):
        K1.correlate_cuda(x.double(), x.double())
    with pytest.raises(ValueError):
        K1.correlate_cuda(x, x.transpose(1, 2).contiguous())
    with pytest.raises(ValueError):
        K1.correlate_cuda(x.transpose(1, 2), x.transpose(1, 2))
    with pytest.raises(ValueError):
        K2.deform_im2col_cuda(x, torch.zeros(1, 4, 5, 16, device=device),
                              None, 3, 3)
    with pytest.raises(ValueError):
        KD.deform_conv_cuda(x, torch.zeros(1, 4, 5, 18, device=device),
                            torch.zeros(3, 3, 3, 7, device=device), None,
                            None)
    with pytest.raises(ValueError):
        K1.correlate_cuda(x, x, 33)
    with pytest.raises(TypeError):              # mixed fp32 and bf16
        K1.correlate_cuda(x, x.bfloat16())
    with pytest.raises(TypeError):
        KD.deform_conv_cuda(x.bfloat16(),
                            torch.zeros(1, 4, 5, 18, device=device),
                            torch.zeros(3, 3, 3, 8, device=device), None,
                            None)


# K3: the training shape (4 clips at 384x640), two column tiles (W > 64),
# H and W below the patch, C 40 and 5 (not a multiple of 4), patch 1, 5, 11
# and 31 (G limits its tile to 16 columns)
CORR_BWD_SHAPES = [((4, 24, 40, 256), 11), ((2, 7, 9, 96), 11),
                   ((1, 5, 7, 40), 5), ((2, 9, 5, 5), 11),
                   ((2, 48, 80, 256), 11), ((1, 4, 3, 40), 11),
                   ((2, 3, 70, 5), 5), ((1, 6, 5, 12), 1),
                   ((1, 20, 40, 64), 31)]


def _corr_bwd_case(device, shape, patch, seed=5):
    """x1, x2, an upstream gradient and a forward output with negatives
    and exact zeros (where JAX's leaky ReLU has slope 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x1 = torch.randn(shape, device=device, generator=g)
    x2 = torch.randn(shape, device=device, generator=g)
    pp = shape[:3] + (patch * patch,)
    up = torch.randn(pp, device=device, generator=g)
    out = torch.randn(pp, device=device, generator=g)
    out[torch.rand(pp, device=device, generator=g) < 0.2] = 0.0
    return up, x1, x2, out


@pytest.mark.parametrize('act', [True, False])
@pytest.mark.parametrize('shape,patch', CORR_BWD_SHAPES)
def test_correlation_bwd_kernel(device, shape, patch, act):
    """Within 1e-5 of the plain version (the sums differ only in their
    order), one launch a call, bit for bit the same on a second launch."""
    up, x1, x2, out = _corr_bwd_case(device, shape, patch)
    out = out if act else None
    launches = K3.KERNEL.launches
    got = K3.correlation_bwd_cuda(up, x1, x2, patch, out=out)
    assert K3.KERNEL.launches == launches + 1
    again = K3.correlation_bwd_cuda(up, x1, x2, patch, out=out)
    want = K3.correlation_bwd_reference(up, x1, x2, patch, out=out)
    torch.cuda.synchronize()
    for a, a2, b in zip(got, again, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        assert torch.equal(a, a2)


def test_correlation_bwd_kernel_reads_a_channel_slice(device):
    """g as torch.cat's backward hands it over (a channel slice of a wider
    gradient) is read in place and gives what its contiguous copy gives."""
    up, x1, x2, out = _corr_bwd_case(device, (2, 9, 13, 24), 5, seed=6)
    wide = torch.randn(2, 9, 13, 25 + 48, device=device)
    wide[..., :25] = up
    g = wide[..., :25]
    assert not g.is_contiguous() and K3.pixel_stride(g) == 73
    got = K3.correlation_bwd_cuda(g, x1, x2, 5, out=out)
    want = K3.correlation_bwd_cuda(up, x1, x2, 5, out=out)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match='evenly spaced'):
        K3.correlation_bwd_cuda(up.transpose(1, 2).contiguous().transpose(
            1, 2), x1, x2, 5)


def _col2im_case(device, h, w, cin, stride, kind, seed, kh=3, kw=3,
                 dilation=1):
    k = kh * kw                  # odd taps, padded to keep the size
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(2, h, w, cin, device=device, generator=g)
    if kind == 'random':
        off = torch.randn(2, ho, wo, 2 * k, device=device, generator=g) * 1.5
    elif kind == 'zero':
        off = torch.zeros(2, ho, wo, 2 * k, device=device)
    else:
        vals = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=device)
        off = vals[torch.randint(0, 4, (2, ho, wo, 2 * k), device=device,
                                 generator=g)]
    off = off.clamp(-2, 2)
    mask = torch.rand(2, ho, wo, k, device=device, generator=g)
    dcols = torch.randn(2 * ho * wo, k * cin, device=device, generator=g)
    return dcols, x, off, mask


def _check_col2im(dcols, x, off, mask, kh, kw, stride, dilation=1):
    """K4 against its plain version: dx sums with fp32 atomics, so its
    tolerance is relative to max|ref|; d_offset and d_mask are summed in a
    fixed order, so a second launch gives them bit for bit."""
    launches = K4.KERNEL.launches
    got = K4.deform_col2im_cuda(dcols, x, off, mask, kh, kw, stride,
                                dilation)
    assert K4.KERNEL.launches == launches + 1
    again = K4.deform_col2im_cuda(dcols, x, off, mask, kh, kw, stride,
                                  dilation)
    want = K4.deform_col2im_reference(dcols, x, off, mask, kh, kw, stride,
                                      dilation)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, atol=1e-5 * max(scale, 1.0),
                                   rtol=0)
    assert torch.equal(got[1], again[1])
    assert (got[2] is None) == (mask is None)
    if mask is not None:
        assert torch.equal(got[2], again[2])


@pytest.mark.parametrize('kind', ['random', 'zero', 'integer'])
@pytest.mark.parametrize('shape', [(9, 11, 6, 1), (9, 11, 6, 2),
                                   (24, 40, 256, 1), (24, 40, 512, 2),
                                   (7, 5, 3, 1)])
def test_deform_col2im_kernel(device, shape, kind):
    h, w, cin, stride = shape
    dcols, x, off, mask = _col2im_case(device, h, w, cin, stride, kind, 6)
    for m in (mask, None):
        _check_col2im(dcols, x, off, m, 3, 3, stride)


# (H, W, Cin, stride, kh, kw, dilation): FCB's 3x5 and 5x3 taps, dilation
# 2, ragged Cin (3, 6), H and W that are no multiple of the tile, and images
# inside the border band (each footprint past every edge of the image)
COL2IM_SHAPES = [(24, 40, 64, 1, 3, 5, 1), (24, 40, 64, 1, 5, 3, 1),
                 (24, 40, 64, 1, 3, 3, 2), (19, 37, 3, 1, 3, 3, 1),
                 (19, 37, 6, 2, 3, 3, 1), (13, 21, 40, 1, 3, 3, 1),
                 (3, 4, 8, 1, 3, 3, 1), (2, 3, 36, 2, 3, 3, 1)]


@pytest.mark.parametrize('kind', ['random', 'integer'])
@pytest.mark.parametrize('shape', COL2IM_SHAPES)
def test_deform_col2im_kernel_shapes(device, shape, kind):
    h, w, cin, stride, kh, kw, dilation = shape
    dcols, x, off, mask = _col2im_case(device, h, w, cin, stride, kind, 8,
                                       kh, kw, dilation)
    for m in (mask, None):
        _check_col2im(dcols, x, off, m, kh, kw, stride, dilation)


@pytest.mark.parametrize('stride', [1, 2])
def test_correlation_and_dcn_functions_match_cpu(device, stride):
    """The autograd Functions on the card (K1 + K3; the fused kernel, K2,
    two matmuls and K4) against their CPU plain paths."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 24, 40, 64, generator=g)
    ho, wo = (24 - 1) // stride + 1, (40 - 1) // stride + 1
    off = torch.randn(2, ho, wo, 18, generator=g) * 1.5
    off[0, 0, 0, :4] = torch.tensor([2.0, -2.0, 0.0, 1.0])
    mask = torch.rand(2, ho, wo, 9, generator=g)
    wt = torch.randn(64, 3, 3, 64, generator=g) / 24
    bias = torch.randn(64, generator=g)
    cot = torch.randn(2, ho, wo, 64, generator=g)
    grads = []
    for dev in ('cpu', device):
        ts = [t.detach().to(dev).requires_grad_(True)
              for t in (x, off, wt, mask, bias)]
        (deform_conv_window(*ts, stride=stride) * cot.to(dev)).sum(
            ).backward()
        grads.append([t.grad.cpu() for t in ts])
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, atol=2e-4 * max(
            float(b.abs().max()), 1.0), rtol=0)
    x1, x2 = (torch.randn(2, 24, 40, 64, generator=g) for _ in range(2))
    up = torch.randn(2, 24, 40, 121, generator=g)
    grads = []
    for dev in ('cpu', device):
        ts = [t.detach().to(dev).requires_grad_(True) for t in (x1, x2)]
        (correlate(*ts) * up.to(dev)).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)



def test_correlation_backward_through_cat(device):
    """As in the model's training forward, relu(cat[correlation, t]): the
    op's backward gets a channel slice of the cat's gradient and launches
    K3 once; the gradients match the CPU path's."""
    g = torch.Generator().manual_seed(8)
    x1, x2 = (torch.randn(2, 24, 40, 64, generator=g) for _ in range(2))
    t = torch.randn(2, 24, 40, 32, generator=g)
    up = torch.randn(2, 24, 40, 121 + 32, generator=g)
    grads = []
    for dev in ('cpu', device):
        ts = [a.detach().to(dev).requires_grad_(True) for a in (x1, x2)]
        y = torch.relu(torch.cat([correlate(*ts), t.to(dev)], dim=-1))
        launches = K3.KERNEL.launches
        (y * up.to(dev)).sum().backward()
        assert K3.KERNEL.launches == launches + (dev != 'cpu')
        grads.append([a.grad.cpu() for a in ts])
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)

# deform_wgrad against its plain version, relative to max|ref|: 3xTF32
# holds ~1e-6 over up to 30720 sites, a single TF32 product ~8e-4
WGRAD_RTOL = 1e-5


def _check_wgrad(g, x, off, mask, kh, kw, stride, dilation=1, run=None):
    """The kernel within WGRAD_RTOL of its plain version, one launch a
    call, and bit for bit the same on a second launch (no atomics).
    ``run`` launches it (the wrapper by default)."""
    run = run or (lambda: KW.deform_wgrad_cuda(g, x, off, mask, kh, kw,
                                               stride, dilation))
    launches = KW.KERNEL.launches
    got = run()
    assert KW.KERNEL.launches == launches + 1
    again = run()
    want = KW.deform_wgrad_reference(g, x, off, mask, kh, kw, stride,
                                     dilation)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=WGRAD_RTOL * float(
        want.abs().max()))
    assert torch.equal(got, again)


def _wgrad_launch(g, x, off, mask, kh, kw, stride, tm, split,
                  kernel=KW.KERNEL):
    """The kernel's launcher (``kernel``: an entry of deform_wgrad) called
    with an explicit tile height and cluster split (the wrapper always
    takes ``wgrad_plan``'s)."""
    b, h, w, cin = x.shape
    _, ho, wo, _ = off.shape
    dw = torch.empty((g.shape[1], kh, kw, cin), device=x.device,
                     dtype=x.dtype)
    kernel(g.data_ptr(), x.data_ptr(), off.data_ptr(),
              None if mask is None else mask.data_ptr(), dw.data_ptr(),
              b, h, w, cin, ho, wo, g.shape[1], kh, kw, stride, 1, tm, split,
              torch.cuda.current_stream(x.device).cuda_stream)
    return dw


@pytest.mark.parametrize('kind', ['random', 'zero', 'integer'])
@pytest.mark.parametrize('shape', [(9, 11, 32, 1), (9, 11, 64, 2),
                                   (24, 40, 128, 1), (24, 40, 256, 2),
                                   (12, 20, 512, 1), (7, 5, 3, 1)])
def test_deform_wgrad_kernel(device, shape, kind):
    """Reduced sites (2 frames), the fast path's two tile heights, the
    layer3 site, and a ragged shape on the scalar path."""
    h, w, cin, stride = shape
    _, x, off, mask = _col2im_case(device, h, w, cin, stride, kind, 9)
    gen = torch.Generator(device=device).manual_seed(10)
    g = torch.randn(off.shape[0] * off.shape[1] * off.shape[2], cin,
                    device=device, generator=gen)
    for m in (mask, None):
        _check_wgrad(g, x, off, m, 3, 3, stride)


@pytest.mark.parametrize('shape,stride', [((96, 160, 128), 2),
                                          ((48, 80, 256), 2),
                                          ((24, 40, 512), 2)])
def test_deform_wgrad_kernel_training_sites(device, shape, stride):
    """The flagship's training sites at 8 frames (one per stage)."""
    h, w, cin = shape
    gen = torch.Generator(device=device).manual_seed(11)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.randn(8, h, w, cin, device=device, generator=gen)
    off = (torch.randn(8, ho, wo, 18, device=device, generator=gen)
           * 1.5).clamp(-2, 2)
    mask = torch.rand(8, ho, wo, 9, device=device, generator=gen)
    g = torch.randn(8 * ho * wo, cin, device=device, generator=gen)
    _check_wgrad(g, x, off, mask, 3, 3, stride)


# (H, W, Cin, Cout, stride, kh, kw, dilation): FCB's 3x5 and 5x3 v1 taps,
# dilation 2, Cin not a multiple of 32 (40, 6) and Cout not of 128 (5, 64)
WGRAD_SHAPES = [(24, 40, 64, 64, 1, 3, 5, 1), (24, 40, 64, 5, 1, 5, 3, 1),
                (24, 40, 64, 64, 1, 3, 3, 2), (13, 21, 40, 40, 1, 3, 3, 1),
                (19, 37, 6, 5, 2, 3, 3, 1), (2, 3, 36, 36, 2, 3, 3, 1)]


@pytest.mark.parametrize('shape', WGRAD_SHAPES)
def test_deform_wgrad_kernel_shapes(device, shape):
    h, w, cin, cout, stride, kh, kw, dilation = shape
    _, x, off, mask = _col2im_case(device, h, w, cin, stride, 'random', 12,
                                   kh, kw, dilation)
    gen = torch.Generator(device=device).manual_seed(13)
    g = torch.randn(off.shape[0] * off.shape[1] * off.shape[2], cout,
                    device=device, generator=gen)
    for m in (mask, None):
        _check_wgrad(g, x, off, m, kh, kw, stride, dilation)


@pytest.mark.parametrize('tm,split', [(128, 1), (128, 2), (128, 16),
                                      (256, 1), (256, 8)])
def test_deform_wgrad_kernel_any_plan(device, tm, split):
    """Every tile height and cluster size gives the same d_w within the
    tolerance, the plan's or not."""
    _, x, off, mask = _col2im_case(device, 24, 40, 256, 1, 'random', 14)
    gen = torch.Generator(device=device).manual_seed(15)
    g = torch.randn(2 * 24 * 40, 256, device=device, generator=gen)
    _check_wgrad(g, x, off, mask, 3, 3, 1, run=lambda: _wgrad_launch(
        g, x, off, mask, 3, 3, 1, tm, split))


def test_deform_wgrad_rejects_bad_inputs(device):
    x = torch.zeros(1, 4, 5, 32, device=device)
    off = torch.zeros(1, 4, 5, 18, device=device)
    g = torch.zeros(20, 8, device=device)
    with pytest.raises(ValueError):          # offset of a 3x5 conv
        KW.deform_wgrad_cuda(g, x, off, None, 3, 5)
    with pytest.raises(ValueError):          # g with the wrong site count
        KW.deform_wgrad_cuda(g[:19], x, off, None, 3, 3)
    with pytest.raises(ValueError):          # mask of another shape
        KW.deform_wgrad_cuda(g, x, off, torch.zeros(1, 4, 5, 8,
                                                    device=device), 3, 3)
    # the launcher refuses a 256-channel tile for Cout 8, a split past 16
    # and one that is not a power of two
    for tm, split in ((256, 1), (128, 17), (128, 3)):
        with pytest.raises(RuntimeError):
            _wgrad_launch(g, x, off, None, 3, 3, 1, tm, split)
    with pytest.raises(TypeError):
        KW.deform_wgrad_cuda(g.double(), x.double(), off.double(), None, 3,
                             3)
    with pytest.raises(ValueError):          # a CPU tensor among CUDA ones
        KW.deform_wgrad_cuda(g.cpu(), x, off, None, 3, 3)


def test_dcn_backward_launches_deform_wgrad_not_k2(device):
    """The window op's backward takes the weight gradient from deform_wgrad
    and launches K2 no more."""
    x = torch.randn(2, 24, 40, 64, device=device, requires_grad=True)
    off = torch.zeros(2, 24, 40, 18, device=device, requires_grad=True)
    wt = torch.randn(64, 3, 3, 64, device=device, requires_grad=True)
    mask = torch.rand(2, 24, 40, 9, device=device, requires_grad=True)
    wgrad, gather = KW.KERNEL.launches, K2.KERNEL.launches
    deform_conv_window(x, off, wt, mask, None).sum().backward()
    assert KW.KERNEL.launches == wgrad + 1
    assert K2.KERNEL.launches == gather
    assert wt.grad is not None and wt.grad.is_contiguous()


def _shares_off_plain(got, rounded, want):
    """Shares of the values of ``got`` (the fp32-offset entry) and of
    ``rounded`` (the bf16 entry at the offsets rounded to bf16) that differ
    from ``want``, the plain version at the fp32 offsets."""
    return tuple(float((t != want).float().mean()) for t in (got, rounded))


@pytest.mark.parametrize('site', FCB_SITES)
def test_fcb_fp32_offsets_are_not_rounded(device, site):
    """The fp32-offset entry samples at the offsets as given, which the
    tolerance alone cannot show: offsets of a few pixels rounded to bf16
    move the output by less than _bf16_atol.  So the values that differ
    from the plain version are counted.  The entry may differ in 1% of
    them, where the fp32 sums in another order round the other way; the
    control, the bf16 entry fed the offsets rounded to bf16, differs in
    more than 10% (~75% on the CPU's plain version at these inputs)."""
    h, w, kh, kw = site
    x, off, _, wt, _ = _dcn_case(device, h, w, 256, 256, kh, kw, 1, 1, 21)
    xb, wb = x.bfloat16(), wt.bfloat16()
    got = KD.deform_conv_cuda(xb, off, wb, None, None)
    rounded = KD.deform_conv_cuda(xb, off.bfloat16(), wb, None, None)
    want = KD.deform_conv_reference(xb, off, wb, None, None)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=_bf16_atol(want), rtol=0)
    share, control = _shares_off_plain(got, rounded, want)
    assert not torch.equal(got, rounded)
    assert share <= 0.01 and control > 0.1, (share, control)


@pytest.mark.parametrize('site', FCB_SITES)
def test_fcb_sites_backward_kernels(device, site):
    """K4 (radius 2, v1) and deform_wgrad (Cout 256) at one FCB site with
    8 frames, as a training step of 4 clips runs them: K4's d_offset and
    deform_wgrad's d_w bit for bit over two launches."""
    h, w, kh, kw = site
    x, off, _, _, _ = _dcn_case(device, h, w, 256, 256, kh, kw, 1, 1, 22,
                                frames=8)
    off = off.clamp(-2, 2)
    gen = torch.Generator(device=device).manual_seed(23)
    g = torch.randn(8 * h * w, 256, device=device, generator=gen)
    dcols = torch.randn(8 * h * w, kh * kw * 256, device=device,
                        generator=gen)
    _check_col2im(dcols, x, off, None, kh, kw, 1)
    _check_wgrad(g, x, off, None, kh, kw, 1)


def test_kernel_output_under_grad_raises(device):
    """No kernel output silently drops a gradient (ROADMAP C.6): with
    autograd recording, the fused conv refuses any input that requires
    one; the window op differentiates, and the training forward at radius 0
    takes the exact op, whose backward reaches FCB's offset predictor."""
    x, off, _, wt, bias = _dcn_case(device, 6, 10, 256, 256, 3, 5, 1, 1, 24)
    for i in range(4):
        args = [x, off, wt, bias]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match='gradient'):
            KD.deform_conv_cuda(args[0], args[1], args[2], None, args[3])
        with torch.no_grad():
            KD.deform_conv_cuda(args[0], args[1], args[2], None, args[3])
    xg = x.clone().requires_grad_(True)
    deform_conv_window(xg, off, wt, None, None, radius=2).sum().backward()
    assert float(xg.grad.abs().max()) > 0

    from stmask_torch.config import get_config
    from stmask_torch.models import build_model
    cfg = get_config('STMask_plus_resnet50_ada').replace(
        img_h=96, img_w=128, fcb_window_radius=0)
    model = build_model(cfg, device, seed=0)
    clip = torch.randn(1, 2, cfg.pad_h, cfg.pad_w, 3, device=device)
    out = model(clip, train=True)
    (out['loc'].square().sum() + out['conf'].square().sum()).backward()
    grad = model.prediction_layers[0].conf_layer[0].conv_offset.weight.grad
    assert grad is not None and bool(torch.isfinite(grad).all())
    assert float(grad.abs().max()) > 0


# K5's shapes (H, W, Cin, stride, kh, kw, dilation): ragged Cin (one
# channel a lane), 1-pixel dimensions, stride 2, FCB's 3x5 / 5x3 taps,
# dilation 2, and DCN / FCB sites
EXACT_SHAPES = [(9, 11, 6, 1, 3, 3, 1), (9, 11, 8, 2, 3, 3, 1),
                (1, 7, 8, 1, 3, 3, 1), (6, 1, 8, 1, 3, 3, 1),
                (1, 1, 4, 1, 3, 3, 1), (24, 40, 64, 1, 3, 5, 1),
                (12, 20, 256, 1, 5, 3, 1), (13, 7, 64, 1, 3, 3, 2),
                (48, 80, 128, 1, 3, 3, 1), (24, 40, 512, 2, 3, 3, 1)]


@pytest.mark.parametrize('entry', ['fp32', 'bf16', 'bf16_f32off'])
@pytest.mark.parametrize('kind', ['zero', 'edge', 'normal6'])
@pytest.mark.parametrize('shape', EXACT_SHAPES)
def test_deform_exact_bwd_kernel(device, shape, kind, entry):
    """K5 against its plain version (chip_smoke.py phase 15a's check), with
    and without the mask, on the route its wrapper takes (the fast one
    where H, W >= 2 and Cin is a multiple of 4 in fp32, of 8 in bf16) and
    on the general route."""
    h, w, cin, stride, kh, kw, dil = shape
    args = _exact_inputs(torch, device, h, w, cin, stride, 2, kind, 5, kh,
                         kw, dil)
    fast = min(h, w) >= 2 and cin % (4 if entry == 'fp32' else 8) == 0
    for masked in (True, False):
        a = args if masked else args[:3] + (None,)
        _, route = _exact_check(torch, _exact_typed(torch, a, entry), kh,
                                kw, stride, dil)
        assert route == ('fast' if fast else 'general'), (shape, entry)


# K5's fast route (H, W, Cin, stride, kh, kw, kinds): the maps hold twice
# a footprint, so that 'away' can move every block past its tile's
# footprint; Cin 256 at 12 x 20 splits the channels
EXACT_FAST = [(48, 80, 64, 1, 3, 3, ('zero', 'away', 'random')),
              (80, 96, 32, 2, 3, 3, ('zero', 'away', 'random')),
              (48, 80, 64, 1, 3, 5, ('zero', 'away', 'random')),
              (48, 80, 64, 1, 5, 3, ('zero', 'away', 'random')),
              (12, 20, 256, 1, 3, 3, ('zero', 'random'))]


def _exact_away(args, kh, kw, stride, plan):
    """``args`` with every sample moved a footprint and 0.3 of a pixel away
    from its grid position, down (right) in the map's first half, up (left)
    in its second, so that no block lies in its tile's footprint."""
    dcols, x, off, mask = args
    _, h, w, _ = x.shape
    _, ho, wo, _ = off.shape
    dev = off.device
    oy = torch.arange(ho, device=dev) * stride - (kh - 1) // 2
    ox = torch.arange(wo, device=dev) * stride - (kw - 1) // 2
    by = (oy[:, None, None, None] + torch.arange(kh, device=dev)[
        None, None, :, None]).expand(ho, wo, kh, kw).reshape(ho, wo, -1)
    bx = (ox[None, :, None, None] + torch.arange(kw, device=dev)[
        None, None, None, :]).expand(ho, wo, kh, kw).reshape(ho, wo, -1)
    dy = torch.where(by < h // 2, plan.fh + 0.3, -plan.fh - 0.3)
    dxo = torch.where(bx < w // 2, plan.fw + 0.3, -plan.fw - 0.3)
    away = torch.stack([dy, dxo], -1).reshape(1, ho, wo, -1).expand_as(off)
    return dcols, x, away.contiguous().float(), mask


@pytest.mark.parametrize('entry', ['fp32', 'bf16', 'bf16_f32off'])
@pytest.mark.parametrize('case', [(s[:6], kind) for s in EXACT_FAST
                                  for kind in s[6]], ids=str)
def test_deform_exact_bwd_fast_route(device, case, entry):
    """K5's fast route (asserted) against the plain version and against
    the general route (_exact_check), with and without the mask, at offsets
    that keep every block inside its tile's footprint (zero), move every
    one past it (away: all overflow items), and N(0, 1.5) (mixed); the
    share of overflow items asserted from exact_bwd_inside."""
    from stmask_torch.kernels import deform_exact_bwd as K5
    (h, w, cin, stride, kh, kw), kind = case
    args = _exact_inputs(torch, device, h, w, cin, stride, 2,
                         'zero' if kind == 'away' else kind, 7, kh, kw)
    ho, wo = args[2].shape[1:3]
    plan = K5.exact_bwd_plan(2, ho, wo, cin, kh, kw, stride, 1, 4)
    if kind == 'away':
        assert 2 * plan.fh + 2 <= h and 2 * plan.fw + 2 <= w
        args = _exact_away(args, kh, kw, stride, plan)
    inside = K5.exact_bwd_inside(args[2], h, w, kh, kw, stride, 1, plan)
    share = 1.0 - float(inside.float().mean())
    if kind == 'zero':
        assert share == 0.0
    elif kind == 'away':
        assert share == 1.0
    else:
        assert 0.0 < share < 0.2
    for masked in (True, False):
        a = args if masked else args[:3] + (None,)
        _, route = _exact_check(torch, _exact_typed(torch, a, entry), kh,
                                kw, stride)
        assert route == 'fast'


@pytest.mark.parametrize('entry', ['fp32', 'bf16'])
def test_deform_exact_bwd_unaligned(device, entry):
    """x one element into its buffer: the general route, one channel a
    lane, against the plain version."""
    args = list(_exact_typed(torch, _exact_inputs(
        torch, device, 12, 20, 64, 1, 2, 'normal6', 6), entry))
    x = args[1]
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
    buf[1:] = x.reshape(-1)
    args[1] = buf[1:].view(x.shape)
    _, route = _exact_check(torch, tuple(args), 3, 3, 1)
    assert route == 'general'


def test_deform_exact_bwd_rejects_bad_inputs(device):
    from stmask_torch.kernels import deform_exact_bwd as K5
    dcols, x, off, mask = _exact_inputs(torch, device, 6, 7, 8, 1, 1,
                                        'zero', 0)
    with pytest.raises(ValueError, match='dcols'):
        K5.deform_exact_bwd_cuda(dcols[:-1], x, off, mask, 3, 3)
    with pytest.raises(ValueError, match='mask'):
        K5.deform_exact_bwd_cuda(dcols, x, off, mask[..., :4].contiguous(),
                                 3, 3)
    with pytest.raises(TypeError, match='offsets'):
        K5.deform_exact_bwd_cuda(dcols, x, off.bfloat16(), mask, 3, 3)
    with pytest.raises(ValueError, match='CUDA'):
        K5.deform_exact_bwd_cuda(dcols.cpu(), x, off, mask, 3, 3)


@pytest.mark.parametrize('stride', [1, 2])
def test_deform_conv_exact_matches_cpu(device, stride):
    """The exact op (fused forward, deform_wgrad, a matmul and K5) on the
    card against its CPU plain path, at N(0, 3) offsets with samples on
    integer rows and columns: five gradients."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 24, 40, 64, generator=g)
    ho, wo = (24 - 1) // stride + 1, (40 - 1) // stride + 1
    off = torch.randn(2, ho, wo, 18, generator=g) * 3.0
    off[0, :2] = torch.randint(-3, 4, (2, wo, 18), generator=g).float()
    mask = torch.rand(2, ho, wo, 9, generator=g)
    wt = torch.randn(64, 3, 3, 64, generator=g) / 24
    bias = torch.randn(64, generator=g)
    cot = torch.randn(2, ho, wo, 64, generator=g)
    grads = []
    for dev in ('cpu', device):
        ts = [t.detach().to(dev).requires_grad_(True)
              for t in (x, off, wt, mask, bias)]
        (deform_conv_exact(*ts, stride=stride) * cot.to(dev)).sum(
            ).backward()
        grads.append([t.grad.cpu() for t in ts])
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, atol=2e-4 * max(
            float(b.abs().max()), 1.0), rtol=0)


@pytest.mark.parametrize('shape', GREEDY_SHAPES)
def test_greedy_nms_kernel(device, shape):
    """Bit for bit the plain version, and the same over two launches."""
    from stmask_torch.kernels import greedy_nms as KG
    g, k = shape
    iou, valid = _greedy_inputs(torch, device, g, k, seed=g + k)
    n0 = KG.KERNEL.launches
    got = KG.greedy_nms_cuda(iou, valid, 0.5)
    again = KG.greedy_nms_cuda(iou, valid, 0.5)
    want = KG.greedy_nms_mask_reference(iou, valid, 0.5)
    torch.cuda.synchronize()
    assert KG.KERNEL.launches == n0 + 2
    assert torch.equal(got, want) and torch.equal(got, again)
    assert not got[0].any()
    if k > 2 and g > 1:                 # the chain keeps 0, 2, 4, ...
        chain_valid = valid[1]
        assert got[1].sum() < chain_valid.sum()


@pytest.mark.parametrize('layout', ['rows', 'transposed'])
def test_greedy_nms_per_class_takes_the_kernel(device, layout):
    """One launch of the boxes entry for all the classes of a frame (the
    matrix entry none), equal to the CPU; also with the scores a
    transposed view, as detect_frame hands them over (its top-k slices
    come out strided)."""
    from stmask_torch.kernels import greedy_nms as KG
    from stmask_torch.ops.nms import greedy_nms_per_class
    gen = torch.Generator().manual_seed(3)
    lo = torch.rand(2000, 2, generator=gen) * 0.7
    boxes = torch.cat([lo, lo + 0.05 + torch.rand(2000, 2, generator=gen)
                       * 0.25], dim=-1)
    scores = torch.rand(40, 2000, generator=gen) ** 4
    on_card = scores.to(device)
    if layout == 'transposed':
        on_card = on_card.t().contiguous().t()
    n0 = KG.KERNEL_BOXES.launches, KG.KERNEL.launches
    got = greedy_nms_per_class(boxes.to(device), on_card)
    assert (KG.KERNEL_BOXES.launches, KG.KERNEL.launches) == (n0[0] + 1,
                                                              n0[1])
    want = greedy_nms_per_class(boxes, scores)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize('shape', GREEDY_SHAPES)
def test_greedy_nms_boxes_kernel(device, shape):
    """The boxes entry bit for bit the plain version, and the same over two
    launches, on phase 10a's boxes (normalized here and scaled by 640 in
    the kernel)."""
    from stmask_torch.kernels import greedy_nms as KG
    g, k = shape
    boxes, valid = _greedy_boxes(torch, device, g, k, seed=g + k)
    args = (boxes.reshape(-1, 4) / 640.0,
            torch.arange(g * k, device=device).reshape(g, k), valid, 640.0,
            0.5)
    n0 = KG.KERNEL_BOXES.launches
    got = KG.greedy_nms_boxes_cuda(*args)
    again = KG.greedy_nms_boxes_cuda(*args)
    want = KG.greedy_nms_plus_one_reference(*args)
    torch.cuda.synchronize()
    assert KG.KERNEL_BOXES.launches == n0 + 2
    assert torch.equal(got, want) and torch.equal(got, again)
    assert not got[0].any()
    # the matrix entry over the plain IoUs of the same scaled boxes agrees
    iou = KG.plus_one_iou(args[0][args[1]] * 640.0).contiguous()
    assert torch.equal(got, KG.greedy_nms_cuda(iou, valid, 0.5))


@pytest.mark.parametrize('kind', ['near', 'degenerate'])
@pytest.mark.parametrize('g,k', [(40, 200), (320, 200), (7, 1024),
                                 (40, 65)])
def test_greedy_nms_boxes_kernel_exact_cases(device, kind, g, k):
    """Boxes with many IoUs within a few ulps of 0.5 (a contracted FMA or
    another order of operations flips verdicts there), and degenerate
    boxes: bit for bit the plain version, through a reversed index."""
    from stmask_torch.kernels import greedy_nms as KG
    make = _near_threshold_boxes if kind == 'near' else _degenerate_boxes
    flat, idx, valid, scale, thr = _boxes_args(torch, device,
                                               *make(g, k, seed=g + k))
    got = KG.greedy_nms_boxes_cuda(flat, idx, valid, scale, thr)
    want = KG.greedy_nms_plus_one_reference(flat.cpu(), idx.cpu(),
                                            valid.cpu(), scale, thr)
    assert torch.equal(got.cpu(), want)
    if kind == 'near':
        iou = KG.plus_one_iou(flat[idx].cpu())
        near = ((iou - 0.5).abs() <= 4 * 2.0 ** -24).triu(1)
        assert int(near.sum()) > g * k // 20


def test_greedy_nms_boxes_rejects_bad_inputs(device):
    from stmask_torch.kernels import greedy_nms as KG
    boxes = torch.rand(10, 4, device=device)
    idx = torch.zeros(2, 5, dtype=torch.int64, device=device)
    valid = torch.ones(2, 5, dtype=torch.bool, device=device)
    with pytest.raises(TypeError):
        KG.greedy_nms_boxes_cuda(boxes, idx.int(), valid, 1.0, 0.5)
    with pytest.raises(ValueError):
        KG.greedy_nms_boxes_cuda(boxes[:, :3].contiguous(), idx, valid, 1.0,
                                 0.5)
    with pytest.raises(ValueError):
        KG.greedy_nms_boxes_cuda(boxes, idx, valid[:, :4], 1.0, 0.5)
    with pytest.raises(ValueError):
        KG.greedy_nms_boxes_cuda(
            boxes, torch.zeros(2, 1025, dtype=torch.int64, device=device),
            torch.ones(2, 1025, dtype=torch.bool, device=device), 1.0, 0.5)


def test_greedy_nms_rejects_bad_inputs(device):
    from stmask_torch.kernels import greedy_nms as KG
    iou = torch.zeros(2, 1025, 1025, device=device)
    with pytest.raises(ValueError):
        KG.greedy_nms_cuda(iou, torch.ones(2, 1025, dtype=torch.bool,
                                           device=device), 0.5)
    with pytest.raises(TypeError):
        KG.greedy_nms_cuda(torch.zeros(2, 5, 5, device=device),
                           torch.ones(2, 5, device=device), 0.5)
    with pytest.raises(ValueError):
        KG.greedy_nms_cuda(torch.zeros(2, 5, 4, device=device),
                           torch.ones(2, 5, dtype=torch.bool, device=device),
                           0.5)


# ---- the kernels on the paths of the other presets ------------------------

@pytest.mark.parametrize('name', ['STMask_resnet50_gn', 'STMask_darknet53'])
def test_correlation_kernels_at_preset_p4(device, name):
    """K1 and K3 at the FPN level the preset correlates (P4 of 384x640, 256
    channels): one frame for the eval step's K1, 4 clips for the training
    step's K1 and K3."""
    from stmask_torch.config import get_config
    cfg = get_config(name)
    h, w = cfg.feature_shapes()[cfg.correlation_selected_layer]
    for b in (1, 4):
        shape = (b, h, w, cfg.fpn.num_features)
        g = torch.Generator(device=device).manual_seed(b)
        x1 = torch.randn(shape, device=device, generator=g)
        x2 = torch.randn(shape, device=device, generator=g)
        p = cfg.correlation_patch_size
        n0 = K1.KERNEL.launches
        got = K1.correlate_cuda(x1, x2, p)
        assert K1.KERNEL.launches == n0 + 1
        want = K1.correlate_reference(x1, x2, p)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        up = torch.randn_like(want)
        n0 = K3.KERNEL.launches
        got = K3.correlation_bwd_cuda(up, x1, x2, p, out=want)
        assert K3.KERNEL.launches == n0 + 1
        for a, b_ in zip(got, K3.correlation_bwd_reference(up, x1, x2, p,
                                                           out=want)):
            torch.testing.assert_close(a, b_, atol=1e-5, rtol=1e-5)


def test_fused_deform_conv_at_r101_sites(device):
    """The fused conv at every DCN site of ``STMask_plus_base`` (R101,
    dcn_layers (0, 4, 23, 3) at interval 3: 2 sites in layer2, 8 in layer3,
    1 in layer4), the sites' inputs read off the model's own forward at
    384x640, each against its plain version at FUSED_ATOL."""
    from stmask_torch.config import get_config
    from stmask_torch.models import build_model
    from stmask_torch.models.backbone import DCNConv
    cfg = get_config('STMask_plus_base')
    model = build_model(cfg, device, seed=0)
    sites = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: sites.append((tuple(a[0].shape), m.stride)))
        for m in model.modules() if isinstance(m, DCNConv)]
    x = torch.zeros(1, cfg.pad_h, cfg.pad_w, 3, device=device)
    n0 = KD.KERNEL.launches
    with torch.inference_mode():
        model(x)
    for h_ in hooks:
        h_.remove()
    assert KD.KERNEL.launches == n0 + 11 and len(sites) == 11
    assert [s for _, s in sites] == [2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 2]
    del model
    for (_, cin, h, w), stride in sorted(set(sites)):
        x, off, mask, wt, bias = _dcn_case(device, h, w, cin, cin, 3, 3,
                                           stride, 1, 3)
        got = KD.deform_conv_cuda(x, off, wt, mask, bias, stride, 1)
        want = KD.deform_conv_reference(x, off, wt, mask, bias, stride, 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=FUSED_ATOL, rtol=0)


# ---- the stmask:: custom ops (the binding torch.export traces) ------------

def _op_cases(device):
    """(op, args, the direct wrapper, its CudaKernel) of every entry."""
    from stmask_torch.kernels import greedy_nms as KG
    g = torch.Generator(device=device).manual_seed(31)
    x1 = torch.randn(1, 24, 40, 256, device=device, generator=g)
    x2 = torch.randn(1, 24, 40, 256, device=device, generator=g)
    # offsets and mask as channel slices of one tensor, read in place
    x, _, _, wt, bias = _dcn_case(device, 24, 40, 256, 256, 3, 3, 1, 1, 32)
    om = torch.randn(1, 24, 40, 27, device=device, generator=g)
    om = torch.cat([om[..., :18] * 2.0, torch.sigmoid(om[..., 18:])], -1)
    off, mask = om[..., :18], om[..., 18:]
    iou, valid = _greedy_inputs(torch, device, 40, 200, seed=33)
    boxes, _ = _greedy_boxes(torch, device, 40, 200, seed=33)
    bf = torch.bfloat16
    dcn = torch.ops.stmask.deform_conv
    return [
        (torch.ops.stmask.correlate, (x1, x2, 11, True), K1.correlate_cuda,
         K1.KERNEL),
        (torch.ops.stmask.correlate, (x1.to(bf), x2.to(bf), 11, True),
         K1.correlate_cuda, K1.KERNEL_BF16),
        (dcn, (x, off, wt, mask, bias, 1, 1), KD.deform_conv_cuda,
         KD.KERNEL),
        (dcn, (x.to(bf), off.to(bf), wt.to(bf), mask.to(bf), bias.to(bf), 1,
               1), KD.deform_conv_cuda, KD.KERNEL_BF16),
        (dcn, (x.to(bf), off, wt.to(bf), None, None, 1, 1),
         KD.deform_conv_cuda, KD.KERNEL_BF16_F32OFF),
        (torch.ops.stmask.greedy_nms_keep, (iou, valid, 0.5),
         KG.greedy_nms_cuda, KG.KERNEL),
        (torch.ops.stmask.greedy_nms_plus_one_keep,
         (boxes.reshape(-1, 4), torch.arange(8000, device=device).reshape(
             40, 200).flip(1), valid, 1.0, 0.5),
         KG.greedy_nms_boxes_cuda, KG.KERNEL_BOXES)]


def test_custom_ops_are_the_kernels(device):
    """On CUDA tensors each op is its hand-written kernel: one launch a
    call, bit for bit the direct call (offset and mask read in place as
    channel slices)."""
    for op, args, direct, kernel in _op_cases(device):
        n0 = kernel.launches
        got = op(*args)
        assert kernel.launches == n0 + 1, kernel.symbol
        want = direct(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), kernel.symbol


def test_custom_ops_opcheck_on_the_card(device):
    """``torch.library.opcheck`` of every entry on CUDA tensors: the fake
    implementation's shape and dtype, no hidden mutation."""
    for op, args, _, kernel in _op_cases(device):
        torch.library.opcheck(op.default, args)


def test_exported_step_on_the_card(device, tmp_path):
    """The reduced flagship's fp32 video step exported on the card, saved
    and loaded: equal to the live step over three frames (ids and kept
    slots equal, box / score / mask within 1e-5), with the fused conv at
    each DCN site and K1 once a frame; the weights on the card."""
    import dataclasses

    import numpy as np

    from stmask_torch.config import get_config
    from stmask_torch.export import (export_video_step, load_exported,
                                     save_exported)
    from stmask_torch.inference import build_video_step
    from stmask_torch.kernels import KERNELS
    from stmask_torch.models import build_model

    cfg = get_config('STMask_plus_resnet50')
    cfg = cfg.replace(img_h=96, img_w=128, track_capacity=16,
                      backbone=dataclasses.replace(cfg.backbone,
                                                   layers=(1, 3, 3, 1)))
    exported, meta = export_video_step(cfg, build_model(cfg, device, 0),
                                       device=device)
    save_exported(exported, meta, str(tmp_path / 'a.stmask'))
    step, _ = load_exported(str(tmp_path / 'a.stmask'))
    assert {t.device for t in step._fn.state_dict().values()} == {
        torch.device('cuda', 0)}
    live, init = build_video_step(cfg, build_model(cfg, device, 0),
                                  uint8_input=True, device=device)
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (3, 96, 128, 3), dtype=np.uint8)
    sa, sl = step.init_state(), init()
    for k, fr in enumerate(frames):
        for kk in KERNELS.values():
            kk.launches = 0
        sa, got = step(sa, fr, k == 0)
        torch.cuda.synchronize()
        launches = {n: kk.launches for n, kk in KERNELS.items()}
        sl, want = live(sl, fr, k == 0)
        assert launches['deform_conv'] == 5 and launches['correlation'] == 1
        assert sum(launches.values()) == 6, launches
        for f in ('keep', 'obj_id'):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        for f in ('box', 'score', 'mask'):
            torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                       rtol=0, atol=1e-5)



@pytest.mark.parametrize('act', [True, False])
@pytest.mark.parametrize('shape,patch', CORR_BWD_SHAPES)
def test_correlation_bwd_kernel_bf16(device, shape, patch, act):
    """K3's bf16 entry (bf16 x1 and x2, fp32 g and out as K1's bf16 entry
    writes them): bf16 dx1 and dx2, one launch a call, no atomics."""
    up, x1, x2, out = _corr_bwd_case(device, shape, patch)
    x1, x2 = x1.bfloat16(), x2.bfloat16()
    out = out if act else None
    launches = K3.KERNEL_BF16.launches
    got = K3.correlation_bwd_cuda(up, x1, x2, patch, out=out)
    assert K3.KERNEL_BF16.launches == launches + 1
    again = K3.correlation_bwd_cuda(up, x1, x2, patch, out=out)
    want = K3.correlation_bwd_reference(up, x1, x2, patch, out=out)
    torch.cuda.synchronize()
    for a, a2, b in zip(got, again, want):
        assert b.dtype == torch.bfloat16
        _bf16_err(a, a2, b)


# CORR_BWD_SHAPES where K3's bf16 fast route applies (C % 8 == 0)
CORR_BWD_FAST = [(s, p) for s, p in CORR_BWD_SHAPES if s[-1] % 8 == 0]


@pytest.mark.parametrize('slice_g', [False, True], ids=['g', 'g_slice'])
@pytest.mark.parametrize('act', [True, False])
@pytest.mark.parametrize('shape,patch', CORR_BWD_FAST)
def test_correlation_bwd_bf16_fast_route_is_the_general_route(
        device, shape, patch, act, slice_g):
    """K3 bf16's fast route (C % 8 == 0, every map 16-byte aligned) gives
    the general route's dx1 and dx2 bit for bit, with and without the
    forward's output and with g a channel slice of a wider gradient (pixel
    stride above P^2, as torch.cat's backward hands it over); the same
    bits on a second launch; one launch a call."""
    up, x1, x2, out = _corr_bwd_case(device, shape, patch, seed=11)
    x1, x2 = x1.bfloat16(), x2.bfloat16()
    out = out if act else None
    if slice_g:
        wide = torch.randn(shape[:3] + (patch * patch + 7,), device=device)
        wide[..., 3:3 + patch * patch] = up
        up = wide[..., 3:3 + patch * patch]
        assert K3.pixel_stride(up) == patch * patch + 7
    launches = K3.KERNEL_BF16.launches
    fast = K3.correlation_bwd_cuda(up, x1, x2, patch, out=out)
    assert K3.KERNEL_BF16.launches == launches + 1
    assert K3.corr_bwd_fast(shape[-1], x1.data_ptr(), x2.data_ptr(),
                            *(d.data_ptr() for d in fast))
    again = K3.correlation_bwd_cuda(up, x1, x2, patch, out=out)
    with _general_route(K3, 'corr_bwd_fast'):
        general = K3.correlation_bwd_cuda(up, x1, x2, patch, out=out)
    want = K3.correlation_bwd_reference(up, x1, x2, patch, out=out)
    torch.cuda.synchronize()
    for a, a2, gen, b in zip(fast, again, general, want):
        assert torch.equal(a, gen)
        assert torch.equal(a, a2)
        _bf16_err(a, a2, b)


@pytest.mark.parametrize('case', ['c12', 'c40_x1_unaligned',
                                  'c256_maps_unaligned'])
def test_correlation_bwd_bf16_off_route(device, case):
    """A call the fast route cannot take (C % 8 != 0, or a map one element
    into its buffer) goes to the general route, which agrees with the
    plain version; the bf16 entry refuses a fast call for it."""
    shape = {'c12': (1, 6, 5, 12), 'c40_x1_unaligned': (1, 5, 7, 40),
             'c256_maps_unaligned': (2, 6, 9, 256)}[case]
    up, x1, x2, out = _corr_bwd_case(device, shape, 5, seed=12)
    n = x1.numel()
    buf = torch.empty(2 * n + 2, device=device, dtype=torch.bfloat16)
    lead = 1 if case.endswith('unaligned') else 0
    x1b = buf[lead:lead + n].view(shape)
    x2b = buf[n + lead:2 * n + lead].view(shape)
    if case == 'c40_x1_unaligned':
        x2b = x2.bfloat16()
    x1b.copy_(x1)
    x2b.copy_(x2)
    dx = torch.empty(shape, device=device, dtype=torch.bfloat16)
    assert not K3.corr_bwd_fast(shape[-1], x1b.data_ptr(), x2b.data_ptr(),
                                dx.data_ptr(), dx.data_ptr())
    launches = K3.KERNEL_BF16.launches
    got = K3.correlation_bwd_cuda(up, x1b, x2b, 5, out=out)
    again = K3.correlation_bwd_cuda(up, x1b, x2b, 5, out=out)
    assert K3.KERNEL_BF16.launches == launches + 2
    want = K3.correlation_bwd_reference(up, x1b, x2b, 5, out=out)
    torch.cuda.synchronize()
    for a, a2, b in zip(got, again, want):
        _bf16_err(a, a2, b)
    stream = torch.cuda.current_stream().cuda_stream
    with pytest.raises(RuntimeError, match='CUDA error'):
        K3.KERNEL_BF16(up.data_ptr(), out.data_ptr(), x1b.data_ptr(),
                       x2b.data_ptr(), dx.data_ptr(), dx.data_ptr(), 25,
                       *shape, 5, 1, stream)
    assert K3.KERNEL_BF16.launches == launches + 2


def _bf16_case(x, off, mask, off_dtype):
    return (x.bfloat16(), off.to(off_dtype),
            None if mask is None else mask.bfloat16())


@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(9, 11, 6, 1, 3, 3, 1),
                                   (24, 40, 256, 1, 3, 3, 1),
                                   (24, 40, 512, 2, 3, 3, 1)]
                         + COL2IM_SHAPES[:5])
def test_deform_col2im_kernel_bf16(device, shape, off_dtype):
    """K4's bf16 entries (bf16 offsets, and fp32 ones beside bf16 data):
    dx and d_mask bf16, d_offset in the offsets' type; d_offset and d_mask
    bit for bit over two launches (dx sums with atomics before it is
    rounded)."""
    h, w, cin, stride, kh, kw, dilation = shape
    dcols, x, off, mask = _col2im_case(device, h, w, cin, stride, 'random',
                                       16, kh, kw, dilation)
    kern = (K4.KERNEL_BF16 if off_dtype == torch.bfloat16
            else K4.KERNEL_BF16_F32OFF)
    for m in (mask, None):
        xb, ob, mb = _bf16_case(x, off, m, off_dtype)
        db = dcols.bfloat16()
        launches = kern.launches
        got = K4.deform_col2im_cuda(db, xb, ob, mb, kh, kw, stride, dilation)
        assert kern.launches == launches + 1
        again = K4.deform_col2im_cuda(db, xb, ob, mb, kh, kw, stride,
                                      dilation)
        want = K4.deform_col2im_reference(db, xb, ob, mb, kh, kw, stride,
                                          dilation)
        torch.cuda.synchronize()
        assert want[1].dtype == off_dtype
        _bf16_err(got[0], again[0], want[0], same=False)
        _bf16_err(got[1], again[1], want[1])
        assert (got[2] is None) == (m is None)
        if m is not None:
            _bf16_err(got[2], again[2], want[2])


@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(9, 11, 32, 32, 1, 3, 3, 1),
                                   (24, 40, 256, 256, 2, 3, 3, 1),
                                   (12, 20, 512, 512, 1, 3, 3, 1)]
                         + WGRAD_SHAPES)
def test_deform_wgrad_kernel_bf16(device, shape, off_dtype):
    """deform_wgrad's bf16 entries: the bf16 forward's columns, d_w in
    bf16, bit for bit over two launches."""
    h, w, cin, cout, stride, kh, kw, dilation = shape
    _, x, off, mask = _col2im_case(device, h, w, cin, stride, 'random', 17,
                                   kh, kw, dilation)
    gen = torch.Generator(device=device).manual_seed(18)
    g = torch.randn(off.shape[0] * off.shape[1] * off.shape[2], cout,
                    device=device, generator=gen).bfloat16()
    kern = (KW.KERNEL_BF16 if off_dtype == torch.bfloat16
            else KW.KERNEL_BF16_F32OFF)
    for m in (mask, None):
        xb, ob, mb = _bf16_case(x, off, m, off_dtype)
        launches = kern.launches
        got = KW.deform_wgrad_cuda(g, xb, ob, mb, kh, kw, stride, dilation)
        assert kern.launches == launches + 1
        again = KW.deform_wgrad_cuda(g, xb, ob, mb, kh, kw, stride,
                                     dilation)
        want = KW.deform_wgrad_reference(g, xb, ob, mb, kh, kw, stride,
                                         dilation)
        torch.cuda.synchronize()
        _bf16_err(got, again, want)


# the bf16 fast path (Cin a multiple of 32, Cout of 128, x and g aligned):
# the flagship's 7 training sites at 8 frames (H, W, Cin, stride; layer2_2
# and layer2_4 share a shape), FCB's taps at 24x40 and at 3x5, its smallest
# map (Cin = Cout = 256)
WGRAD_BF16_SITES = [(96, 160, 128, 2), (48, 80, 128, 1), (48, 80, 256, 2),
                    (24, 40, 256, 1), (24, 40, 512, 2), (12, 20, 512, 1)]
FCB_TAPS = [(3, 3), (3, 5), (5, 3)]


def _wgrad_bf16_case(device, x, off, mask, kh, kw, stride, cout, off_dtype,
                     seed, dilation=1, route='fast'):
    """deform_wgrad's bf16 entry for ``off_dtype`` with and without the
    mask: the route ``wgrad_fast`` gives, one launch a call, _bf16_err
    against the plain version (bit for bit over two launches)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn(off.shape[0] * off.shape[1] * off.shape[2], cout,
                    device=device, generator=gen).bfloat16()
    kern = (KW.KERNEL_BF16 if off_dtype == torch.bfloat16
            else KW.KERNEL_BF16_F32OFF)
    for m in (mask, None):
        xb, ob, mb = _bf16_case(x, off, m, off_dtype)
        fast = KW.wgrad_fast(xb.shape[3], cout, xb.data_ptr(), g.data_ptr())
        assert fast == (route == 'fast')
        launches = kern.launches
        got = KW.deform_wgrad_cuda(g, xb, ob, mb, kh, kw, stride, dilation)
        assert kern.launches == launches + 1
        again = KW.deform_wgrad_cuda(g, xb, ob, mb, kh, kw, stride,
                                     dilation)
        want = KW.deform_wgrad_reference(g, xb, ob, mb, kh, kw, stride,
                                         dilation)
        torch.cuda.synchronize()
        _bf16_err(got, again, want)


@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', WGRAD_BF16_SITES)
def test_deform_wgrad_bf16_fast_training_sites(device, shape, off_dtype):
    h, w, cin, stride = shape
    gen = torch.Generator(device=device).manual_seed(30)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = torch.randn(8, h, w, cin, device=device, generator=gen)
    off = (torch.randn(8, ho, wo, 18, device=device, generator=gen)
           * 1.5).clamp(-2, 2)
    mask = torch.rand(8, ho, wo, 9, device=device, generator=gen)
    _wgrad_bf16_case(device, x, off, mask, 3, 3, stride, cin, off_dtype, 31)


@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('hw', [(24, 40), (3, 5)])
@pytest.mark.parametrize('taps', FCB_TAPS)
def test_deform_wgrad_bf16_fast_fcb_sites(device, taps, hw, off_dtype):
    kh, kw = taps
    _, x, off, mask = _col2im_case(device, *hw, 256, 1, 'random', 32, kh, kw)
    _wgrad_bf16_case(device, x, off, mask, kh, kw, 1, 256, off_dtype, 33)


@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('kind', ['zero', 'integer'])
def test_deform_wgrad_bf16_fast_exact_offsets(device, kind, off_dtype):
    """Zero and integer offsets land on the corners (zero weights beside
    them), at a layer1 and a layer3 width."""
    for h, w, cin in ((48, 80, 128), (12, 20, 512)):
        _, x, off, mask = _col2im_case(device, h, w, cin, 1, kind, 34)
        _wgrad_bf16_case(device, x, off, mask, 3, 3, 1, cin, off_dtype, 35)


@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
def test_deform_wgrad_bf16_fast_ragged_sites(device, off_dtype):
    """M = 2 x 7 x 9 = 126 sites, not a multiple of the 32-site chunk (the
    tail zero in both operands), and Cin 32 (each 64-column tile spans two
    taps) with Cout 128."""
    _, x, off, mask = _col2im_case(device, 7, 9, 64, 1, 'random', 36)
    _wgrad_bf16_case(device, x, off, mask, 3, 3, 1, 128, off_dtype, 37)
    _, x, off, mask = _col2im_case(device, 7, 9, 32, 1, 'random', 38)
    _wgrad_bf16_case(device, x, off, mask, 3, 3, 1, 128, off_dtype, 39)


@pytest.mark.parametrize('tm,split', [(128, 1), (128, 2), (128, 16),
                                      (256, 1), (256, 8)])
def test_deform_wgrad_bf16_fast_any_plan(device, tm, split):
    """Every tile height and cluster size the fast path can be given, with
    bf16 and fp32 offsets: d_w within _bf16_err of the plain version and
    the same bits on two launches."""
    _, x, off, mask = _col2im_case(device, 24, 40, 256, 1, 'random', 40)
    gen = torch.Generator(device=device).manual_seed(41)
    g = torch.randn(2 * 24 * 40, 256, device=device,
                    generator=gen).bfloat16()
    for od, kern in ((torch.bfloat16, KW.KERNEL_BF16),
                     (torch.float32, KW.KERNEL_BF16_F32OFF)):
        xb, ob, mb = _bf16_case(x, off, mask, od)
        got = _wgrad_launch(g, xb, ob, mb, 3, 3, 1, tm, split, kern)
        again = _wgrad_launch(g, xb, ob, mb, 3, 3, 1, tm, split, kern)
        want = KW.deform_wgrad_reference(g, xb, ob, mb, 3, 3)
        torch.cuda.synchronize()
        _bf16_err(got, again, want)


@pytest.mark.parametrize('case', ['cin48', 'cout96', 'x_unaligned',
                                  'g_unaligned'])
def test_deform_wgrad_bf16_off_path(device, case):
    """Shapes off the fast path take the general path, and are right."""
    cin = 48 if case == 'cin48' else 64
    cout = 96 if case == 'cout96' else 128
    _, x, off, mask = _col2im_case(device, 12, 20, cin, 1, 'random', 42)
    gen = torch.Generator(device=device).manual_seed(43)
    g = torch.randn(2 * 12 * 20, cout, device=device,
                    generator=gen).bfloat16()
    if case == 'g_unaligned':
        buf = torch.empty(g.numel() + 1, device=device, dtype=g.dtype)
        g = buf[1:].view(g.shape).copy_(g)
    for od in (torch.bfloat16, torch.float32):
        for m in (mask, None):
            xb, ob, mb = _bf16_case(x, off, m, od)
            if case == 'x_unaligned':
                buf = torch.empty(xb.numel() + 1, device=device,
                                  dtype=xb.dtype)
                xb = buf[1:].view(xb.shape).copy_(xb)
            assert not KW.wgrad_fast(cin, cout, xb.data_ptr(), g.data_ptr())
            got = KW.deform_wgrad_cuda(g, xb, ob, mb, 3, 3)
            again = KW.deform_wgrad_cuda(g, xb, ob, mb, 3, 3)
            want = KW.deform_wgrad_reference(g, xb, ob, mb, 3, 3)
            torch.cuda.synchronize()
            _bf16_err(got, again, want)


def test_bf16_backward_wrappers_reject_other_types(device):
    """Only bf16 data with bf16 or fp32 offsets (K3: bf16 features with
    fp32 g and out) reach the bf16 entries; any other mix raises."""
    _, x, off, mask = _col2im_case(device, 9, 11, 32, 1, 'random', 19)
    g = torch.zeros(2 * 9 * 11, 32, device=device)
    dcols = torch.zeros(2 * 9 * 11, 9 * 32, device=device)
    for xt, ot in ((x, off.bfloat16()), (x.bfloat16(), off.half()),
                   (x.half(), off.half())):
        with pytest.raises(TypeError):
            KW.deform_wgrad_cuda(g.to(xt.dtype), xt, ot, None, 3, 3)
        with pytest.raises(TypeError):
            K4.deform_col2im_cuda(dcols.to(xt.dtype), xt, ot, None, 3, 3)
    with pytest.raises(TypeError):           # fp32 g beside bf16 x
        KW.deform_wgrad_cuda(g, x.bfloat16(), off.bfloat16(), None, 3, 3)
    with pytest.raises(TypeError):           # an fp32 mask beside bf16 x
        K4.deform_col2im_cuda(dcols.bfloat16(), x.bfloat16(),
                              off.bfloat16(), mask, 3, 3)
    up, x1, x2, out = _corr_bwd_case(device, (1, 5, 7, 8), 5)
    with pytest.raises(TypeError):           # bf16 g
        K3.correlation_bwd_cuda(up.bfloat16(), x1.bfloat16(), x2.bfloat16(),
                                5)
    with pytest.raises(TypeError):           # bf16 x1 with fp32 x2
        K3.correlation_bwd_cuda(up, x1.bfloat16(), x2, 5)


@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
def test_bf16_training_backward_launches_bf16_entries(device, off_dtype):
    """The window op and the correlation in bf16 differentiate through the
    bf16 entries, one launch each, and nothing else of the port; every
    gradient comes back in its input's type."""
    from stmask_torch.kernels import KERNELS
    x, off, mask, wt, bias = _dcn_case(device, 12, 20, 64, 64, 3, 3, 1, 1,
                                       25)
    leaves = [x.bfloat16(), off.to(off_dtype), wt.bfloat16(),
              mask.bfloat16(), bias.bfloat16()]
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    f1 = torch.randn(2, 6, 10, 32, device=device).bfloat16()
    f2 = torch.randn(2, 6, 10, 32, device=device).bfloat16()
    c1, c2 = (t.clone().requires_grad_(True) for t in (f1, f2))
    out = deform_conv_window(*leaves, radius=2)
    corr = correlate(c1, c2, 5).to(torch.bfloat16)
    for k in KERNELS.values():
        k.launches = 0
    (out.float().square().sum() + corr.float().sum()).backward()
    torch.cuda.synchronize()
    launched = {n: k.launches for n, k in KERNELS.items() if k.launches}
    suffix = '_bf16' if off_dtype == torch.bfloat16 else '_bf16_f32off'
    assert launched == {'deform_wgrad' + suffix: 1,
                        'deform_col2im' + suffix: 1,
                        'correlation_bwd_bf16': 1}, launched
    for t in leaves + [c1, c2]:
        assert t.grad is not None and t.grad.dtype == t.dtype
        assert bool(torch.isfinite(t.grad.float()).all())


# ---- the fused conv's bf16 fast route (bf16 wgmma fed by a gather ring) ----

# R50's 7 DCN sites (R101's 11 have their shapes) and FCB's 15, 8 frames
# each (one eval CLI step): (H, W, Cin = Cout, kh, kw, stride)
BF16_FAST_SITES = ([(h, w, cin, 3, 3, s) for h, w, cin, s in DCN_SHAPES[3:]]
                   + [(h, w, 256, kh, kw, 1) for h, w, kh, kw in FCB_SITES])


def _offsets_of(kind, off, gen):
    """Random offsets (some beyond the image), zero ones (every sample on a
    pixel, three corner weights zero) or +-1 / +-2 (integer, on pixels)."""
    if kind == 'zero':
        return torch.zeros_like(off)
    if kind == 'integer':
        vals = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=off.device)
        return vals[torch.randint(0, 4, off.shape, device=off.device,
                                  generator=gen)]
    return off


def _fast_case(device, got_fn, x, off, wt, mask, bias, stride, dil=1):
    """The bf16 entry of the offsets' type, launched twice through the
    wrapper: within _bf16_atol of the plain version and bit for bit over
    the two launches.  Returns the route the entry was handed (its split:
    0 the general route; the entry refuses a fast call it cannot take)."""
    name = ('KERNEL_BF16' if off.dtype == torch.bfloat16
            else 'KERNEL_BF16_F32OFF')
    kern = getattr(KD, name)
    splits = []

    def record(*args):
        splits.append(args[-2])
        return kern(*args)

    n = kern.launches
    setattr(KD, name, record)
    try:
        got = got_fn(x, off, wt, mask, bias, stride, dil)
        again = got_fn(x, off, wt, mask, bias, stride, dil)
    finally:
        setattr(KD, name, kern)
    assert kern.launches == n + 2 and len(splits) == 2
    assert splits[0] == splits[1]
    want = KD.deform_conv_reference(x, off, wt, mask, bias, stride, dil)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               atol=_bf16_atol(want), rtol=0)
    assert torch.equal(got, again)
    return 'fast' if splits[0] > 0 else 'general'


@pytest.mark.parametrize('kind', ['random', 'zero', 'integer'])
@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('site', BF16_FAST_SITES,
                         ids=lambda s: 'x'.join(map(str, s)))
def test_fused_bf16_fast_route(device, site, off_dtype, kind):
    """Every R50, R101 and FCB site at 8 frames, with bf16 and fp32
    offsets, with and without the mask and the bias: the fast route."""
    h, w, cin, kh, kw, stride = site
    x, off, mask, wt, bias = _dcn_case(device, h, w, cin, cin, kh, kw,
                                       stride, 1, 50, frames=8)
    gen = torch.Generator(device=device).manual_seed(51)
    off = _offsets_of(kind, off, gen).to(off_dtype)
    x, mask, wt, bias = (t.bfloat16() for t in (x, mask, wt, bias))
    for m in (mask, None):
        for b in (bias, None):
            assert _fast_case(device, KD.deform_conv_cuda, x, off, wt, m, b,
                              stride) == 'fast'


@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
def test_fused_bf16_fast_route_reads_strided_slices(device, off_dtype):
    """Offsets and mask as channel slices of one [.., 27] tensor (site rows
    54 or 108 bytes apart) go through the fast route, read in place."""
    x, _, _, wt, bias = (t.bfloat16() for t in _dcn_case(
        device, 24, 40, 256, 256, 3, 3, 1, 1, 52, frames=8))
    om = torch.randn(8, 24, 40, 27, device=device).to(off_dtype)
    om = torch.cat([om[..., :18] * 2.0, torch.sigmoid(om[..., 18:])], -1)
    off, mask = om[..., :18], om[..., 18:].bfloat16()
    assert not off.is_contiguous()
    assert _fast_case(device, KD.deform_conv_cuda, x, off, wt, mask,
                      bias, 1) == 'fast'


def _off_route_case(device, case):
    """bf16 (x, offset (fp32), mask, weight, bias, dilation) of a shape off
    the fast route."""
    cin = {'cin48': 48, 'cin6_cout5': 6}.get(case, 64)
    cout = {'cout36': 36, 'cin6_cout5': 5}.get(case, 128)
    dil = 2 if case == 'dilation2' else 1
    x, off, mask, wt, bias = _dcn_case(device, 13, 17, cin, cout, 3, 3, 1,
                                       dil, 53, frames=2)
    x, mask, wt, bias = (t.bfloat16() for t in (x, mask, wt, bias))
    if case == 'x_unaligned':      # one element into its buffer
        buf = torch.empty(x.numel() + 1, device=device, dtype=x.dtype)
        x = buf[1:].view(x.shape).copy_(x)
    return x, off, mask, wt, bias, dil


@pytest.mark.parametrize('case', ['cin48', 'cout36', 'x_unaligned',
                                  'dilation2', 'cin6_cout5'])
def test_fused_bf16_off_route(device, case):
    """Shapes off the fast route take the general route (the fp32 kernel's
    design on bf16), with both offset types, and are right."""
    x, off, mask, wt, bias, dil = _off_route_case(device, case)
    for od in (torch.bfloat16, torch.float32):
        assert _fast_case(device, KD.deform_conv_cuda, x, off.to(od), wt,
                          mask, bias, 1, dil) == 'general'


@pytest.mark.parametrize('case', ['cin48', 'cout36', 'x_unaligned',
                                  'dilation2'])
def test_fused_bf16_entry_refuses_fast_off_route(device, monkeypatch, case):
    """The bf16 entry launches the route the wrapper names and checks it:
    handed a fast split for a call that the fast route cannot take, it
    raises and launches nothing (no fallback to the general route)."""
    x, off, mask, wt, bias, dil = _off_route_case(device, case)
    monkeypatch.setattr(KD, 'conv_fast', lambda *a: True)
    for od, kern in ((torch.bfloat16, KD.KERNEL_BF16),
                     (torch.float32, KD.KERNEL_BF16_F32OFF)):
        n = kern.launches
        with pytest.raises(RuntimeError, match='CUDA error'):
            KD.deform_conv_cuda(x, off.to(od), wt, mask, bias, 1, dil)
        assert kern.launches == n


# ---- K4's bf16 fast route (bf16 rows staged by cp.async in a ring) ------

def _col2im_routed(dcols, x, off, mask, kh, kw, stride, dil=1):
    """K4's bf16 entry of the offsets' type, launched twice through the
    wrapper: each output within _bf16_err of the plain version, d_offset
    and d_mask bit for bit over the two launches (dx sums by atomics).
    Returns the route handed to the entry (recorded around the launch: 1
    the fast route, 0 the general one; the entry refuses a fast call it
    cannot take)."""
    name = ('KERNEL_BF16' if off.dtype == torch.bfloat16
            else 'KERNEL_BF16_F32OFF')
    kern = getattr(K4, name)
    routes = []

    def record(*args):
        routes.append(args[-2])
        return kern(*args)

    n = kern.launches
    setattr(K4, name, record)
    try:
        got = K4.deform_col2im_cuda(dcols, x, off, mask, kh, kw, stride, dil)
        again = K4.deform_col2im_cuda(dcols, x, off, mask, kh, kw, stride,
                                      dil)
    finally:
        setattr(K4, name, kern)
    assert kern.launches == n + 2 and len(routes) == 2
    assert routes[0] == routes[1]
    want = K4.deform_col2im_reference(dcols, x, off, mask, kh, kw, stride,
                                      dil)
    torch.cuda.synchronize()
    assert want[1].dtype == off.dtype and got[0].dtype == torch.bfloat16
    _bf16_err(got[0], again[0], want[0], same=False)
    _bf16_err(got[1], again[1], want[1])
    assert (got[2] is None) == (mask is None)
    if mask is not None:
        _bf16_err(got[2], again[2], want[2])
    return 'fast' if routes[0] == 1 else 'general'


def _col2im_bf16_inputs(device, h, w, cin, stride, kind, seed, kh=3, kw=3,
                        frames=8, dil=1):
    """bf16 (dcols, x, offsets clamped to +-2, mask) at one site: random,
    zero or integer (+-1, +-2) offsets, as chip_smoke's K4 inputs."""
    from chip_smoke import _dcn_train_inputs
    if dil == 1:
        t = _dcn_train_inputs(torch, device, h, w, cin, stride, frames,
                              kind, seed, kh, kw)
    else:
        t = _col2im_case(device, h, w, cin, stride, kind, seed, kh, kw, dil)
    return tuple(v.bfloat16() for v in t)


@pytest.mark.parametrize('kind', ['random', 'zero', 'integer'])
@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('site', BF16_FAST_SITES,
                         ids=lambda s: 'x'.join(map(str, s)))
def test_col2im_bf16_fast_route(device, site, off_dtype, kind):
    """Every R50, R101 and FCB training site at 8 frames, with bf16 and
    fp32 offsets, with and without the mask: the fast route."""
    h, w, cin, kh, kw, stride = site
    dcols, x, off, mask = _col2im_bf16_inputs(device, h, w, cin, stride,
                                              kind, 60, kh, kw)
    for m in (mask, None):
        assert _col2im_routed(dcols, x, off.to(off_dtype), m, kh, kw,
                              stride) == 'fast'


# (H, W, Cin, stride, kh, kw, dilation) on the fast route beside the sites:
# a ragged last chunk (Cin 48, 40, 8), dilation 2, H and W off the tile, and
# images inside the border band (each footprint past every edge)
COL2IM_FAST_SHAPES = [(19, 37, 48, 2, 3, 3, 1), (24, 40, 64, 1, 3, 3, 2),
                      (13, 21, 40, 1, 5, 3, 1), (3, 4, 8, 1, 3, 3, 1),
                      (2, 3, 16, 2, 3, 5, 1)]


@pytest.mark.parametrize('off_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', COL2IM_FAST_SHAPES, ids=str)
def test_col2im_bf16_fast_route_other_shapes(device, shape, off_dtype):
    h, w, cin, stride, kh, kw, dil = shape
    for kind in ('random', 'integer'):
        dcols, x, off, mask = _col2im_bf16_inputs(device, h, w, cin, stride,
                                                  kind, 61, kh, kw, 2, dil)
        for m in (mask, None):
            assert _col2im_routed(dcols, x, off.to(off_dtype), m, kh, kw,
                                  stride, dil) == 'fast'


def _col2im_off_route(device, case):
    """bf16 (dcols, x, offsets, mask) of a call off the fast route: Cin 6,
    or x or dcols one element into its buffer."""
    cin = 6 if case == 'cin6' else 64
    dcols, x, off, mask = _col2im_bf16_inputs(device, 13, 17, cin, 1,
                                              'random', 62, frames=2)
    if case in ('x_unaligned', 'dcols_unaligned'):
        t = x if case == 'x_unaligned' else dcols
        buf = torch.empty(t.numel() + 1, device=device, dtype=t.dtype)
        t = buf[1:].view(t.shape).copy_(t)
        x, dcols = (t, dcols) if case == 'x_unaligned' else (x, t)
    return dcols, x, off, mask


@pytest.mark.parametrize('case', ['cin6', 'x_unaligned', 'dcols_unaligned'])
def test_col2im_bf16_off_route(device, case):
    """Calls off the fast route take the general route (the fp32 kernel's
    design on bf16), with both offset types, and are right."""
    dcols, x, off, mask = _col2im_off_route(device, case)
    for od in (torch.bfloat16, torch.float32):
        for m in (mask, None):
            assert _col2im_routed(dcols, x, off.to(od), m, 3, 3,
                                  1) == 'general'


@pytest.mark.parametrize('case', ['cin6', 'x_unaligned', 'dcols_unaligned'])
def test_col2im_bf16_entry_refuses_fast_off_route(device, monkeypatch,
                                                   case):
    """The bf16 entry launches the route the wrapper names and checks it:
    handed the fast route for a call that it cannot take, it raises and
    launches nothing (no fallback to the general route)."""
    dcols, x, off, mask = _col2im_off_route(device, case)
    monkeypatch.setattr(K4, 'col2im_fast', lambda *a: True)
    for od, kern in ((torch.bfloat16, K4.KERNEL_BF16),
                     (torch.float32, K4.KERNEL_BF16_F32OFF)):
        n = kern.launches
        with pytest.raises(RuntimeError, match='CUDA error'):
            K4.deform_col2im_cuda(dcols, x, off.to(od), mask, 3, 3)
        assert kern.launches == n
