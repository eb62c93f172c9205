"""CUDA kernels K1 (correlation, fp32 and bf16), K2 (deformable gather),
the fused deformable conv (fp32 and bf16), K3 (correlation backward), K4
(deformable col2im), the DCN weight gradient (deform_wgrad) and B5 (greedy
NMS) against their plain PyTorch versions, on the card.  Marked
``cuda``; without a GPU every test skips with its reason.  Run on a GPU
machine with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``."""

import pytest
import torch

# B5's shapes and inputs are chip_smoke.py phase 10a's
from chip_smoke import GREEDY_SHAPES, _greedy_inputs
from stmask_torch.kernels import correlation as K1
from stmask_torch.kernels import correlation_bwd as K3
from stmask_torch.kernels import deform_col2im as K4
from stmask_torch.kernels import deform_conv as KD
from stmask_torch.kernels import deform_im2col as K2
from stmask_torch.kernels import deform_wgrad as KW
from stmask_torch.ops.correlation import correlate
from stmask_torch.ops.deform_conv import deform_conv2d, deform_conv_window

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


def _wgrad_launch(g, x, off, mask, kh, kw, stride, tm, split):
    """The kernel's launcher called with an explicit tile height and
    cluster split (the wrapper always takes ``wgrad_plan``'s)."""
    b, h, w, cin = x.shape
    _, ho, wo, _ = off.shape
    dw = torch.empty((g.shape[1], kh, kw, cin), device=x.device)
    KW.KERNEL(g.data_ptr(), x.data_ptr(), off.data_ptr(),
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
    one, and the training forward refuses radius 0 on the card as on the
    CPU; the window op differentiates."""
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
    from stmask_torch.models import STMask
    cfg = get_config('STMask_plus_resnet50_ada').replace(
        img_h=96, img_w=128, fcb_window_radius=0)
    model = STMask(cfg).to(device)
    with pytest.raises(NotImplementedError, match='ROADMAP A.9e'):
        model(torch.zeros(1, 2, cfg.pad_h, cfg.pad_w, 3, device=device),
              train=True)


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


def test_greedy_nms_per_class_takes_the_kernel(device):
    """One launch for all the classes of a frame, equal to the CPU."""
    from stmask_torch.kernels import greedy_nms as KG
    from stmask_torch.ops.nms import greedy_nms_per_class
    gen = torch.Generator().manual_seed(3)
    lo = torch.rand(2000, 2, generator=gen) * 0.7
    boxes = torch.cat([lo, lo + 0.05 + torch.rand(2000, 2, generator=gen)
                       * 0.25], dim=-1)
    scores = torch.rand(40, 2000, generator=gen) ** 4
    n0 = KG.KERNEL.launches
    got = greedy_nms_per_class(boxes.to(device), scores.to(device))
    assert KG.KERNEL.launches == n0 + 1
    want = greedy_nms_per_class(boxes, scores)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


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
         KG.greedy_nms_cuda, KG.KERNEL)]


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
