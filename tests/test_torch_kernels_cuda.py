"""CUDA kernels K1 (correlation), K2 (deformable gather), the fused
deformable conv, K3 (correlation backward) and K4 (deformable col2im)
against their plain PyTorch versions, on the card.  Marked
``cuda``; without a GPU every test skips with its reason.  Run on a GPU
machine with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``."""

import pytest
import torch

from stmask_torch.kernels import correlation as K1
from stmask_torch.kernels import correlation_bwd as K3
from stmask_torch.kernels import deform_col2im as K4
from stmask_torch.kernels import deform_conv as KD
from stmask_torch.kernels import deform_im2col as K2
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


def _dcn_case(device, h, w, cin, cout, kh, kw, stride, dilation, seed):
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(1, h, w, cin, device=device, generator=g)
    off = torch.randn(1, ho, wo, 2 * kh * kw, device=device,
                      generator=g) * 2.0
    mask = torch.rand(1, ho, wo, kh * kw, device=device, generator=g)
    wt = torch.randn(cout, kh, kw, cin, device=device,
                     generator=g) / (kh * kw * cin)
    bias = torch.randn(cout, device=device, generator=g)
    return x, off, mask, wt, bias


# (H, W, Cin, Cout, kh, kw, stride, dilation): the 7 DCN sites, ragged
# channels and strides, FCB's rectangular v1 taps, dilation 2
FUSED_SHAPES = [(h, w, cin, cin, 3, 3, s, 1) for h, w, cin, s in DCN_SHAPES
                ] + [(9, 11, 6, 5, 3, 5, 1, 1), (9, 11, 6, 5, 5, 3, 2, 1),
                     (24, 40, 256, 256, 3, 5, 1, 1),
                     (24, 40, 256, 256, 5, 3, 1, 1),
                     (13, 7, 64, 36, 3, 3, 1, 2)]


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


# K3: the training shape (4 clips at 384x640) and ragged ones
CORR_BWD_SHAPES = [((4, 24, 40, 256), 11), ((2, 7, 9, 96), 11),
                   ((1, 5, 7, 40), 5), ((2, 9, 5, 5), 11)]


@pytest.mark.parametrize('shape,patch', CORR_BWD_SHAPES)
def test_correlation_bwd_kernel(device, shape, patch):
    g = torch.Generator(device=device).manual_seed(5)
    x1 = torch.randn(shape, device=device, generator=g)
    x2 = torch.randn(shape, device=device, generator=g)
    up = torch.randn(shape[:3] + (patch * patch,), device=device,
                     generator=g)
    launches = K3.KERNEL.launches
    got = K3.correlation_bwd_cuda(up, x1, x2, patch)
    assert K3.KERNEL.launches == launches + 1
    want = K3.correlation_bwd_reference(up, x1, x2, patch)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def _col2im_case(device, h, w, cin, stride, kind, seed):
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(2, h, w, cin, device=device, generator=g)
    if kind == 'random':
        off = torch.randn(2, ho, wo, 18, device=device, generator=g) * 1.5
    elif kind == 'zero':
        off = torch.zeros(2, ho, wo, 18, device=device)
    else:
        vals = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=device)
        off = vals[torch.randint(0, 4, (2, ho, wo, 18), device=device,
                                 generator=g)]
    off = off.clamp(-2, 2)
    mask = torch.rand(2, ho, wo, 9, device=device, generator=g)
    dcols = torch.randn(2 * ho * wo, 9 * cin, device=device, generator=g)
    return dcols, x, off, mask


@pytest.mark.parametrize('kind', ['random', 'zero', 'integer'])
@pytest.mark.parametrize('shape', [(9, 11, 6, 1), (9, 11, 6, 2),
                                   (24, 40, 256, 1), (24, 40, 512, 2),
                                   (7, 5, 3, 1)])
def test_deform_col2im_kernel(device, shape, kind):
    """dx sums with fp32 atomics, so its tolerance is relative to
    max|ref|; d_offset and d_mask are summed in a fixed order."""
    h, w, cin, stride = shape
    dcols, x, off, mask = _col2im_case(device, h, w, cin, stride, kind, 6)
    for m in (mask, None):
        launches = K4.KERNEL.launches
        got = K4.deform_col2im_cuda(dcols, x, off, m, 3, 3, stride)
        assert K4.KERNEL.launches == launches + 1
        want = K4.deform_col2im_reference(dcols, x, off, m, 3, 3, stride)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if b is None:
                assert a is None
                continue
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, atol=1e-5 * max(scale, 1.0),
                                       rtol=0)


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
