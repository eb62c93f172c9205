"""CUDA kernels K1 (correlation), K2 (deformable gather) and the fused
deformable conv against their plain PyTorch versions, on the card.  Marked
``cuda``; without a GPU every test skips with its reason.  Run on a GPU
machine with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``."""

import pytest
import torch

from stmask_torch.kernels import correlation as K1
from stmask_torch.kernels import deform_conv as KD
from stmask_torch.kernels import deform_im2col as K2
from stmask_torch.ops.deform_conv import deform_conv2d

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
