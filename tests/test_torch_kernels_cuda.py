"""CUDA kernels K1 (correlation) and K2 (deformable gather) against their
plain PyTorch versions, on the card.  Marked ``cuda``; without a GPU every
test skips with its reason.  Run on a GPU machine with
``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``."""

import pytest
import torch

from stmask_torch.kernels import correlation as K1
from stmask_torch.kernels import deform_im2col as K2
from stmask_torch.ops.deform_conv import deform_conv2d

pytestmark = pytest.mark.cuda

# (B, H, W, C): ragged borders, and the main path's FPN level 1 at 384x640
CORR_SHAPES = [(2, 7, 9, 96), (1, 3, 2, 5), (1, 24, 40, 256)]
# (H, W, Cin, stride): small ragged shapes and the 7 main-path DCN sites
DCN_SHAPES = [(9, 11, 6, 1), (9, 11, 6, 2), (5, 4, 3, 2),
              (96, 160, 128, 2), (48, 80, 128, 1), (48, 80, 256, 2),
              (24, 40, 256, 1), (24, 40, 512, 2), (12, 20, 512, 1)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.parametrize('shape', CORR_SHAPES)
@pytest.mark.parametrize('patch', [5, 11])
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
    launches = K2.KERNEL.launches
    got = deform_conv2d(x, off, wt, mask, stride=stride)
    assert K2.KERNEL.launches == launches + 1
    want = (K2.deform_im2col_reference(x, off, mask, 3, 3, stride)
            @ wt.reshape(-1, 64)).reshape(got.shape)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


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
