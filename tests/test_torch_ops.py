"""The port's ops against the JAX package's, on the same numpy inputs.

The port runs on the CPU, where every kernel wrapper takes its plain
PyTorch version; the CUDA kernels are held against those plain versions
in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from stmask_tpu.kernels.correlation_pallas import correlate_pallas
from stmask_tpu.models.layers import resize_bilinear as j_resize
from stmask_tpu.ops import boxes as JB
from stmask_tpu.ops import nms as JN
from stmask_tpu.ops.correlation import correlate as j_correlate
from stmask_tpu.ops.deform_conv import (dcn_v2_offsets as j_dcn_offsets,
                                        deform_conv2d as j_deform)
from stmask_tpu.ops.masks import generate_mask as j_generate_mask
from stmask_tpu.ops.roi_align import roi_align as j_roi_align

from stmask_torch.kernels.deform_conv import deform_conv_reference
from stmask_torch.models.layers import resize_bilinear as t_resize
from stmask_torch.ops import boxes as TB
from stmask_torch.ops import nms as TN
from stmask_torch.ops.correlation import correlate as t_correlate
from stmask_torch.ops.deform_conv import (dcn_v2_offsets as t_dcn_offsets,
                                          deform_conv2d as t_deform)
from stmask_torch.ops.masks import generate_mask as t_generate_mask
from stmask_torch.ops.roi_align import roi_align as t_roi_align


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


def _boxes(rng, n):
    """Point-form boxes with degenerate (zero-area, inverted) and
    out-of-image members."""
    a = rng.uniform(-0.2, 1.2, (n, 2)).astype(np.float32)
    wh = rng.uniform(0.0, 0.6, (n, 2)).astype(np.float32)
    b = np.concatenate([a, a + wh], axis=1)
    b[0] = [0.3, 0.3, 0.3, 0.3]            # zero area
    b[1] = [0.7, 0.6, 0.2, 0.1]            # inverted
    b[2] = [-0.5, -0.4, -0.1, -0.05]       # fully outside
    b[3] = [0.9, 0.8, 1.4, 1.3]            # partly outside
    return b


def test_box_geometry():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 9), _boxes(rng, 7)
    _close(TB.point_form(_t(a)), JB.point_form(jnp.asarray(a)), 0)
    _close(TB.center_size(_t(a)), JB.center_size(jnp.asarray(a)), 0)
    _close(TB.area(_t(a)), JB.area(jnp.asarray(a)), 0)
    _close(TB.intersect(_t(a), _t(b)), JB.intersect(jnp.asarray(a),
                                                    jnp.asarray(b)), 1e-7)
    for crowd in (False, True):
        _close(TB.jaccard(_t(a), _t(b), iscrowd=crowd),
               JB.jaccard(jnp.asarray(a), jnp.asarray(b), iscrowd=crowd),
               1e-6)
    for pad in (0, 1):
        for port, ref in zip(
                TB.sanitize_coordinates(_t(a[:, 0]), _t(a[:, 2]), 40, pad),
                JB.sanitize_coordinates(jnp.asarray(a[:, 0]),
                                        jnp.asarray(a[:, 2]), 40, pad)):
            _close(port, ref, 1e-5)
    _close(TB.sanitize_coordinates_hw(_t(a), 24, 40),
           JB.sanitize_coordinates_hw(jnp.asarray(a), 24, 40), 1e-5)


def test_decode():
    rng = np.random.RandomState(1)
    loc = rng.randn(50, 4).astype(np.float32) * 2
    pri = np.concatenate([rng.rand(50, 2), rng.rand(50, 2) * 0.3 + 0.01],
                         axis=1).astype(np.float32)
    _close(TB.decode(_t(loc), _t(pri)), JB.decode(jnp.asarray(loc),
                                                  jnp.asarray(pri)),
           1e-6, 1e-6)


def test_crop_mask_iou_and_generate_mask():
    rng = np.random.RandomState(2)
    bx = _boxes(rng, 6)
    masks = rng.rand(12, 16, 6).astype(np.float32)
    for port, ref in zip(TB.crop(_t(masks), _t(bx)),
                         JB.crop(jnp.asarray(masks), jnp.asarray(bx))):
        _close(port, ref, 0)
    m1 = (rng.rand(5, 12, 16) > 0.5).astype(np.float32)
    m2 = (rng.rand(4, 12, 16) > 0.7).astype(np.float32)
    m2[0] = 0                                          # empty mask
    _close(TB.mask_iou(_t(m1), _t(m2)),
           JB.mask_iou(jnp.asarray(m1), jnp.asarray(m2)), 1e-6)
    proto = np.maximum(rng.randn(12, 16, 32), 0).astype(np.float32)
    coeff = rng.randn(6, 32).astype(np.float32)
    for box in (bx, None):
        _close(t_generate_mask(_t(proto), _t(coeff),
                               None if box is None else _t(box)),
               j_generate_mask(jnp.asarray(proto), jnp.asarray(coeff),
                               None if box is None else jnp.asarray(box)),
               1e-6)


def test_roi_align():
    rng = np.random.RandomState(3)
    feat = rng.randn(12, 15, 8).astype(np.float32)
    bx = np.array([[1.0, 2.0, 9.5, 10.0],       # inside
                   [-3.0, -2.0, 4.0, 3.0],      # crosses the top-left
                   [10.0, 8.0, 20.0, 16.0],     # crosses the bottom-right
                   [5.0, 5.0, 5.0, 5.0],        # degenerate
                   [20.0, 20.0, 30.0, 30.0]],   # fully outside
                  np.float32)
    _close(t_roi_align(_t(feat), _t(bx)),
           j_roi_align(jnp.asarray(feat), jnp.asarray(bx)), 1e-5)


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('modulated', [True, False])
def test_deform_conv2d(stride, modulated):
    """Offsets up to +-4 px (negative too), samples leaving the image on
    every side, odd sizes."""
    rng = np.random.RandomState(4 + stride)
    b, h, w, cin, cout = 2, 9, 11, 6, 5
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(b, h, w, cin).astype(np.float32)
    off = rng.uniform(-4, 4, (b, ho, wo, 18)).astype(np.float32)
    mask = rng.rand(b, ho, wo, 9).astype(np.float32) if modulated else None
    wt = rng.randn(3, 3, cin, cout).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    port = t_deform(_t(x), _t(off), _t(wt),
                    None if mask is None else _t(mask), _t(bias), stride)
    ref = j_deform(jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt),
                   None if mask is None else jnp.asarray(mask),
                   jnp.asarray(bias), stride)
    _close(port, ref, 1e-5)


# (kh, kw, stride, dilation, modulated, bias, max |offset|)
FUSED_DCN_CASES = {
    'v2_3x3_s1': (3, 3, 1, 1, True, True, 4.0),
    'v2_3x3_s2': (3, 3, 2, 1, True, True, 4.0),
    'v1_3x5': (3, 5, 1, 1, False, True, 3.0),
    'v1_5x3': (5, 3, 1, 1, False, True, 3.0),
    'v1_5x3_s2': (5, 3, 2, 1, False, False, 3.0),
    'v2_dilation2': (3, 3, 1, 2, True, True, 3.0),
    'v2_no_bias': (3, 3, 1, 1, True, False, 3.0),
    'v2_far_outside': (3, 3, 1, 1, True, True, 15.0),
}


@pytest.mark.parametrize('case', sorted(FUSED_DCN_CASES))
def test_fused_deform_conv_plain_version(case):
    """The fused kernel's plain version (weight as [Cout, kh, kw, Cin]) and
    the public op on CPU tensors against the JAX deform_conv2d.  The largest
    offsets put whole samples outside the image on every side."""
    kh, kw, stride, dil, modulated, with_bias, reach = FUSED_DCN_CASES[case]
    rng = np.random.RandomState(20 + sorted(FUSED_DCN_CASES).index(case))
    b, h, w, cin, cout = 2, 9, 11, 6, 5
    k = kh * kw
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(b, h, w, cin).astype(np.float32)
    off = rng.uniform(-reach, reach, (b, ho, wo, 2 * k)).astype(np.float32)
    mask = rng.rand(b, ho, wo, k).astype(np.float32) if modulated else None
    wt = rng.randn(kh, kw, cin, cout).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32) if with_bias else None

    def opt(a):
        return None if a is None else _t(a)

    def jopt(a):
        return None if a is None else jnp.asarray(a)

    ref = j_deform(jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt),
                   jopt(mask), jopt(bias), stride, dil)
    plain = deform_conv_reference(_t(x), _t(off),
                                  _t(wt.transpose(3, 0, 1, 2).copy()),
                                  opt(mask), opt(bias), stride, dil)
    _close(plain, ref, 1e-5)
    _close(t_deform(_t(x), _t(off), _t(wt), opt(mask), opt(bias), stride,
                    dil), ref, 1e-5)


def test_dcn_v2_offsets_not_permuted():
    conv_out = np.random.RandomState(6).randn(1, 3, 4, 27).astype(np.float32)
    for port, ref in zip(t_dcn_offsets(_t(conv_out), 9),
                         j_dcn_offsets(jnp.asarray(conv_out), 9)):
        _close(port, ref, 1e-7)
    np.testing.assert_array_equal(t_dcn_offsets(_t(conv_out), 9)[0].numpy(),
                                  conv_out[..., :18])


@pytest.mark.parametrize('patch', [5, 11])
def test_correlate(patch):
    rng = np.random.RandomState(7)
    x1 = rng.randn(2, 6, 7, 32).astype(np.float32)
    x2 = rng.randn(2, 6, 7, 32).astype(np.float32)
    port = t_correlate(_t(x1), _t(x2), patch_size=patch)
    with pltpu.force_tpu_interpret_mode():
        pallas = correlate_pallas(jnp.asarray(x1), jnp.asarray(x2),
                                  patch_size=patch)
    _close(port, pallas, 1e-6)
    _close(port, j_correlate(jnp.asarray(x1), jnp.asarray(x2),
                             patch_size=patch), 1e-6)
    raw = t_correlate(_t(x1), _t(x2), patch_size=patch,
                      apply_activation=False)
    _close(raw, j_correlate(jnp.asarray(x1), jnp.asarray(x2),
                            patch_size=patch, apply_activation=False), 1e-6)


def test_resize_bilinear_x2():
    """Every resize on the model's path is an exact x2 upsample."""
    x = np.random.RandomState(8).randn(1, 6, 10, 4).astype(np.float32)
    port = t_resize(_t(x).permute(0, 3, 1, 2), (12, 20)).permute(0, 2, 3, 1)
    _close(port, j_resize(jnp.asarray(x), (12, 20)), 1e-6)


def test_top_k_padded_ties_and_short_input():
    scores = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5],
                       [0.2, 0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    for k in (4, 6, 9):                   # 9 > axis size: padded
        tv, ti = TN._top_k_padded(_t(scores), k)
        jv, ji = JN._top_k_padded(jnp.asarray(scores), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize('n', [40, 7])    # 7 < top_k: padded candidates
def test_cc_fast_nms_with_ties(n):
    rng = np.random.RandomState(9)
    a = rng.rand(n, 2).astype(np.float32) * 0.7
    bx = np.concatenate([a, a + rng.rand(n, 2).astype(np.float32) * 0.3 +
                         0.05], axis=1)
    bx[5 % n] = bx[3 % n] + 0.01                       # heavy overlap
    sc = np.round(rng.rand(n), 1).astype(np.float32)   # many exact ties
    sc[::4] = TN.NEG_INF                               # pre-filtered
    port = TN.cc_fast_nms(_t(bx), _t(sc), 0.5, top_k=20)
    ref = JN.cc_fast_nms(jnp.asarray(bx), jnp.asarray(sc), 0.5, top_k=20)
    np.testing.assert_array_equal(port.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(port.scores.numpy(), np.asarray(ref.scores))


def test_rle_matches_jax_package():
    from stmask_tpu.utils import rle as j_rle
    from stmask_torch.utils import rle as t_rle
    rng = np.random.RandomState(10)
    for shape in ((5, 7), (36, 64), (1, 1)):
        for fill in (0.0, 0.3, 1.0):
            m = (rng.rand(*shape) < fill).astype(np.uint8)
            enc = t_rle.encode(m)
            assert enc == j_rle.encode(m)
            np.testing.assert_array_equal(t_rle.decode(enc), m)


def test_normalize_pad_matches_device_transform():
    from stmask_tpu.config import get_config as j_get_config
    from stmask_tpu.data.transforms import normalize_pad_device
    from stmask_torch.config import get_config as t_get_config
    from stmask_torch.inference.pipeline import normalize_pad
    kw = dict(img_h=90, img_w=120)
    img = np.random.RandomState(11).randint(0, 256, (90, 120, 3), np.uint8)
    ref = normalize_pad_device(j_get_config('STMask_plus_resnet50').replace(
        **kw))(jnp.asarray(img))
    _close(normalize_pad(t_get_config('STMask_plus_resnet50').replace(**kw),
                         _t(img)), ref, 1e-6)
