"""The port's training ops against the JAX package on the CPU: box and mask
helpers, the matcher, the correlation and deformable-conv backward (the
plain versions of kernels K3 and K4 inside their autograd Functions),
RoIAlign's gradient, and ``dcn_window_eval``.

Inputs are made with numpy from a seed.  Gradients are held against
``jax.grad`` of the JAX function; fp32 rounding is the only allowed
difference (atol 2e-6 relative to max|ref|, or as stated)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.config import BackboneConfig as JBackboneConfig
from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.models.backbone import ResNetBackbone as JResNetBackbone
from stmask_tpu.ops import boxes as JB
from stmask_tpu.ops.anchors import make_priors
from stmask_tpu.ops.correlation import correlate as j_correlate
from stmask_tpu.ops.deform_conv import deform_conv2d_window as j_dcn_window
from stmask_tpu.ops.masks import coeff_activation as j_coeff_activation
from stmask_tpu.ops.matcher import match as j_match
from stmask_tpu.ops.roi_align import roi_align as j_roi_align

from stmask_torch.config import BackboneConfig as TBackboneConfig
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.kernels.correlation_bwd import \
    correlation_bwd_reference as t_correlation_bwd_reference
from stmask_torch.models.backbone import ResNetBackbone as TResNetBackbone
from stmask_torch.ops import boxes as TB
from stmask_torch.ops.correlation import correlate as t_correlate
from stmask_torch.ops.deform_conv import deform_conv_window as t_dcn_window
from stmask_torch.ops.masks import coeff_activation as t_coeff_activation
from stmask_torch.ops.matcher import match as t_match
from stmask_torch.ops.roi_align import roi_align as t_roi_align

CFG = j_get_config('STMask_plus_resnet50')
G = 6
PRIORS = make_priors(10, 10, CFG.head_kernel_sizes, [24.0])  # P = 300


def _close(got, want, rel=2e-6, msg=''):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * scale, err_msg=msg)


def _boxes(rng, n, degenerate=True):
    """Random point-form boxes; a quarter of them zero-size (x1 == x2 or
    y1 == y2, or both) when ``degenerate``."""
    xy = rng.rand(n, 2).astype(np.float32)
    wh = (rng.rand(n, 2) * 0.5).astype(np.float32)
    if degenerate:
        wh[: n // 8] = 0.0
        wh[n // 8: n // 4, 0] = 0.0
    return np.concatenate([xy, xy + wh], axis=1)


def test_box_helpers_elementwise():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 64), _boxes(rng, 64)
    a[:4] = b[:4]                                     # identical pairs
    pri = np.concatenate([rng.rand(64, 2), rng.rand(64, 2) * 0.4 + 0.05],
                         axis=1).astype(np.float32)
    for name, args in (('encode', (a, pri)), ('elemwise_diou', (a, b)),
                       ('diou_distance', (a, b[:23])),
                       ('elemwise_box_iou', (a, b))):
        want = getattr(JB, name)(*map(jnp.asarray, args))
        got = getattr(TB, name)(*map(torch.from_numpy, args))
        _close(got, want, 1e-6, name)
    x = rng.randn(10, 32).astype(np.float32) * 3
    for kind in ('tanh', 'none'):
        _close(t_coeff_activation(torch.from_numpy(x), kind),
               j_coeff_activation(jnp.asarray(x), kind), 1e-6, kind)


def _match_case(rng):
    n = rng.randint(1, G + 1)
    boxes = np.zeros((G, 4), np.float32)
    labels = np.zeros((G,), np.int32)
    ids = np.zeros((G,), np.int32)
    valid = np.zeros((G,), bool)
    base = None
    for j in range(n):
        if base is not None and rng.rand() < 0.4:
            b = np.clip(base + rng.uniform(-0.05, 0.05, 4), 0, 1)
            b[2] = max(b[2], min(1.0, b[0] + 0.05))
            b[3] = max(b[3], min(1.0, b[1] + 0.05))
        else:
            w, h = rng.uniform(0.1, 0.6, 2)
            x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            b = np.array([x1, y1, x1 + w, y1 + h])
            base = b
        boxes[j] = b
        labels[j] = rng.randint(1, CFG.num_classes)
        ids[j] = j + 1
        valid[j] = True
    crowd = np.zeros((3, 4), np.float32)
    crowd_valid = np.zeros((3,), bool)
    if rng.rand() < 0.5:                               # the crowd branch
        crowd[0] = [0.0, 0.0, 0.5, 0.6]
        crowd[1] = _boxes(rng, 1, degenerate=False)[0]
        crowd_valid[:2] = True
    conf = rng.randn(PRIORS.shape[0], CFG.num_classes).astype(np.float32)
    return boxes, labels, ids, valid, conf, crowd, crowd_valid


def test_matcher_fuzz_integer_exact():
    """40 frames with 1..6 gts (overlapping ones in the multi-instance veto
    range, crowd regions in half of them) through JAX's matcher one frame
    at a time and the port's matcher in one batched call."""
    @jax.jit
    def run(boxes, labels, ids, valid, conf, crowd, crowd_valid):
        return j_match(CFG.positive_iou_threshold, CFG.negative_iou_threshold,
                       boxes, labels, ids, valid, jnp.asarray(PRIORS), conf,
                       crowd_boxes=crowd, crowd_valid=crowd_valid,
                       crowd_iou_threshold=CFG.crowd_iou_threshold)

    cases = [_match_case(np.random.RandomState(2000 + t)) for t in range(40)]
    stacked = [torch.from_numpy(np.stack(c)) for c in zip(*cases)]
    got = t_match(CFG.positive_iou_threshold, CFG.negative_iou_threshold,
                  *stacked[:4], torch.from_numpy(PRIORS), stacked[4],
                  crowd_boxes=stacked[5], crowd_valid=stacked[6],
                  crowd_iou_threshold=CFG.crowd_iou_threshold)
    n_pos = n_neutral = 0
    for t, case in enumerate(cases):
        want = run(*map(jnp.asarray, case))
        for name in ('conf_t', 'idx_t', 'ids_t'):
            np.testing.assert_array_equal(getattr(got, name)[t].numpy(),
                                          np.asarray(getattr(want, name)),
                                          f'{name} trial {t}')
        _close(got.loc_t[t], want.loc_t, 1e-6, f'loc_t trial {t}')
        n_pos += int((got.conf_t[t] > 0).sum())
        n_neutral += int((got.conf_t[t] < 0).sum())
    assert n_pos > 40 and n_neutral > 40


@pytest.mark.parametrize('shape,patch', [((2, 7, 9, 16), 11),
                                         ((2, 7, 9, 16), 5)])
def test_correlation_backward_matches_jax_grad(shape, patch):
    """Border displacements give exact zeros, where JAX's leaky ReLU has
    slope 1 and torch's F.leaky_relu 0.1."""
    rng = np.random.RandomState(patch)
    x1, x2 = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    cot = rng.randn(*shape[:3], patch * patch).astype(np.float32)

    def loss(a, b):
        return jnp.sum(j_correlate(a, b, patch) * cot)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x1), jnp.asarray(x2))
    t1 = torch.tensor(x1, requires_grad=True)
    t2 = torch.tensor(x2, requires_grad=True)
    out = t_correlate(t1, t2, patch)
    assert int((out == 0).sum()) > 0
    (out * torch.from_numpy(cot)).sum().backward()
    _close(t1.grad, want[0], msg='dx1')
    _close(t2.grad, want[1], msg='dx2')


@pytest.mark.parametrize('c', [5, 16])
@pytest.mark.parametrize('hw,patch', [((3, 9), 5), ((9, 4), 5),
                                      ((4, 13), 11), ((12, 3), 11),
                                      ((5, 6), 1)])
def test_correlation_bwd_reference_matches_jax_vjp(hw, patch, c):
    """K3's plain version with the activation folded in (``out=``) against
    ``jax.vjp`` of the activated correlation.  H or W below the patch puts
    whole displaced rows or columns outside the image; a zero pixel of x1
    gives exact zeros in ``out`` at every patch, where JAX's slope is 1.
    fp32 with the sums taken in another order: atol 1e-6 of max|ref|."""
    rng = np.random.RandomState(100 * patch + c)
    shape = (2,) + hw + (c,)
    x1, x2 = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    x1[:, 0, 0, :] = 0.0
    cot = rng.randn(*shape[:3], patch * patch).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: j_correlate(a, b, patch),
                       jnp.asarray(x1), jnp.asarray(x2))
    want = vjp(jnp.asarray(cot))
    out = np.array(out)
    assert (out == 0).any() and (out < 0).any()
    got = t_correlation_bwd_reference(
        torch.from_numpy(cot), torch.from_numpy(x1), torch.from_numpy(x2),
        patch, out=torch.from_numpy(out))
    _close(got[0], want[0], 1e-6, 'dx1')
    _close(got[1], want[1], 1e-6, 'dx2')


def _offsets(kind, rng, shape):
    if kind == 'random':       # non-integer, some beyond +-2 (clamped)
        return (rng.randn(*shape) * 1.5).astype(np.float32)
    if kind == 'zero':         # the from-scratch state: every tap on a kink
        return np.zeros(shape, np.float32)
    return rng.choice([-2.0, -1.0, 1.0, 2.0], size=shape).astype(np.float32)


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('kind', ['random', 'zero', 'integer'])
def test_dcn_window_backward_matches_jax_grad(stride, kind):
    """x, offset, mask, weight and bias gradients of the window-clamped
    deformable conv (radius 2): JAX's subgradients at integer offsets, no
    outlier allowance."""
    rng = np.random.RandomState(10 * stride + len(kind))
    b, h, w, cin, cout = 2, 7, 9, 6, 5
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(b, h, w, cin).astype(np.float32)
    off = _offsets(kind, rng, (b, ho, wo, 18))
    if kind == 'random':
        off[0, 0, 0, :4] = [2.0, -2.0, 3.5, -2.5]    # at and beyond the clip
    mask = rng.rand(b, ho, wo, 9).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    cot = rng.randn(b, ho, wo, cout).astype(np.float32)

    def loss(*args):
        return jnp.sum(j_dcn_window(*args, stride=stride, radius=2) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, off, wt, mask, bias)))
    ts = [torch.tensor(a, requires_grad=True)
          for a in (x, off, wt, mask, bias)]
    out = t_dcn_window(ts[0], ts[1], ts[2].permute(3, 0, 1, 2).contiguous(),
                       ts[3], ts[4], stride=stride, radius=2)   # HWIO -> OHWI
    (out * torch.from_numpy(cot)).sum().backward()
    for name, t, ref in zip(('x', 'offset', 'weight', 'mask', 'bias'), ts,
                            want):
        _close(t.grad, ref, 2e-6, f'd {name} ({kind}, stride {stride})')


def test_roi_align_gradient_matches_jax_grad():
    rng = np.random.RandomState(3)
    feat = rng.randn(12, 20, 8).astype(np.float32)
    boxes = np.stack([rng.uniform(-2, 8, 9), rng.uniform(-2, 5, 9),
                      rng.uniform(9, 22, 9), rng.uniform(6, 14, 9)],
                     axis=1).astype(np.float32)
    cot = rng.randn(9, 7, 7, 8).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(j_roi_align(f, jnp.asarray(boxes), 7)
                                      * cot))(jnp.asarray(feat))
    tf = torch.tensor(feat, requires_grad=True)
    (t_roi_align(tf, torch.from_numpy(boxes), 7)
     * torch.from_numpy(cot)).sum().backward()
    _close(tf.grad, want, 2e-6, 'd features')


@pytest.fixture(scope='module')
def small_backbone():
    """A 4-block R50-shaped backbone with DCN in its two middle stages and
    offset predictors whose bias (std 3) puts most offsets beyond +-2."""
    kw = dict(name='ResNet50', layers=(1, 1, 1, 1), dcn_layers=(0, 1, 1, 0))
    jbb = JResNetBackbone(JBackboneConfig(**kw))
    x = np.random.RandomState(4).randn(1, 32, 48, 3).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jbb.init(
        jax.random.PRNGKey(0), jnp.asarray(x))['params'])
    rng = np.random.RandomState(5)
    for blk in ('layer1_0', 'layer2_0'):
        om = params[blk]['conv2']['conv_offset_mask']
        om['kernel'] = (rng.randn(*om['kernel'].shape) * 0.01).astype(
            np.float32)
        om['bias'] = (rng.randn(*om['bias'].shape) * 3.0).astype(np.float32)
    tparams = {'backbone': params}
    sd = {k[len('backbone.'):]: v
          for k, v in state_dict_from_flax(tparams).items()}
    return kw, params, sd, x


@pytest.mark.parametrize('window_eval', [False, True])
def test_dcn_window_eval_flag(small_backbone, window_eval):
    kw, params, sd, x = small_backbone
    outs = {}
    for flag in (False, True):
        jbb = JResNetBackbone(JBackboneConfig(**kw, dcn_window_eval=flag))
        outs[flag] = jbb.apply({'params': params}, jnp.asarray(x))
    tbb = TResNetBackbone(TBackboneConfig(**kw, dcn_window_eval=window_eval))
    tbb.load_state_dict(sd)
    with torch.no_grad():
        got = tbb(torch.from_numpy(x).permute(0, 3, 1, 2))
    for lvl, (g, want) in enumerate(zip(got, outs[window_eval])):
        _close(g.permute(0, 2, 3, 1), want, 2e-5, f'C{lvl + 2}')
    # the clamp engaged: the flag changes the output
    assert np.abs(np.asarray(outs[True][-1])
                  - np.asarray(outs[False][-1])).max() > 1e-2
