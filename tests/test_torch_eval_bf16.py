"""bf16 eval against the JAX package's bf16 path (``eval.py --bf16``,
``cast_params``): the plain bf16 deformable conv and correlation, and the
reduced flagship cast to bf16 against flax with ``cast_params`` on the same
weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from stmask_tpu.inference import cast_params
from stmask_tpu.kernels.correlation_pallas import correlate_pallas
from stmask_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d

from stmask_torch.inference.pipeline import cast_model
from stmask_torch.kernels.correlation import correlate_reference
from stmask_torch.ops.deform_conv import deform_conv2d

from torch_eval_common import JCFG, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401

BF16_EPS = 2.0 ** -8          # half a unit in the last place of 1.0


def _bf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


# (H, W, Cin, Cout, stride, modulated, bias)
DCN_CASES = [(9, 11, 32, 16, 1, True, True), (12, 10, 64, 32, 2, True, True),
             (5, 6, 8, 8, 1, False, False), (7, 9, 16, 24, 2, True, False)]


@pytest.mark.parametrize('case', DCN_CASES)
def test_bf16_deform_conv_plain_matches_jax(case):
    """The plain bf16 version rounds where JAX's bf16 ``deform_conv2d``
    does (corner weights, products, the 2x2 sum, the modulation, the dot's
    fp32 sum, the bias add), so only the order of the fp32 sums may
    differ: within 2 bf16 ulps of max|ref| (observed: equal)."""
    h, w, cin, cout, stride, v2, has_bias = case
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    rng = np.random.RandomState(cin + stride)
    x = rng.randn(2, h, w, cin).astype(np.float32)
    off = (rng.randn(2, ho, wo, 18) * 2).astype(np.float32)
    mask = rng.rand(2, ho, wo, 9).astype(np.float32) if v2 else None
    wt = (rng.randn(3, 3, cin, cout) / (9 * cin)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32) if has_bias else None
    ref = np.asarray(j_deform_conv2d(
        _bf(x), _bf(off), _bf(wt), None if mask is None else _bf(mask),
        None if bias is None else _bf(bias), stride=stride)
        .astype(jnp.float32))

    def tb(a):
        return None if a is None else torch.from_numpy(a).bfloat16()

    got = deform_conv2d(tb(x), tb(off), tb(wt), tb(mask), tb(bias),
                        stride=stride)
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - ref)
    scale = np.abs(ref).max()
    print(f'{case}: max|diff| {d.max():.3e}, {(d > 0).mean():.2%} of '
          f'outputs differ, max|ref| {scale:.3e}')
    assert d.max() <= 2 * 2 * BF16_EPS * scale


@pytest.mark.parametrize('shape,patch', [((2, 6, 7, 40), 5),
                                         ((1, 12, 20, 256), 11)])
def test_bf16_correlation_plain_matches_pallas(shape, patch):
    """bf16 inputs against the Pallas kernel in interpret mode.  The
    kernel rounds each product to bf16 (``correlation_pallas.py:28-29``);
    interpret mode on the CPU does not (XLA drops the bf16 round trip of a
    product that is then widened), so the two differ by at most the
    products' rounding: 2^-9 of sum|x1 * x2| / C at each output."""
    rng = np.random.RandomState(patch)
    x1 = rng.randn(*shape).astype(np.float32)
    x2 = rng.randn(*shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(correlate_pallas(_bf(x1), _bf(x2), patch_size=patch))
    t1, t2 = (torch.from_numpy(a).bfloat16() for a in (x1, x2))
    got = correlate_reference(t1, t2, patch)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    bound = correlate_reference(t1.float().abs(), t2.float().abs(), patch,
                                apply_activation=False).numpy() * 2.0 ** -9
    d = np.abs(got.numpy() - ref)
    print(f'{shape} P {patch}: max|diff| {d.max():.3e}, max|ref| '
          f'{np.abs(ref).max():.3e}, max bound {bound.max():.3e}')
    assert (d <= bound + 1e-7).all()


@pytest.fixture(scope='module')
def models():
    jmodel, params = flax_params(seed=0)
    return jmodel, params, port_model(params)


def test_bf16_model_matches_flax_cast_params(models):
    """The port cast to bf16 against flax with ``cast_params`` on the same
    weights and the same bf16 frame.  Each output is held to twice JAX's
    own bf16-vs-fp32 gap on that output, measured here; the decode-side
    outputs come back in fp32, ``fpn_feat`` and ``T2S_feat`` in bf16."""
    jmodel, params, tmodel = models
    x = np.random.RandomState(1).randn(1, JCFG.pad_h, JCFG.pad_w,
                                       3).astype(np.float32)
    apply = jax.jit(lambda p, f: jmodel.apply(p, f, train=False))
    ref32 = apply(params, jnp.asarray(x))
    ref16 = apply(cast_params(params, jnp.bfloat16),
                  jnp.asarray(x).astype(jnp.bfloat16))
    model = cast_model(tmodel, torch.bfloat16)
    with torch.inference_mode():
        out = model(torch.from_numpy(x).bfloat16())
    for key in ('loc', 'conf', 'centerness', 'mask_coeff', 'track', 'proto',
                'T2S_feat', 'fpn_feat'):
        want_dtype = torch.bfloat16 if key in ('T2S_feat', 'fpn_feat') \
            else torch.float32
        assert out[key].dtype == want_dtype, key
        r16 = np.asarray(ref16[key], np.float32)
        r32 = np.asarray(ref32[key], np.float32)
        gap = np.abs(r16 - r32).max()
        d = np.abs(out[key].float().numpy() - r16).max()
        print(f'{key}: port bf16 vs JAX bf16 {d:.3e}, JAX bf16 vs fp32 '
              f'{gap:.3e}')
        assert 0 < gap and d <= 2 * gap, (key, d, gap)
    # the frozen-BN statistics were rounded too, and fold in fp32
    bn = model.backbone.bn1
    assert bn.running_var.dtype == torch.bfloat16
    assert bn.num_batches_tracked.dtype == torch.long
