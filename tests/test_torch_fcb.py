"""FCB (``FeatureAlign``, ``ada`` and ``ali``) in the port against the JAX
package on the CPU, one bank at a time: the analytic offsets, the bank in
eval and in training (with ``jax.grad``), and the bank in bf16 (the reduced
models are in ``test_torch_fcb_model.py``).

Inputs are made from a seed with numpy, Cin 16.  Tolerances, stated per
test: offsets to 1e-6; the bank's output and gradients to 2e-6 of max|ref|
(the window op's tolerance in ``test_torch_train_ops.py``); bf16 as its
test says.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.inference import cast_params
from stmask_tpu.models.heads import FeatureAlign as JFeatureAlign
from stmask_tpu.models.heads import _ali_offsets as j_ali_offsets

from stmask_torch.inference.pipeline import cast_model
from stmask_torch.models.heads import FeatureAlign as TFeatureAlign
from stmask_torch.models.heads import _ali_offsets as t_ali_offsets

from torch_eval_common import few_torch_threads  # noqa: F401

KSIZES = [(3, 3), (3, 5), (5, 3)]
# FPN levels of a small input: P7's 3x5 (every 5x3 footprint past both
# edges) and P6's 6x10 among them
LEVELS = [(3, 5), (6, 10), (4, 7)]
# one level per taps in training (each shape is a JAX compile of ~10 s):
# 5x3 taps on P7's 3x5, 3x5 taps on P6's 6x10
TRAIN_LEVEL = {(3, 3): (4, 7), (3, 5): (6, 10), (5, 3): (3, 5)}
CIN, COUT, RADIUS = 16, 10, 2


def _close(got, want, rel, msg=''):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * scale, err_msg=msg)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('ks', KSIZES)
def test_ali_offsets_match_jax(ks, dtype):
    """float32 offsets from float32 or bf16 box deltas, with JAX's bf16
    roundings (to 1e-6; JAX and the port agree bit for bit here)."""
    rng = np.random.RandomState(ks[0] * 10 + ks[1])
    shape = (rng.randn(2, 6, 10, 4) * 2).astype(np.float32)
    want = j_ali_offsets(jnp.asarray(shape, dtype), ks)
    t_dt = getattr(torch, dtype)
    got = t_ali_offsets(torch.from_numpy(shape).to(t_dt), ks)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert got.shape == (2, 6, 10, 2 * ks[0] * ks[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    if dtype == 'bfloat16':
        # the bf16 roundings matter: without them the offsets move by up to
        # 2^-7 px here, and rounded to bf16 after the fact by up to 2^-8
        f32 = t_ali_offsets(torch.from_numpy(
            shape).bfloat16().float(), ks).numpy()
        assert np.abs(f32 - np.asarray(want)).max() > 1e-3


def _bank_params(rng, ks, ada):
    """Flax parameters of one FCB bank (numpy): offsets of a few pixels
    (some past the training window), a unit-gain deformable kernel."""
    kh, kw = ks
    p = {'adaption_kernel': rng.randn(kh, kw, CIN, CIN) / np.sqrt(
        kh * kw * CIN),
         'conv': {'kernel': rng.randn(kh, kw, CIN, COUT) / np.sqrt(
             kh * kw * CIN), 'bias': rng.randn(COUT) * 0.1}}
    if ada:
        p['conv_offset'] = {'kernel': rng.randn(1, 1, 4, 2 * kh * kw) * 0.8}
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


def _port_bank(params, ks, ada):
    bank = TFeatureAlign(CIN, COUT, ks, ada, RADIUS)
    sd = {'conv_adaption.weight': params['adaption_kernel'].transpose(
              3, 2, 0, 1),
          'conv.weight': params['conv']['kernel'].transpose(3, 2, 0, 1),
          'conv.bias': params['conv']['bias']}
    if ada:
        sd['conv_offset.weight'] = params['conv_offset'][
            'kernel'].transpose(3, 2, 0, 1)
    bank.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}, strict=True)
    return bank


def _bank_inputs(rng, hw):
    h, w = hw
    x = rng.randn(2, h, w, CIN).astype(np.float32)
    shape = (rng.randn(2, h, w, 4) * 1.5).astype(np.float32)
    cot = rng.randn(2, h, w, COUT).astype(np.float32)
    return x, shape, cot


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize('ks', KSIZES)
@pytest.mark.parametrize('mode', ['ada', 'ali'])
def test_feature_align_eval_matches_flax(mode, ks):
    """The exact gather (no clamp): output to 2e-6 of max|ref|."""
    ada = mode == 'ada'
    rng = np.random.RandomState(len(mode) + ks[1])
    params = _bank_params(rng, ks, ada)
    jmod = JFeatureAlign(COUT, ks, use_pred_offset=ada, window_radius=RADIUS)
    bank = _port_bank(params, ks, ada).eval()
    for hw in LEVELS:
        x, shape, _ = _bank_inputs(rng, hw)
        want = jmod.apply({'params': params}, jnp.asarray(x),
                          jnp.asarray(shape), train=False)
        with torch.no_grad():
            got = bank(_nchw(x), _nchw(shape), train=False)
        _close(got.permute(0, 2, 3, 1).numpy(), want, 2e-6,
               f'{mode} {ks} {hw}')


@pytest.mark.parametrize('ks', KSIZES)
@pytest.mark.parametrize('mode', ['ada', 'ali'])
def test_feature_align_train_matches_jax_grad(mode, ks):
    """The window op at radius 2 (training): the output, d_x, and the
    gradients of ``adaption_kernel``, ``conv`` and (ada) ``conv_offset``
    against ``jax.grad``, each to 2e-6 of max|ref|; no gradient reaches
    the box regression (it is detached)."""
    ada = mode == 'ada'
    rng = np.random.RandomState(3 * len(mode) + ks[0])
    params = _bank_params(rng, ks, ada)
    jmod = JFeatureAlign(COUT, ks, use_pred_offset=ada, window_radius=RADIUS)
    for hw in (TRAIN_LEVEL[ks],):
        x, shape, cot = _bank_inputs(rng, hw)

        def loss(p, xx, ss):
            out = jmod.apply({'params': p}, xx, ss, train=True)
            return jnp.sum(out * cot), out

        (_, want), (g_p, g_x, g_s) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                params, jnp.asarray(x), jnp.asarray(shape))
        bank = _port_bank(params, ks, ada)
        tx = _nchw(x).requires_grad_(True)
        ts = _nchw(shape).requires_grad_(True)
        out = bank(tx, ts, train=True)
        (out * _nchw(cot)).sum().backward()
        tag = f'{mode} {ks} {hw}'
        _close(out.detach().permute(0, 2, 3, 1).numpy(), want, 2e-6,
               f'out {tag}')
        _close(tx.grad.permute(0, 2, 3, 1).numpy(), g_x, 2e-6, f'd_x {tag}')
        assert ts.grad is None and float(np.abs(g_s).max()) == 0.0
        _close(bank.conv_adaption.weight.grad.permute(2, 3, 1, 0).numpy(),
               g_p['adaption_kernel'], 2e-6, f'd_adaption_kernel {tag}')
        _close(bank.conv.weight.grad.permute(2, 3, 1, 0).numpy(),
               g_p['conv']['kernel'], 2e-6, f'd_conv {tag}')
        _close(bank.conv.bias.grad.numpy(), g_p['conv']['bias'], 2e-6,
               f'd_conv_bias {tag}')
        if ada:
            g_off = g_p['conv_offset']['kernel']
            assert float(np.abs(g_off).max()) > 0
            _close(bank.conv_offset.weight.grad.permute(2, 3, 1, 0).numpy(),
                   g_off, 2e-6, f'd_conv_offset {tag}')


@pytest.mark.parametrize('ks', KSIZES)
@pytest.mark.parametrize('mode', ['ada', 'ali'])
def test_feature_align_bf16_matches_flax_cast_params(mode, ks):
    """bf16 eval against flax with ``cast_params`` on the same weights and
    bf16 inputs: ada's offsets are bf16 (a bf16 1x1 conv), ali's float32 in
    both packages.  The bank's output is held to twice JAX's own
    bf16-vs-fp32 gap (the rule of ``test_torch_eval_bf16.py``: the final
    bf16 convolutions sum in another order).  For ali the deformable conv
    itself is held to JAX's ``deform_conv2d`` on JAX's offsets: at most 1%
    of the values differ, by one bf16 rounding (2^-8 of the value); the
    control, the same conv at the offsets rounded to bf16, must differ in
    more than 10%."""
    from stmask_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d

    from stmask_torch.kernels.deform_conv import deform_conv

    ada = mode == 'ada'
    rng = np.random.RandomState(17 + len(mode) + ks[1])
    params = _bank_params(rng, ks, ada)
    jmod = JFeatureAlign(COUT, ks, use_pred_offset=ada, window_radius=RADIUS)
    bank = cast_model(_port_bank(params, ks, ada), torch.bfloat16).eval()
    p16 = cast_params({'params': params}, jnp.bfloat16)
    for hw in LEVELS:
        x, shape, _ = _bank_inputs(rng, hw)
        xj, sj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(shape, jnp.bfloat16)
        ref32 = np.asarray(jmod.apply({'params': params}, jnp.asarray(x),
                                      jnp.asarray(shape), train=False))
        ref16 = jmod.apply(p16, xj, sj, train=False)
        assert ref16.dtype == jnp.bfloat16
        ref16 = np.asarray(ref16, np.float32)
        gap = np.abs(ref16 - ref32).max()
        xb, sb = _nchw(x).bfloat16(), _nchw(shape).bfloat16()
        with torch.no_grad():
            got = bank(xb, sb, train=False)
        assert got.dtype == torch.bfloat16
        d = np.abs(got.float().permute(0, 2, 3, 1).numpy() - ref16).max()
        assert 0 < gap and d <= 2 * gap, (hw, d, gap)
        if ada:
            continue
        j_off = j_ali_offsets(sj, ks)
        want = np.asarray(j_deform_conv2d(
            xj, j_off, p16['params']['adaption_kernel']), np.float32)
        t_off = t_ali_offsets(sb.permute(0, 2, 3, 1), ks)
        assert t_off.dtype == torch.float32
        np.testing.assert_array_equal(t_off.numpy(), np.asarray(j_off))
        w = bank.conv_adaption.weight.permute(0, 2, 3, 1).contiguous()
        xh = xb.permute(0, 2, 3, 1).contiguous()
        for off, most in ((t_off, 0.01), (t_off.bfloat16(), None)):
            with torch.no_grad():
                al = deform_conv(xh, off, w, None, None).float().numpy()
            diff = np.abs(al - want)
            share = float((diff > 0).mean())
            if most is None:              # the control: rounded offsets
                assert share > 0.1, (hw, share)
                continue
            assert share <= most, (hw, share)
            assert (diff <= 2.0 ** -8 * np.abs(want)).all(), (hw,
                                                               diff.max())


def test_init_flax_draws_fcb_as_flax():
    """``init_flax`` on the _ada model's FCB banks against flax's own init
    of ``FeatureAlign`` at the same widths: ``conv_offset`` zero,
    ``adaption_kernel`` a plain normal of std 0.01 (spread within 5%, and
    not truncated: values past 2.5 std), ``conv`` LeCun-normal truncated
    at 2 std (spread within 10% of flax's) with a zero bias."""
    import dataclasses

    from stmask_torch.config import get_config
    from stmask_torch.models import STMask
    from stmask_torch.models.stmask import init_flax

    cfg = get_config('STMask_plus_resnet50_ada')
    cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                   layers=(1, 1, 1, 1)))
    model = init_flax(STMask(cfg), torch.Generator().manual_seed(0))
    head = model.prediction_layers[0]
    for k, ks in enumerate(cfg.head_kernel_sizes):
        jmod = JFeatureAlign(cfg.num_classes, ks, use_pred_offset=True)
        want = jax.tree_util.tree_map(np.asarray, jmod.init(
            jax.random.PRNGKey(k), jnp.zeros((1, 4, 6, 256)),
            jnp.zeros((1, 4, 6, 4)))['params'])
        bank = head.conf_layer[k]
        assert float(bank.conv_offset.weight.abs().max()) == 0.0
        assert float(np.abs(want['conv_offset']['kernel']).max()) == 0.0
        got_a = bank.conv_adaption.weight.detach().numpy()
        want_a = want['adaption_kernel']
        assert got_a.shape == want_a.transpose(3, 2, 0, 1).shape
        for a in (got_a, want_a):
            assert abs(a.std() / 0.01 - 1) < 0.05
            assert np.abs(a).max() > 2.5 * 0.01
        got_c = bank.conv.weight.detach().numpy()
        want_c = want['conv']['kernel']
        assert abs(got_c.std() / want_c.std() - 1) < 0.10
        bound = 1.1 * 2 / 0.87962566103423978 * float(want_c.std())
        assert np.abs(got_c).max() <= bound
        assert np.abs(want_c).max() <= bound
        assert float(bank.conv.bias.abs().max()) == 0.0
