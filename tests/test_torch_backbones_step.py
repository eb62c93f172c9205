"""The eval video step and the bf16 forward of ``STMask_resnet50_gn`` and
``STMask_darknet53`` in the port against the JAX package.

The presets and their parameters are tests/test_torch_backbones_extra.py's
(96x128, GN one bottleneck a stage, DarkNet's residual branches scaled).
Two frames go through the port's ``build_video_step`` and, on the JAX
side, through the model and then ``detect_frame`` and ``track_step_tf``
as the JAX video step composes them (two ``jax.jit`` programs: the
forward, and detect with track).  The tracker's outputs are held as
test_torch_model_parity.py holds the flagship's: ids, keep flags and
classes equal, boxes and scores within 1e-4.  The bf16 model is held
against flax under ``cast_params`` on the same bf16 frame, each output to
twice JAX's own bf16-vs-fp32 gap (tests/test_torch_eval_bf16.py's rule).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.inference import candidates as JC
from stmask_tpu.inference import tracker as JT
from stmask_tpu.inference.pipeline import cast_params
from stmask_tpu.models import STMask as JSTMask
from stmask_tpu.ops.anchors import all_priors as j_all_priors

from stmask_torch.inference import build_video_step as t_build_video_step
from stmask_torch.inference.pipeline import cast_model

from test_torch_backbones_extra import draw
from torch_eval_common import few_torch_threads  # noqa: F401

N_FRAMES = 2
DECODE = ('loc', 'conf', 'mask_coeff', 'track', 'centerness')


def _frames(cfg):
    """Normalized, padded float frames: a blocky image moving by a few
    pixels, so the second frame's tracks match the first's."""
    rng = np.random.RandomState(5)
    coarse = rng.randn(cfg.pad_h // 16 + 2, cfg.pad_w // 16 + 2, 3)
    base = np.kron(coarse, np.ones((16, 16, 1)))[:cfg.pad_h, :cfg.pad_w]
    return [np.roll(base + rng.randn(*base.shape) * 0.2, (2 * i, 3 * i),
                    axis=(0, 1)).astype(np.float32) for i in range(N_FRAMES)]


@pytest.fixture(scope='module', params=('STMask_resnet50_gn',
                                        'STMask_darknet53'))
def preset(request):
    jmodel, params, tmodel = draw(request.param)
    forward = jax.jit(lambda p, v: jmodel.apply(p, v, train=False))
    return request.param, jmodel, params, tmodel, forward


def test_eval_step_matches_jax(preset):
    name, jmodel, params, tmodel, forward = preset
    cfg = tmodel.cfg
    jcfg = jmodel.cfg
    priors = jnp.asarray(j_all_priors(jcfg))

    @jax.jit
    def detect_track(state, preds, first):
        det = JC.detect_frame(jcfg, {k: preds[k][0] for k in DECODE},
                              priors, proto=preds['proto'][0])
        return det.valid.sum(), JT.track_step_tf(
            jcfg, lambda v: jmodel.apply(params, v,
                                         method=JSTMask.temporal_shift),
            state, det, preds['proto'][0], preds['fpn_feat'][0],
            preds['T2S_feat'][0], first)

    j_state = JT.init_state(jcfg, jcfg.feature_shapes()[
        jcfg.correlation_selected_layer], (jcfg.pad_h // 4, jcfg.pad_w // 4),
        jcfg.fpn.num_features, jcfg.embed_dim)
    t_step, t_init = t_build_video_step(cfg, tmodel, device='cpu')
    t_state = t_init()
    n_det = n_kept = 0
    for f, x in enumerate(_frames(cfg)):
        n, (j_state, j_out) = detect_track(
            j_state, forward(params, jnp.asarray(x[None])),
            jnp.asarray(f == 0))
        t_state, t_out = t_step(t_state, torch.from_numpy(x), f == 0)
        for field in ('obj_id', 'keep', 'cls'):
            np.testing.assert_array_equal(
                getattr(t_out, field).numpy(),
                np.asarray(getattr(j_out, field)),
                err_msg=f'{name} frame {f} {field}')
        for field in ('box', 'score'):
            np.testing.assert_allclose(
                getattr(t_out, field).numpy(),
                np.asarray(getattr(j_out, field)), rtol=0, atol=1e-4,
                err_msg=f'{name} frame {f} {field}')
        n_det += int(n)
        n_kept += int(t_out.keep.sum())
    np.testing.assert_array_equal(t_state.valid.numpy(),
                                  np.asarray(j_state.valid))
    assert n_det >= 5 and n_kept > 0 and int(t_state.next_id) > 0, (
        n_det, n_kept)


def test_bf16_forward_matches_flax_cast_params(preset):
    name, jmodel, params, tmodel, forward = preset
    x = _frames(tmodel.cfg)[0][None]
    ref32 = forward(params, jnp.asarray(x))
    ref16 = jax.jit(lambda p, v: jmodel.apply(p, v, train=False))(
        cast_params(params, jnp.bfloat16),
        jnp.asarray(x).astype(jnp.bfloat16))
    model = cast_model(copy.deepcopy(tmodel), torch.bfloat16)
    with torch.inference_mode():
        out = model(torch.from_numpy(x).bfloat16())
    for key in ('loc', 'conf', 'centerness', 'mask_coeff', 'track', 'proto',
                'T2S_feat', 'fpn_feat'):
        r16 = np.asarray(ref16[key], np.float32)
        gap = np.abs(r16 - np.asarray(ref32[key], np.float32)).max()
        d = np.abs(out[key].float().numpy() - r16).max()
        print(f'{name} {key}: port bf16 vs JAX bf16 {d:.3e}, JAX bf16 vs '
              f'fp32 {gap:.3e}')
        assert 0 < gap and d <= 2 * gap, (key, d, gap)
