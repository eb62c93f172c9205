"""The FC head with ``train_centerness`` or ``train_track`` off in the port
against the JAX package: the FCA head builds its centerness banks only
under ``train_centerness`` and keeps its track banks either way, and emits
``centerness`` and ``track`` only under their flags (JAX's
``models/heads.py:169-172``, ``:192-203``, ``:232-244``).

The reduced flagship of ``tests/torch_eval_common.py`` (96x128,
``layers=(1, 3, 3, 1)``) with each flag off: the eval forward against flax
(the model's neutral fill-ins where an output is off; the training
forward emits neither), then two frames of the eval video step against
JAX's forward, ``detect_frame`` and ``track_step_tf``
(``test_torch_backbones_step.py``'s comparison: ids, keep flags and
classes equal, boxes and scores within 1e-4).  With both off, one training
step against JAX's (``test_torch_train_step_parity.py``'s set-up and
tolerances, losses rtol 1e-4, gradients and updates 1e-2 of max|ref|, with
one bottleneck a stage, so that JAX compiles it in less time; the track
banks get no gradient, zero in both).  ``state_dict_from_flax`` maps a
flax tree without centerness banks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.convert import convert_state_dict
from stmask_tpu.inference import candidates as JC
from stmask_tpu.inference import tracker as JT
from stmask_tpu.models import STMask as JSTMask
from stmask_tpu.ops.anchors import all_priors as j_all_priors
from stmask_tpu.train.train_step import build_train_step as j_build_train_step

from stmask_torch.convert import state_dict_from_flax
from stmask_torch.inference import build_video_step as t_build_video_step
from stmask_torch.models import STMask as TSTMask
from stmask_torch.train.train_step import build_train_step as t_build_train_step

from test_torch_backbones_step import DECODE, _frames
from test_torch_train_step_parity import JCFG as JTRAIN
from test_torch_train_step_parity import TCFG as TTRAIN
from test_torch_train_step_parity import _batch, _close, _lecun
from torch_eval_common import JCFG, TCFG, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401

FLAGS = {'centerness_off': dict(train_centerness=False),
         'track_off': dict(train_track=False),
         'both_off': dict(train_centerness=False, train_track=False)}
# each output's tolerance (test_torch_backbones_extra.py's EVAL_TOL)
EVAL_TOL = dict(loc=2e-3, conf=1e-4, centerness=1e-4, mask_coeff=2e-3,
                track=1e-3, proto=2e-3, T2S_feat=2e-3, fpn_feat=2e-3)


def _forward_matches(jcfg, tcfg, seed):
    """The eval forward of the port and flax from one draw of parameters;
    returns (flax model, params, port model, jitted flax forward)."""
    jmodel, params = flax_params(seed, jcfg)
    head = params['params']['prediction_head']
    assert any(k.startswith('track_layer') for k in head)
    assert any(k.startswith('centerness_layer') for k in head) == \
        jcfg.train_centerness
    tmodel = port_model(params, tcfg)
    assert hasattr(tmodel.prediction_layers[0], 'centerness_layer') == \
        tcfg.train_centerness
    forward = jax.jit(lambda p, v: jmodel.apply(p, v, train=False))
    x = _frames(tcfg)[0][None]
    want = forward(params, jnp.asarray(x))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x))
    assert set(got) == set(want) == set(EVAL_TOL)
    for key, atol in EVAL_TOL.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=atol, err_msg=key)
    if not tcfg.train_centerness:
        assert bool((got['centerness'] == 1).all())
    if not tcfg.train_track:
        assert bool((got['track'] == 1 / tcfg.embed_dim ** 0.5).all())
    # the training forward emits each output only under its flag
    with torch.no_grad():
        train_out = tmodel(torch.from_numpy(np.stack([x[0], x[0]])[None]),
                           train=True)
    assert ('centerness' in train_out) == tcfg.train_centerness
    assert ('track' in train_out) == tcfg.train_track
    return jmodel, params, tmodel, forward


@pytest.mark.parametrize('flags', ['centerness_off', 'track_off'])
def test_forward_and_eval_step_match_jax(flags):
    jcfg, tcfg = (c.replace(**FLAGS[flags]) for c in (JCFG, TCFG))
    jmodel, params, tmodel, forward = _forward_matches(jcfg, tcfg, 3)
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
    t_step, t_init = t_build_video_step(tcfg, tmodel, device='cpu')
    t_state = t_init()
    n_det = 0
    for f, x in enumerate(_frames(tcfg)):
        n, (j_state, j_out) = detect_track(
            j_state, forward(params, jnp.asarray(x[None])),
            jnp.asarray(f == 0))
        t_state, t_out = t_step(t_state, torch.from_numpy(x), f == 0)
        for field in ('obj_id', 'keep', 'cls'):
            np.testing.assert_array_equal(
                getattr(t_out, field).numpy(),
                np.asarray(getattr(j_out, field)),
                err_msg=f'{flags} frame {f} {field}')
        for field in ('box', 'score'):
            np.testing.assert_allclose(
                getattr(t_out, field).numpy(),
                np.asarray(getattr(j_out, field)), rtol=0, atol=1e-4,
                err_msg=f'{flags} frame {f} {field}')
        n_det += int(n)
    np.testing.assert_array_equal(t_state.valid.numpy(),
                                  np.asarray(j_state.valid))
    assert n_det >= 5 and int(t_state.next_id) > 0, n_det


def test_both_off_train_step_matches_jax():
    jcfg, tcfg = (c.replace(backbone=dataclasses.replace(
        c.backbone, layers=(1, 1, 1, 1)), **FLAGS['both_off'])
        for c in (JTRAIN, TTRAIN))
    zeros = jax.tree_util.tree_map(np.asarray, convert_state_dict(
        TSTMask(tcfg).state_dict())['params'])
    params = {'params': _lecun(zeros, np.random.RandomState(1))}
    batch = _batch(jcfg)
    j_step, j_init = j_build_train_step(jcfg, JSTMask(jcfg))
    j_state, j_metrics = j_step(j_init(params),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    j_new = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, j_state.params), include_bn=False)

    model = TSTMask(tcfg)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    t_step, t_init = t_build_train_step(tcfg, model, device='cpu')
    _, metrics = t_step(t_init(), {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    assert 'center' not in metrics and 'T' not in metrics
    assert set(metrics) == {k for k in j_metrics}
    for k in ('BIoU', 'C', 'M', 'B_shift', 'M_shift', 'total', 'gnorm'):
        assert np.isfinite(float(metrics[k])), k
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=1e-4, err_msg=k)
    lr = float(j_metrics['lr'])
    named = dict(model.named_parameters())
    assert set(named) == set(j_new)
    assert any('.track_layer.' in k for k in named)
    assert not any('centerness' in k for k in named)
    for k, p in named.items():
        p0 = before[k].numpy()
        j_update = j_new[k].numpy() - p0
        j_grad = -j_update / lr - tcfg.decay * p0
        grad = np.zeros_like(p0) if p.grad is None else p.grad.numpy()
        _close(grad, j_grad, f'grad {k}')
        _close(p.detach().numpy() - p0, j_update, f'update {k}')
        if '.track_layer.' in k:
            assert not np.any(grad), k


def test_state_dict_from_flax_without_centerness_banks():
    """A flax tree without ``centerness_layer_*`` maps onto the port's model
    with the flag off, strictly, and misses exactly those banks for a
    model with it on."""
    off = TCFG.replace(train_centerness=False)
    _, params = flax_params(0, JCFG.replace(train_centerness=False))
    sd = state_dict_from_flax(params)
    assert not any('centerness' in k for k in sd)
    TSTMask(off).load_state_dict(sd, strict=True)
    missing, unexpected = TSTMask(TCFG).load_state_dict(sd, strict=False)
    assert not unexpected
    assert missing and all('.centerness_layer.' in k for k in missing)
    assert len(missing) == 2 * len(TCFG.head_kernel_sizes)
