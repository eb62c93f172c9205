"""Detect and track stages of the port against the JAX package, stage by
stage, on the same numpy inputs (tie order, scatter forms, full banks,
empty frames and displaced matches included)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.inference import candidates as JC
from stmask_tpu.inference import tracker as JT
from stmask_tpu.ops.anchors import all_priors

from stmask_torch.config import get_config as t_get_config
from stmask_torch.inference import candidates as TC
from stmask_torch.inference import tracker as TT

KW = dict(img_h=96, img_w=128, track_capacity=12, shift_capacity=4,
          det_capacity=16)
JCFG = j_get_config('STMask_plus_resnet50').replace(**KW)
TCFG = t_get_config('STMask_plus_resnet50').replace(**KW)
D, T, E, CH = 16, 12, 128, 16
FEAT, PROTO = (6, 8), (24, 32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cmp_tuple(port, ref, atol=1e-5, what=''):
    for name, p, r in zip(ref._fields, port, ref):
        p, r = p.detach().numpy(), np.asarray(r)
        assert p.shape == r.shape, (what, name, p.shape, r.shape)
        if r.dtype.kind in 'biu':
            np.testing.assert_array_equal(p, r, err_msg=f'{what} {name}')
        else:
            np.testing.assert_allclose(p, r, atol=atol, err_msg=f'{what} '
                                       f'{name}')


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def test_detect_frame_with_ties():
    """Most priors fail the conf pre-filter; 30 identical rows tie exactly
    and one row ties two classes (det_capacity 100, so some slots stay
    invalid)."""
    jcfg, tcfg = (c.replace(det_capacity=100) for c in (JCFG, TCFG))
    rng = np.random.RandomState(0)
    p = jcfg.num_priors
    logits = rng.randn(p, jcfg.num_classes).astype(np.float32) * 0.05
    peaked = rng.choice(p, 80, replace=False)
    logits[peaked] *= 80
    logits[100:130] = logits[peaked[0]]    # identical rows: tied scores
    logits[5] = 0.0
    logits[5, 7] = logits[5, 9] = 8.0      # tied class argmax
    conf = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    cent = np.tanh(rng.randn(p, 1)).astype(np.float32)
    cent[100:130] = cent[100]
    preds = {'loc': rng.randn(p, 4).astype(np.float32),
             'conf': conf.astype(np.float32),
             'mask_coeff': rng.randn(p, 32).astype(np.float32),
             'track': _unit(rng.randn(p, E)),
             'centerness': cent}
    pri = all_priors(jcfg)
    ref = JC.detect_frame(jcfg, {k: jnp.asarray(v) for k, v in preds.items()},
                          jnp.asarray(pri))
    port = TC.detect_frame(tcfg, {k: _t(v) for k, v in preds.items()},
                           _t(pri))
    valid = np.asarray(ref.valid)
    assert valid.sum() > 4 and (~valid).sum() > 0
    np.testing.assert_array_equal(port.valid.numpy(), valid)
    np.testing.assert_array_equal(port.cls.numpy(), np.asarray(ref.cls))
    # gathered rows equal exactly <=> the same prior indices were picked
    np.testing.assert_array_equal(port.mask_coeff.numpy(),
                                  np.asarray(ref.mask_coeff))
    for name in ('box', 'score', 'track', 'centerness'):
        np.testing.assert_allclose(
            getattr(port, name).numpy()[valid],
            np.asarray(getattr(ref, name))[valid], atol=1e-5, err_msg=name)


def _dets(rng, n_valid, copies=()):
    """Fabricated score-sorted Detections (numpy); ``copies`` are
    (row, fields) pairs overwritten with fields of earlier detections."""
    a = rng.uniform(0.05, 0.6, (D, 2))
    box = np.concatenate([a, a + rng.uniform(0.15, 0.35, (D, 2))], 1)
    d = dict(box=box.astype(np.float32),
             score=np.sort(rng.uniform(0.1, 0.95, D))[::-1].astype(
                 np.float32),
             cls=rng.randint(1, 41, D).astype(np.int32),
             mask_coeff=(rng.randn(D, 32) * 2).astype(np.float32),
             track=_unit(rng.randn(D, E)),
             centerness=rng.uniform(0.2, 1.0, D).astype(np.float32),
             valid=np.arange(D) < n_valid)
    for dst, fields in copies:
        for k, v in fields.items():
            d[k][dst] = v
    return d


def _sequence():
    """4 frames: 10 new tracks; 16 dets with matches, a displaced duplicate
    and more new objects than free slots (full bank); an empty frame;
    matches displaced by 0.02 after the empty frame."""
    rng = np.random.RandomState(1)
    f0 = _dets(rng, 10)

    def row(d, i, dy=0.0):
        r = {k: d[k][i].copy() for k in ('box', 'cls', 'mask_coeff',
                                         'track')}
        r['box'] = (r['box'] + dy).astype(np.float32)
        return r

    f1 = _dets(rng, 16, copies=[(i, row(f0, i, 0.01)) for i in range(8)]
               + [(8, row(f0, 0, 0.012))])          # duplicate of det 0
    f2 = _dets(rng, 0)
    f3 = _dets(rng, 12, copies=[(i, row(f1, i + 2, 0.02)) for i in range(9)])
    return [f0, f1, f2, f3]


def _temporal_net(w_reg, w_coeff, lib):
    def fn(pooled):
        m = pooled.mean(axis=(1, 2)) if lib is jnp else pooled.mean((1, 2))
        return m @ w_reg, m @ w_coeff
    return fn


def test_track_step_tf_sequence():
    rng = np.random.RandomState(2)
    cc = 121 + 2 * CH
    w_reg = (rng.randn(cc, 4) * 0.2).astype(np.float32)
    w_coeff = (rng.randn(cc, 32) * 0.2).astype(np.float32)
    j_net = _temporal_net(jnp.asarray(w_reg), jnp.asarray(w_coeff), jnp)
    t_net = _temporal_net(_t(w_reg), _t(w_coeff), torch)

    j_state = JT.init_state(JCFG, FEAT, PROTO, CH, E)
    t_state = TT.init_state(TCFG, FEAT, PROTO, CH, E)
    seen_full = seen_shift = False
    for f, det in enumerate(_sequence()):
        proto = np.maximum(rng.randn(*PROTO, 32), 0).astype(np.float32)
        fpn = rng.randn(*FEAT, CH).astype(np.float32)
        t2s = np.maximum(rng.randn(*FEAT, CH), 0).astype(np.float32)
        seen_shift |= bool(np.asarray(j_state.valid).sum()
                           > TCFG.shift_capacity)
        j_state, j_out = JT.track_step_tf(
            JCFG, j_net, j_state,
            JC.Detections(**{k: jnp.asarray(v) for k, v in det.items()}),
            jnp.asarray(proto), jnp.asarray(fpn), jnp.asarray(t2s),
            jnp.asarray(f == 0))
        t_state, t_out = TT.track_step_tf(
            TCFG, t_net, t_state,
            TC.Detections(**{k: _t(v) for k, v in det.items()}),
            _t(proto), _t(fpn), _t(t2s), f == 0)
        _cmp_tuple(t_state, j_state, what=f'frame {f} state')
        _cmp_tuple(t_out, j_out, what=f'frame {f} output')
        seen_full |= bool(np.asarray(j_state.valid).all())
    assert seen_full and seen_shift
    assert int(np.asarray(j_state.next_id)) >= 12


@pytest.mark.parametrize('trial', range(4))
def test_resolve_assignment_fuzz(trial):
    """Random match ids with exact score ties, invalid dets and a bank
    with dead slots."""
    rng = np.random.RandomState(100 + trial)
    j_state = JT.init_state(JCFG, FEAT, PROTO, CH, E)
    n_prev = rng.randint(0, T + 1)
    valid = np.arange(T) < n_prev
    score = np.where(rng.rand(T) < 0.3, 0.01, 0.5).astype(np.float32)
    age = rng.randint(0, 15, T).astype(np.int32)
    j_state = j_state._replace(valid=jnp.asarray(valid),
                               score=jnp.asarray(score),
                               age=jnp.asarray(age))
    t_state = TT.init_state(TCFG, FEAT, PROTO, CH, E)._replace(
        valid=_t(valid), score=_t(score), age=_t(age.astype(np.int64)))
    match = rng.randint(0, n_prev + 1, D)
    det_valid = rng.rand(D) < 0.8
    det_scores = np.round(rng.rand(D), 1).astype(np.float32)
    ref = JT.resolve_assignment(JCFG, jnp.asarray(match.astype(np.int32)),
                                jnp.asarray(det_valid),
                                jnp.asarray(det_scores), j_state)
    port = TT.resolve_assignment(TCFG, _t(match.astype(np.int64)),
                                 _t(det_valid), _t(det_scores), t_state)
    _cmp_tuple(port, ref, what=f'trial {trial}')
