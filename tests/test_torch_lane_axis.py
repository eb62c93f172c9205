"""The eval path's lane axis (``detect_frame_lanes``,
``track_step_tf_lanes``, ``track_step_simple_lanes``) against the per-lane
functions applied lane by lane to the same inputs, on the reduced flagship
and legacy presets at 96x128 (``tests/torch_eval_common.py``).

Detections: one case per NMS family over 3 lanes whose predictions differ
(tied rows and tied classes included); the gathered rows and classes are
equal, scores within 1e-6.  Trackers: 3 lanes over 3 frames with a
per-lane ``is_first`` (lane 1 starts a new video at frame 2, lane 2's
frames hold no detection after the first); every field of the state and of
the output equal, floats within 1e-5 (the lanes' TemporalNet runs over
[3 * S] pooled boxes instead of [S]).  The per-lane functions are held
against the JAX package in ``tests/test_torch_tracker_parity.py``,
``test_torch_nms.py`` and ``test_torch_legacy.py``.
"""

import numpy as np
import pytest
import torch

from stmask_torch.inference import candidates as TC
from stmask_torch.inference import tracker as TT
from stmask_torch.ops.anchors import all_priors

from torch_eval_common import TCFG, TLEG
from torch_eval_common import few_torch_threads  # noqa: F401

B = 3
D, E, CH = 16, 128, 16
FEAT, PROTO = (6, 8), (24, 32)
NMS_CASES = {'cc': dict(eval_nms_method='cc'),
             'cc_miou': dict(eval_nms_method='cc', nms_as_miou=True),
             'per_class': dict(eval_nms_method='per_class'),
             'greedy': dict(eval_nms_method='greedy')}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _preds(rng, cfg, n_peaked):
    """One frame's predictions with ``n_peaked`` peaked rows, 30 rows tied
    with the first of them and a tied class argmax."""
    p = cfg.num_priors
    logits = rng.randn(p, cfg.num_classes).astype(np.float32) * 0.05
    peaked = rng.choice(p, n_peaked, replace=False)
    logits[peaked] *= 80
    logits[100:130] = logits[peaked[0]]
    logits[5] = 0.0
    logits[5, 7] = logits[5, 9] = 8.0
    conf = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    cent = np.tanh(rng.randn(p, 1)).astype(np.float32)
    cent[100:130] = cent[100]
    return {'loc': (rng.randn(p, 4) * 0.5).astype(np.float32),
            'conf': conf.astype(np.float32),
            'mask_coeff': rng.randn(p, 32).astype(np.float32),
            'track': _unit(rng.randn(p, E)),
            'centerness': cent}


@pytest.mark.parametrize('family', list(NMS_CASES))
def test_detect_lanes_match_per_lane(family):
    cfg = TCFG.replace(**NMS_CASES[family])
    rng = np.random.RandomState(7)
    lanes = [_preds(rng, cfg, n) for n in (12, 40, 160)]
    protos = np.maximum(rng.randn(B, *PROTO, 32), 0).astype(np.float32)
    priors = _t(all_priors(cfg))
    got = TC.detect_frame_lanes(
        cfg, {k: _t(np.stack([ln[k] for ln in lanes])) for k in lanes[0]},
        priors, proto=_t(protos))
    assert got.box.shape == (B, min(cfg.det_capacity, cfg.nms_top_k), 4)
    n_valid = []
    for b, ln in enumerate(lanes):
        want = TC.detect_frame(cfg, {k: _t(v) for k, v in ln.items()},
                               priors, proto=_t(protos[b]))
        for name in ('valid', 'cls', 'box', 'mask_coeff', 'track',
                     'centerness'):
            # gathered rows equal exactly <=> the same prior indices
            torch.testing.assert_close(getattr(got, name)[b],
                                       getattr(want, name), rtol=0, atol=0,
                                       msg=f'lane {b} {name}')
        torch.testing.assert_close(got.score[b], want.score, rtol=0,
                                   atol=1e-6)
        n_valid.append(int(want.valid.sum()))
    assert min(n_valid) > 4 and len(set(n_valid)) > 1, n_valid


def _dets(rng, n_valid, copies=()):
    """Fabricated score-sorted detections (numpy); ``copies`` are (row,
    fields) pairs overwritten with fields of earlier detections."""
    a = rng.uniform(0.05, 0.6, (D, 2))
    box = np.concatenate([a, a + rng.uniform(0.15, 0.35, (D, 2))], 1)
    d = dict(box=box.astype(np.float32),
             score=np.sort(rng.uniform(0.1, 0.95, D))[::-1].astype(
                 np.float32),
             cls=rng.randint(1, 41, D).astype(np.int64),
             mask_coeff=(rng.randn(D, 32) * 2).astype(np.float32),
             track=_unit(rng.randn(D, E)),
             centerness=rng.uniform(0.2, 1.0, D).astype(np.float32),
             valid=np.arange(D) < n_valid)
    for dst, fields in copies:
        for k, v in fields.items():
            d[k][dst] = v
    return d


def _row(d, i, dy):
    r = {k: d[k][i].copy() for k in ('box', 'cls', 'mask_coeff', 'track')}
    r['box'] = (r['box'] + dy).astype(np.float32)
    return r


def _lane_frames(seed):
    """3 frames of each lane: new objects, matches (and more objects than
    free slots in lane 0), then matches again; lane 1's third frame starts
    a new video, lane 2 sees no detection after its first frame."""
    rng = np.random.RandomState(seed)
    frames = []
    for b in range(B):
        f0 = _dets(rng, 9 + b)
        f1 = _dets(rng, (16, 12, 0)[b],
                   copies=[(i, _row(f0, i, 0.01)) for i in range(6)])
        f2 = _dets(rng, (11, 7, 0)[b],
                   copies=[(i, _row(f1, i + 1, 0.02)) for i in range(5)])
        frames.append([f0, f1, f2])
    first = np.array([[True] * B, [False] * B, [False, True, False]])
    return frames, first


def _stack_dets(dets):
    return TC.Detections(**{k: _t(np.stack([d[k] for d in dets]))
                            for k in dets[0]})


def _same(got, want, what):
    for name, g, w in zip(want._fields, got, want):
        if w.is_floating_point():
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5,
                                       msg=f'{what} {name}')
        else:
            assert torch.equal(g, w), (what, name)


def _net(rng):
    cc = 121 + 2 * CH
    w_reg = _t((rng.randn(cc, 4) * 0.2).astype(np.float32))
    w_coeff = _t((rng.randn(cc, 32) * 0.2).astype(np.float32))

    def fn(pooled):
        m = pooled.mean((1, 2))
        return m @ w_reg, m @ w_coeff
    return fn


@pytest.mark.parametrize('tracker', ['tf', 'simple'])
def test_track_lanes_match_per_lane(tracker):
    cfg = (TCFG if tracker == 'tf' else TLEG).replace(track_capacity=12,
                                                      shift_capacity=4,
                                                      det_capacity=D)
    rng = np.random.RandomState(11)
    net = _net(rng)
    frames, first = _lane_frames(12)
    lanes = TT.init_state(cfg, FEAT, PROTO, CH, E, lanes=B)
    singles = [TT.init_state(cfg, FEAT, PROTO, CH, E) for _ in range(B)]
    assert lanes.next_id.shape == (B,) and lanes.box.shape[:2] == (B, 12)
    shifted = 0
    for f in range(3):
        proto = np.maximum(rng.randn(B, *PROTO, 32), 0).astype(np.float32)
        fpn = rng.randn(B, *FEAT, CH).astype(np.float32)
        t2s = np.maximum(rng.randn(B, *FEAT, CH), 0).astype(np.float32)
        det = _stack_dets([frames[b][f] for b in range(B)])
        shifted += int((lanes.valid.sum(-1) > cfg.shift_capacity).sum())
        if tracker == 'tf':
            lanes, out = TT.track_step_tf_lanes(
                cfg, net, lanes, det, _t(proto), _t(fpn), _t(t2s),
                _t(first[f]))
        else:
            lanes, out = TT.track_step_simple_lanes(cfg, lanes, det,
                                                    _t(proto), _t(first[f]))
        for b in range(B):
            one = TC.Detections(*(x[b] for x in det))
            if tracker == 'tf':
                singles[b], want = TT.track_step_tf(
                    cfg, net, singles[b], one, _t(proto[b]), _t(fpn[b]),
                    _t(t2s[b]), bool(first[f, b]))
            else:
                singles[b], want = TT.track_step_simple(
                    cfg, singles[b], one, _t(proto[b]), bool(first[f, b]))
            _same(TT.TrackState(*(x[b] for x in lanes)), singles[b],
                  f'frame {f} lane {b} state')
            _same(type(out)(*(x[b] for x in out)), want,
                  f'frame {f} lane {b} output')
    # the reset lane restarted its ids, the others went on counting
    assert int(lanes.next_id[1]) == 7 and int(lanes.next_id[0]) >= 12
    assert int(out.keep.sum()) > 0
    if tracker == 'tf':
        assert shifted > 0
