"""The port's NMS family (``stmask_torch/ops/nms.py``, kernel B5's plain
version, ``inference/candidates.py::detect_frame``) against the JAX
package's, on the same numpy inputs.

Indices, validity, classes and keep masks must be equal exactly; scores
within 1e-6 (they are gathered, not computed, so they are equal too).
The JAX functions run under ``jax.jit``, as the JAX package's video steps
run them (and a jitted function compiles once: eager JAX compiles every
op apart).  B5 itself is held against its plain version on the card in
``tests/test_torch_kernels_cuda.py``.
"""

import types


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.inference import candidates as JC
from stmask_tpu.ops import nms as _JN
from stmask_tpu.ops.boxes import encode as j_encode

from stmask_torch.config import get_config as t_get_config
from stmask_torch.inference import candidates as TC
from stmask_torch.kernels.greedy_nms import greedy_nms_mask_reference
from stmask_torch.ops import nms as TN

from torch_eval_common import TCFG
from torch_eval_common import few_torch_threads  # noqa: F401

_STATIC = ('iou_threshold', 'top_k', 'conf_thresh', 'max_dets', 'scale',
           'mask_fn')


def _jit(fn):
    import inspect
    names = [n for n in inspect.signature(fn).parameters if n in _STATIC]
    return jax.jit(fn, static_argnames=names)


JN = types.SimpleNamespace(NEG_INF=_JN.NEG_INF, **{
    name: _jit(getattr(_JN, name)) for name in (
        'cc_fast_nms', 'mask_iou_matrix', 'fast_nms', 'greedy_nms_mask',
        '_plus_one_iou', 'greedy_nms_per_class')})
j_detect_frame = jax.jit(JC.detect_frame, static_argnums=(0,))


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(port, ref, what=''):
    """Every field equal: integers and bools exactly, floats within 1e-6."""
    for name, p, r in zip(ref._fields, port, ref):
        p, r = p.numpy(), np.asarray(r)
        assert p.shape == r.shape, (what, name)
        if r.dtype.kind in 'biu':
            np.testing.assert_array_equal(p, r, err_msg=f'{what} {name}')
        else:
            np.testing.assert_allclose(p, r, rtol=0, atol=1e-6,
                                       err_msg=f'{what} {name}')


def _boxes(rng, n, lo=0.05, hi=0.35):
    a = rng.rand(n, 2).astype(np.float32) * 0.6
    wh = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    return np.concatenate([a, a + wh], axis=1).astype(np.float32)


def _clustered(rng, n, centers=6):
    """Boxes around a few centres, so that suppression chains form."""
    c = _boxes(rng, centers)
    pick = rng.randint(0, centers, n)
    return (c[pick] + rng.randn(n, 4).astype(np.float32) * 0.03
            ).astype(np.float32)


# ---- each ported function of ops/nms.py -----------------------------------

def test_mask_iou_matrix():
    rng = np.random.RandomState(0)
    m = (rng.rand(12, 7 * 9) < 0.4).astype(np.float32)
    m[3] = 0.0                             # an empty mask: union clamped
    m[5] = m[2]                            # identical masks: IoU 1
    port = TN.mask_iou_matrix(_t(m)).numpy()
    ref = np.asarray(JN.mask_iou_matrix(jnp.asarray(m)))
    np.testing.assert_array_equal(port, ref)
    assert port[2, 5] == 1.0 and port[3, 3] == 0.0


@pytest.mark.parametrize('n', [40, 7])     # 7 < top_k: padded candidates
def test_cc_fast_nms_mask_blend(n):
    rng = np.random.RandomState(1)
    bx = _clustered(rng, n)
    sc = np.round(rng.rand(n), 1).astype(np.float32)   # exact ties
    sc[::5] = TN.NEG_INF
    masks = (rng.rand(n, 6, 8) < 0.5).astype(np.float32)
    masks[1::3] = masks[0]             # equal masks: blend still suppresses
    port = TN.cc_fast_nms(_t(bx), _t(sc), 0.5, top_k=20,
                          mask_fn=lambda idx: _t(masks)[idx])
    ref = JN.cc_fast_nms(jnp.asarray(bx), jnp.asarray(sc), 0.5, top_k=20,
                         mask_fn=lambda idx: jnp.asarray(masks)[idx])
    _same(port, ref, 'cc + mask blend')


@pytest.mark.parametrize('n,conf', [(300, 0.05), (7, 0.05), (60, 1.0)])
def test_fast_nms(n, conf):
    """Tied scores, fewer candidates than top_k (7: padded), a class whose
    scores all fail the threshold, and every class failing (1.0)."""
    rng = np.random.RandomState(2)
    bx = _clustered(rng, n)
    sc = np.round(rng.rand(5, n), 1).astype(np.float32)
    sc[2] = 0.01                                       # all invalid
    port = TN.fast_nms(_t(bx), _t(sc), 0.5, top_k=32, conf_thresh=conf,
                       max_dets=24)
    ref = JN.fast_nms(jnp.asarray(bx), jnp.asarray(sc), 0.5, top_k=32,
                      conf_thresh=conf, max_dets=24)
    _same(port, ref, 'fast_nms')
    assert bool(port.valid.any()) == (conf < 1.0)


def test_plus_one_iou():
    rng = np.random.RandomState(3)
    bx = _clustered(rng, 50) * 640.0
    port = TN._plus_one_iou(_t(bx)).numpy()
    ref = np.asarray(JN._plus_one_iou(jnp.asarray(bx)))
    np.testing.assert_array_equal(port, ref)
    batched = TN._plus_one_iou(_t(np.stack([bx, bx[::-1]]))).numpy()
    np.testing.assert_array_equal(batched[0], ref)


@pytest.mark.parametrize('k', [1, 30, 64, 65])
def test_greedy_nms_mask(k):
    rng = np.random.RandomState(4 + k)
    bx = _clustered(rng, k, centers=3)
    valid = rng.rand(k) < 0.8
    for iou in (None, JN._plus_one_iou(jnp.asarray(bx * 640.0))):
        ref = JN.greedy_nms_mask(jnp.asarray(bx), jnp.asarray(valid), 0.3,
                                 iou=iou)
        port = TN.greedy_nms_mask(
            _t(bx), _t(valid), 0.3,
            iou=None if iou is None else _t(np.asarray(iou)))
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    none = TN.greedy_nms_mask(_t(bx), _t(np.zeros(k, bool)), 0.3)
    assert not none.any()                      # an all-invalid row


@pytest.mark.parametrize('n', [500, 7])
def test_greedy_nms_per_class(n):
    rng = np.random.RandomState(5)
    bx = _clustered(rng, n, centers=8)
    sc = np.round(rng.rand(6, n), 2).astype(np.float32)
    sc[4] = 0.0                                        # all invalid
    port = TN.greedy_nms_per_class(_t(bx), _t(sc), 0.5, 0.05, top_k=200,
                                   max_dets=100, scale=640.0)
    ref = JN.greedy_nms_per_class(jnp.asarray(bx), jnp.asarray(sc), 0.5,
                                  0.05, top_k=200, max_dets=100, scale=640.0)
    _same(port, ref, 'greedy_nms_per_class')


# ---- B5's plain version against a numpy loop ------------------------------

def _numpy_greedy(iou, valid, thr):
    keep = np.zeros_like(valid)
    for g in range(iou.shape[0]):
        removed = ~valid[g].copy()
        for i in range(iou.shape[1]):
            if removed[i]:
                continue
            later = np.arange(iou.shape[1]) > i
            removed |= later & (iou[g, i] > thr)
        keep[g] = ~removed & valid[g]
    return keep


@pytest.mark.parametrize('g,k', [(3, 1), (5, 40), (2, 130)])
def test_greedy_reference_against_numpy_loop(g, k):
    """Random symmetric IoU, chains (i suppresses i + 1, which would have
    suppressed i + 2), values at the threshold, an all-invalid group."""
    rng = np.random.RandomState(6 + k)
    iou = rng.rand(g, k, k).astype(np.float32)
    iou = np.maximum(iou, iou.transpose(0, 2, 1))
    iou[:, np.arange(k - 2), np.arange(2, k)] = 0.1
    iou[:, np.arange(k - 1), np.arange(1, k)] = 0.9
    iou[0, 0, -1] = 0.5                        # equal to thr: not above
    valid = rng.rand(g, k) < 0.85
    valid[-1] = False
    port = greedy_nms_mask_reference(_t(iou), _t(valid), 0.5).numpy()
    np.testing.assert_array_equal(port, _numpy_greedy(iou, valid, 0.5))


# ---- the hand-made cases of tests/test_matcher_nms.py:152-361 --------------

class _Lib:
    def __init__(self, jax_side):
        self.jax = jax_side
        self.nms = JN if jax_side else TN

    def arr(self, a):
        return jnp.asarray(a) if self.jax else _t(np.asarray(a))


def _multiclass_fixture():
    boxes = np.array([[0.10, 0.10, 0.40, 0.40],
                      [0.12, 0.11, 0.41, 0.42],
                      [0.60, 0.55, 0.90, 0.92]], np.float32)
    scores = np.array([[0.90, 0.10, 0.05],
                       [0.20, 0.85, 0.80],
                       [0.02, 0.02, 0.03]], np.float32)
    return boxes, scores


def _case_greedy_exact(lib):
    boxes = np.asarray([[0.0, 0.0, 0.4, 0.4], [0.05, 0.05, 0.45, 0.45],
                        [0.06, 0.06, 0.46, 0.46], [0.7, 0.7, 0.9, 0.9]],
                       np.float32)
    keep = lib.nms.greedy_nms_mask(lib.arr(boxes), lib.arr(np.ones(4, bool)),
                                   0.5)
    # B loses to A; iou(A, C) = 0.1156 / 0.2044 = 0.566 > 0.5: C too
    return {'keep': keep}, lambda o: o['keep'].tolist() == [True, False,
                                                             False, True]


def _case_per_class_duplicates(lib):
    boxes, scores = _multiclass_fixture()
    cc = lib.nms.cc_fast_nms(lib.arr(boxes), lib.arr(scores.max(0)), 0.5,
                             top_k=3)
    pc = lib.nms.fast_nms(lib.arr(boxes), lib.arr(scores), 0.5, top_k=3,
                          conf_thresh=0.05, max_dets=8)
    out = {'cc_valid': cc.valid, 'pc_idx': pc.idx, 'pc_cls': pc.classes,
           'pc_valid': pc.valid, 'pc_scores': pc.scores}
    return out, lambda o: (o['cc_valid'].sum() == 2
                           and sorted(o['pc_cls'][o['pc_valid']])
                           == [1, 2, 2])


def _case_greedy_matches_fast_separated(lib):
    boxes, scores = _multiclass_fixture()
    f = lib.nms.fast_nms(lib.arr(boxes), lib.arr(scores), 0.5, top_k=3,
                         conf_thresh=0.05, max_dets=8)
    g = lib.nms.greedy_nms_per_class(lib.arr(boxes), lib.arr(scores), 0.5,
                                     conf_thresh=0.05, top_k=3, max_dets=8,
                                     scale=640.0)
    out = {'f_idx': f.idx, 'f_valid': f.valid, 'g_idx': g.idx,
           'g_valid': g.valid, 'g_cls': g.classes}
    return out, lambda o: (o['f_idx'][o['f_valid']].tolist()
                           == o['g_idx'][o['g_valid']].tolist())


def _case_greedy_chain(lib):
    boxes = np.array([[0.0, 0.0, 0.50, 1.0], [0.25, 0.0, 0.75, 1.0],
                      [0.50, 0.0, 1.00, 1.0]], np.float32)
    scores = np.array([[0.9, 0.8, 0.7]], np.float32)
    f = lib.nms.fast_nms(lib.arr(boxes), lib.arr(scores), 0.3, top_k=3,
                         conf_thresh=0.05, max_dets=4)
    g = lib.nms.greedy_nms_per_class(lib.arr(boxes), lib.arr(scores), 0.3,
                                     conf_thresh=0.05, top_k=3, max_dets=4,
                                     scale=640.0)
    out = {'f_valid': f.valid, 'g_idx': g.idx, 'g_valid': g.valid}
    return out, lambda o: (o['f_valid'].sum() == 1
                           and sorted(o['g_idx'][o['g_valid']]) == [0, 2])


def _case_miou_blend(lib):
    boxes = np.array([[0.1, 0.1, 0.9, 0.9]] * 2, np.float32)
    masks = np.zeros((2, 8, 8), np.float32)
    masks[0, :, :4] = 1.0
    masks[1, :, 4:] = 1.0
    sc = lib.arr(np.array([0.9, 0.8], np.float32))
    plain = lib.nms.cc_fast_nms(lib.arr(boxes), sc, 0.5, top_k=2)
    blend = lib.nms.cc_fast_nms(lib.arr(boxes), sc, 0.5, top_k=2,
                                mask_fn=lambda idx: lib.arr(masks)[idx])
    return ({'plain': plain.valid, 'blend': blend.valid},
            lambda o: o['plain'].sum() == 1 and o['blend'].sum() == 2)


def _fixture_preds(cfg, rows):
    """Hand-made eval outputs on 40 equal priors: ``rows`` of (box, class
    scores (list over classes 1..), centerness)."""
    p = 40
    priors = np.tile(np.array([[0.5, 0.5, 0.5, 0.5]], np.float32), (p, 1))
    conf = np.zeros((p, cfg.num_classes), np.float32)
    conf[:, 0] = 1.0
    cent = np.ones((p, 1), np.float32)
    loc = np.zeros((p, 4), np.float32)
    for i, (box, cls_scores, c) in enumerate(rows):
        loc[i] = np.asarray(j_encode(jnp.asarray(box[None]),
                                     jnp.asarray(priors[i:i + 1])))[0]
        conf[i, 0] = 1.0 - sum(cls_scores)
        conf[i, 1:1 + len(cls_scores)] = cls_scores
        cent[i, 0] = c
    preds = {'loc': loc, 'conf': conf,
             'mask_coeff': np.zeros((p, 32), np.float32),
             'track': np.full((p, cfg.embed_dim), cfg.embed_dim ** -0.5,
                              np.float32),
             'centerness': cent}
    return preds, priors


def _detect(lib, name, preds, priors, **kw):
    if lib.jax:
        cfg = j_get_config(name).replace(img_w=128, img_h=96, **kw)
        return j_detect_frame(cfg, {k: jnp.asarray(v)
                                    for k, v in preds.items()},
                              jnp.asarray(priors))
    cfg = t_get_config(name).replace(img_w=128, img_h=96, **kw)
    return TC.detect_frame(cfg, {k: _t(v) for k, v in preds.items()},
                           _t(priors))


def _case_detect_dispatch(lib):
    boxes, scores = _multiclass_fixture()
    cfg = t_get_config('STMask_resnet50')
    preds, priors = _fixture_preds(
        cfg, [(boxes[i], list(scores[:, i]), 1.0) for i in range(3)])
    out = {}
    for m in ('cc', 'per_class', 'greedy'):
        det = _detect(lib, 'STMask_resnet50', preds, priors,
                      eval_nms_method=m)
        out[f'{m}_valid'], out[f'{m}_cls'] = det.valid, det.cls
        out[f'{m}_box'] = det.box
    return out, lambda o: [o[f'{m}_valid'].sum() for m in (
        'cc', 'per_class', 'greedy')] == [2, 3, 3]


def _case_per_class_centerness(lib):
    boxes = np.array([[0.10, 0.10, 0.40, 0.40],
                      [0.11, 0.10, 0.41, 0.41]], np.float32)
    cfg = t_get_config('STMask_plus_resnet50')
    preds, priors = _fixture_preds(cfg, [(boxes[0], [0.9], 0.1),
                                         (boxes[1], [0.6], 0.9)])
    out = {}
    for tf in (True, False):
        det = _detect(lib, 'STMask_plus_resnet50', preds, priors,
                      eval_nms_method='per_class',
                      temporal_fusion_module=tf)
        out[f'{tf}_valid'], out[f'{tf}_score'] = det.valid, det.score
        out[f'{tf}_box'] = det.box

    def check(o):
        w, r = o['True_score'][o['True_valid']], o['False_score'][
            o['False_valid']]
        return (len(w) == len(r) == 1 and abs(w[0] - 0.54) < 1e-5
                and abs(r[0] - 0.9) < 1e-5)
    return out, check


HAND_MADE = {'greedy_exact': _case_greedy_exact,
             'per_class_keeps_cross_class_duplicates':
                 _case_per_class_duplicates,
             'greedy_matches_fast_on_separated_boxes':
                 _case_greedy_matches_fast_separated,
             'greedy_sequential_chain': _case_greedy_chain,
             'cc_nms_as_miou_blending': _case_miou_blend,
             'detect_frame_nms_method_dispatch': _case_detect_dispatch,
             'per_class_weights_centerness_for_tf':
                 _case_per_class_centerness}


@pytest.mark.parametrize('name', sorted(HAND_MADE))
def test_hand_made_case(name):
    """The JAX tests' hand-made cases: the port's outputs equal JAX's, and
    they show what the JAX test asserts."""
    ref, check = HAND_MADE[name](_Lib(True))
    port, _ = HAND_MADE[name](_Lib(False))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    port = {k: v.numpy() for k, v in port.items()}
    for k in ref:
        if ref[k].dtype.kind == 'f':
            np.testing.assert_allclose(port[k], ref[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert check(ref) and check(port), name


# ---- detect_frame's three methods on the reduced flagship's predictions ----

@pytest.fixture(scope='module')
def flagship_preds():
    """One frame's eval outputs of the reduced flagship (the port's model
    with seeded ``init_random`` weights; test_torch_model_parity.py holds
    the model against flax)."""
    from stmask_torch.models import build_model
    model = build_model(TCFG, torch.device('cpu'), seed=3)
    rng = np.random.RandomState(7)
    x = rng.randn(1, TCFG.pad_h, TCFG.pad_w, 3).astype(np.float32)
    with torch.inference_mode():
        out = model(_t(x))
    keys = ('loc', 'conf', 'mask_coeff', 'track', 'centerness')
    preds = {k: out[k][0].numpy() for k in keys}
    from stmask_torch.ops.anchors import all_priors
    return preds, out['proto'][0].numpy(), all_priors(TCFG)


@pytest.mark.parametrize('method,kw', [
    ('per_class', {}), ('per_class', dict(temporal_fusion_module=False)),
    ('greedy', {}), ('cc', dict(nms_as_miou=True))])
def test_detect_frame_methods_on_model_outputs(flagship_preds, method, kw):
    preds, proto, priors = flagship_preds
    jcfg = j_get_config('STMask_plus_resnet50').replace(
        img_w=TCFG.img_w, img_h=TCFG.img_h, eval_nms_method=method, **kw)
    tcfg = TCFG.replace(eval_nms_method=method, **kw)
    ref = j_detect_frame(jcfg, {k: jnp.asarray(v) for k, v in preds.items()},
                         jnp.asarray(priors), proto=jnp.asarray(proto))
    port = TC.detect_frame(tcfg, {k: _t(v) for k, v in preds.items()},
                           _t(priors), proto=_t(proto))
    valid = np.asarray(ref.valid)
    assert valid.sum() >= 5, valid.sum()
    np.testing.assert_array_equal(port.valid.numpy(), valid)
    np.testing.assert_array_equal(port.cls.numpy()[valid],
                                  np.asarray(ref.cls)[valid])
    # gathered rows equal exactly <=> the same prior indices were picked
    for name in ('mask_coeff', 'track', 'centerness'):
        np.testing.assert_array_equal(getattr(port, name).numpy()[valid],
                                      np.asarray(getattr(ref, name))[valid],
                                      err_msg=name)
    for name in ('box', 'score'):        # decoded by each side: 1e-6
        np.testing.assert_allclose(getattr(port, name).numpy()[valid],
                                   np.asarray(getattr(ref, name))[valid],
                                   rtol=0, atol=1e-6, err_msg=name)
