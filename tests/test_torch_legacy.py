"""The legacy YOLACT preset (``YOLACT_legacy_resnet50``: R50 without DCN,
the single-kernel head, no TF) in the port against the JAX package: its
priors, the model's eval outputs, the simple tracker and the video step.

The model runs reduced (one bottleneck a stage, 96x128; flax parameters
drawn in ``jax.eval_shape``'s shapes, tests/torch_eval_common.py).
Tolerances of the model outputs are those of test_torch_model_parity.py;
the tracker on the same inputs is held exactly (floats within 1e-5).  The
JAX side runs under ``jax.jit``, as its video steps run it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.inference import build_video_step as j_build_video_step
from stmask_tpu.inference import candidates as JC
from stmask_tpu.inference import postprocess_frame as j_postprocess
from stmask_tpu.inference import results2json_videoseg as j_results2json
from stmask_tpu.inference import tracker as JT
from stmask_tpu.models import legacy_head as JL
from stmask_tpu.ops import anchors as JA
from stmask_tpu.ops.boxes import mask_iou as j_mask_iou
from stmask_tpu.ops.masks import generate_mask as j_generate_mask

from stmask_torch.config import get_config as t_get_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.inference import build_video_step as t_build_video_step
from stmask_torch.inference import candidates as TC
from stmask_torch.inference import postprocess_frame as t_postprocess
from stmask_torch.inference import results2json_videoseg as t_results2json
from stmask_torch.inference import tracker as TT
from stmask_torch.models import STMask as TSTMask
from stmask_torch.models.stmask import init_flax, init_random
from stmask_torch.ops import anchors as TA

from torch_eval_common import JLEG, TLEG, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401

D, E, CH = 16, 128, 8
FEAT, PROTO = (6, 8), (24, 32)
TRACK_KW = dict(track_capacity=12, det_capacity=D)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('kw', [
    dict(conv_h=3, conv_w=5, aspect_ratios=(1.0, 0.5, 2.0), scales=(24.0,)),
    dict(conv_h=2, conv_w=4, aspect_ratios=(1.0, 0.5), scales=(24.0, 48.0),
         max_size=640),
    dict(conv_h=4, conv_w=3, aspect_ratios=(2.0,), scales=(32.0,),
         use_pixel_scales=False, use_square_anchors=True)])
def test_make_yolact_priors(kw):
    np.testing.assert_array_equal(TA.make_yolact_priors(**kw),
                                  JL.make_yolact_priors(**kw))


def test_all_priors_legacy():
    """The full-size preset's priors and the reduced one's (where
    max_size is 640 from pad_w)."""
    full_t = t_get_config('YOLACT_legacy_resnet50')
    from stmask_tpu.config import get_config as j_get_config
    full_j = j_get_config('YOLACT_legacy_resnet50')
    for t_cfg, j_cfg in ((full_t, full_j), (TLEG, JLEG)):
        port = TA.all_priors(t_cfg)
        assert port.shape == (t_cfg.num_priors, 4)
        np.testing.assert_array_equal(port, JA.all_priors(j_cfg))


@pytest.fixture(scope='module')
def models():
    jmodel, params = flax_params(seed=4, cfg=JLEG)
    return jmodel, params, port_model(params, TLEG)


def test_legacy_eval_outputs(models):
    """One frame: every eval output of the flax model, the synthesized
    centerness (ones) and track (1/sqrt(E)) included."""
    jmodel, params, tmodel = models
    x = np.random.RandomState(1).randn(1, JLEG.pad_h, JLEG.pad_w, 3).astype(
        np.float32)
    ref = jax.jit(lambda p, v: jmodel.apply(p, v, train=False))(
        params, jnp.asarray(x))
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(x))
    tol = dict(loc=2e-3, conf=1e-4, centerness=0.0, mask_coeff=2e-3,
               track=0.0, proto=2e-3, T2S_feat=2e-3)
    assert set(out) == set(ref) == set(tol)
    assert out['loc'].shape[1] == TLEG.num_priors
    for key, atol in tol.items():
        r, m = np.asarray(ref[key]), out[key].numpy()
        assert m.shape == r.shape, (key, m.shape, r.shape)
        np.testing.assert_allclose(m, r, rtol=0, atol=atol, err_msg=key)


def test_legacy_inits_cover_the_head(models):
    """``init_random`` and ``init_flax`` draw every tensor of the legacy
    model, whose keys are the converter's: the head's biases zero, its
    kernels random with flax's LeCun spread under ``init_flax``."""
    _, params, _ = models
    want = state_dict_from_flax(params)
    gen = torch.Generator().manual_seed(0)
    for init in (init_random, init_flax):
        sd = init(TSTMask(TLEG), gen).state_dict()
        assert set(sd) == set(want)
        for name in ('upfeature.0', 'bbox_layer', 'conf_layer', 'mask_layer'):
            w = sd[f'prediction_layers.0.{name}.weight']
            assert w.shape == want[f'prediction_layers.0.{name}.weight'].shape
            assert not sd[f'prediction_layers.0.{name}.bias'].any()
            if init is init_flax:
                std = float(w.std() * np.sqrt(w[0].numel()))
                assert 0.85 < std < 1.15, (name, std)


def test_legacy_training_raises(models):
    """Training the legacy preset (it raised until the port had its train
    branch; the name is kept).  One clip of chip_smoke.py's synthetic
    batches through the training forward of both models: raw loc, conf
    and mask coefficients and the prototypes, held as the eval outputs
    are.  Then both sides' ``compute_losses`` on JAX's predictions: the
    keys B (smooth-L1), C (OHEM) and M, each value (rtol 1e-5) and the
    gradient of the total with respect to every prediction (atol 1e-5
    relative to max|ref|).  JAX runs the forward and the loss with its
    gradient under ``jax.jit``."""
    from chip_smoke import _train_batch
    from stmask_tpu.train import losses as JLOSS
    from stmask_torch.data.transforms import prepare_batch
    from stmask_torch.train import losses as TLOSS
    jmodel, params, tmodel = models
    batch = {k: v.numpy() for k, v in prepare_batch(
        TLEG, _train_batch(TLEG, 7, clips=1), torch.device('cpu')).items()}
    ref = jax.jit(lambda p, v: jmodel.apply(p, v, train=True))(
        params, jnp.asarray(batch['images']))
    tmodel.train()
    try:
        out = tmodel(torch.from_numpy(batch['images']), train=True)
    finally:
        tmodel.eval()
    tol = dict(loc=2e-3, conf=2e-3, mask_coeff=2e-3, proto=2e-3)
    assert set(out) == set(tol) and 'T2S_concat_feat' not in ref
    for key, atol in tol.items():
        r, m = np.asarray(ref[key]), out[key].detach().numpy()
        assert m.shape == r.shape, (key, m.shape, r.shape)
        np.testing.assert_allclose(m, r, rtol=0, atol=atol, err_msg=key)

    gt = {k: batch[k].reshape((-1,) + batch[k].shape[2:])
          for k in ('boxes', 'labels', 'ids', 'valid', 'masks_proto')}
    preds_np = {k: np.asarray(ref[k]) for k in tol}
    priors = TA.all_priors(TLEG)

    def loss_fn(p):
        d = JLOSS.compute_losses(JLEG, p, {k: jnp.asarray(v) for k, v in
                                           gt.items()}, jnp.asarray(priors))
        return sum(d.values()), d

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        {k: jnp.asarray(v) for k, v in preds_np.items()})
    preds = {k: torch.tensor(v, requires_grad=True)
             for k, v in preds_np.items()}
    tl = TLOSS.compute_losses(TLEG, preds, {k: torch.from_numpy(v)
                                            for k, v in gt.items()},
                              torch.from_numpy(priors))
    sum(tl.values()).backward()
    assert list(tl) == ['B', 'C', 'M'] and set(jl) == set(tl)
    for k in tl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        assert float(jl[k]) > 0, k
    for k, p in preds.items():
        want = np.asarray(jg[k])
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=0,
            atol=1e-5 * max(float(np.abs(want).max()), 1e-3), err_msg=k)


# ---- the simple tracker ----------------------------------------------------

def _dets(rng, n_valid, copies=()):
    a = rng.uniform(0.05, 0.6, (D, 2))
    box = np.concatenate([a, a + rng.uniform(0.15, 0.35, (D, 2))], 1)
    d = dict(box=box.astype(np.float32),
             score=np.sort(rng.uniform(0.1, 0.95, D))[::-1].astype(
                 np.float32),
             cls=rng.randint(1, 41, D).astype(np.int32),
             mask_coeff=(rng.randn(D, 32) * 2).astype(np.float32),
             track=np.full((D, E), E ** -0.5, np.float32),
             centerness=np.ones(D, np.float32),
             valid=np.arange(D) < n_valid)
    for dst, src in copies:
        for k in ('box', 'cls', 'mask_coeff'):
            d[k][dst] = src[k]
    return d


def _row(d, i, dy=0.0):
    r = {k: d[k][i].copy() for k in ('box', 'cls', 'mask_coeff')}
    r['box'] = (r['box'] + dy).astype(np.float32)
    return r


def _sequence():
    """6 frames: 10 new tracks (rows 1 and 2 duplicates of row 0, so a
    later copy of row 0 overlaps three tracks' masks); matches, the
    overlapping copy and more new objects than free slots; an empty frame;
    a reset (is_first) with new objects; matches after the reset."""
    rng = np.random.RandomState(1)
    f0 = _dets(rng, 10)
    for i in (1, 2):
        for k in ('box', 'mask_coeff'):
            f0[k][i] = f0[k][0]
    f1 = _dets(rng, 16, copies=[(i, _row(f0, i + 2, 0.01)) for i in range(6)]
               + [(6, _row(f0, 0, 0.005))])
    f2 = _dets(rng, 0)
    f3 = _dets(rng, 7)
    f4 = _dets(rng, 12, copies=[(i, _row(f3, i, 0.02)) for i in range(5)])
    f5 = _dets(rng, 9, copies=[(i, _row(f4, i + 1, 0.01)) for i in range(6)])
    return [(f0, True), (f1, False), (f2, False), (f3, True), (f4, False),
            (f5, False)]


def _cmp(port, ref, what):
    for name, p, r in zip(ref._fields, port, ref):
        p, r = p.detach().numpy(), np.asarray(r)
        assert p.shape == r.shape, (what, name, p.shape, r.shape)
        if r.dtype.kind in 'biu':
            np.testing.assert_array_equal(p, r, err_msg=f'{what} {name}')
        else:
            np.testing.assert_allclose(p, r, rtol=0, atol=1e-5,
                                       err_msg=f'{what} {name}')


def test_track_step_simple_sequence():
    """ids, keep, binarized masks and the whole state, frame by frame,
    through a reset; the mask-overlap gate holds back at least one
    matched track's update."""
    rng = np.random.RandomState(2)
    jcfg, tcfg = JLEG.replace(**TRACK_KW), TLEG.replace(**TRACK_KW)
    j_step = jax.jit(JT.track_step_simple, static_argnums=(0,))
    j_state = JT.init_state(jcfg, FEAT, PROTO, CH, E)
    t_state = TT.init_state(tcfg, FEAT, PROTO, CH, E)
    gated = 0
    for f, (det, first) in enumerate(_sequence()):
        proto = np.maximum(rng.randn(*PROTO, 32), 0).astype(np.float32)
        jdet = JC.Detections(**{k: jnp.asarray(v) for k, v in det.items()})
        # the gate's input, as track_step_simple forms it
        masks = j_generate_mask(jnp.asarray(proto), jdet.mask_coeff,
                                jdet.box) > 0.5
        mious = np.asarray(j_mask_iou(masks.astype(jnp.float32),
                                      (j_state.mask > 0.5).astype(
                                          jnp.float32)))
        mious = np.where(np.asarray(j_state.valid)[None], mious, 0.0)
        if not first:
            gated += int(((mious > 0.3).sum(1) >= 2)[det['valid']].sum())
        j_state, j_out = j_step(jcfg, j_state, jdet, jnp.asarray(proto),
                                jnp.asarray(first))
        t_state, t_out = TT.track_step_simple(
            tcfg, t_state, TC.Detections(**{k: _t(v) for k, v in
                                            det.items()}), _t(proto), first)
        _cmp(t_out, j_out, f'frame {f} output')
        _cmp(t_state, j_state, f'frame {f} state')
        assert set(np.unique(t_out.mask.numpy())) <= {0.0, 1.0}
    assert gated > 0
    assert int(np.asarray(j_state.next_id)) >= 7


# ---- the video step --------------------------------------------------------

def _frames(n):
    rng = np.random.RandomState(5)
    h, w = JLEG.img_h, JLEG.img_w
    coarse = rng.rand(h // 16 + 2, w // 16 + 2, 3)
    base = np.kron(coarse, np.ones((16, 16, 1)))[:h, :w]
    frame = np.clip(base * 200 + rng.rand(h, w, 3) * 55, 0, 255)
    return [np.roll(frame, (2 * i, 3 * i), axis=(0, 1)).astype(np.uint8)
            for i in range(n)]


def _mask_iou(a, b):
    from stmask_torch.utils import rle
    ma, mb = rle.decode(a).astype(bool), rle.decode(b).astype(bool)
    union = (ma | mb).sum()
    return 1.0 if union == 0 else (ma & mb).sum() / union


def test_legacy_video_step_matches_jax(models):
    """3 frames through both video steps (the simple tracker), then the
    postprocess and the results JSON."""
    jmodel, params, tmodel = models
    j_step, j_init = j_build_video_step(JLEG, jmodel, uint8_input=True)
    t_step, t_init = t_build_video_step(TLEG, tmodel, uint8_input=True,
                                        device='cpu')
    j_state, t_state = j_init(), t_init()
    j_res, t_res, n_kept = [], [], 0
    for f, frame in enumerate(_frames(3)):
        j_state, j_out = j_step(params, j_state, jnp.asarray(frame),
                                jnp.asarray(f == 0))
        t_state, t_out = t_step(t_state, frame, f == 0)
        assert t_out.keep.shape == (min(TLEG.det_capacity, TLEG.nms_top_k),)
        for name in ('obj_id', 'keep', 'cls'):
            np.testing.assert_array_equal(
                getattr(t_out, name).numpy(), np.asarray(getattr(j_out, name)),
                err_msg=f'frame {f} {name}')
        for name in ('box', 'score'):
            np.testing.assert_allclose(
                getattr(t_out, name).numpy(), np.asarray(getattr(j_out, name)),
                atol=1e-4, err_msg=f'frame {f} {name}')
        n_kept += int(t_out.keep.sum())
        meta = {'video_id': 1, 'frame_id': f,
                'img_shape': (JLEG.img_h, JLEG.img_w)}
        j_res.append(j_postprocess(JLEG, j_out, meta))
        t_res.append(t_postprocess(TLEG, t_out, meta))
    assert n_kept > 0 and int(t_state.next_id) > 0

    j_json, t_json = j_results2json(j_res), t_results2json(t_res)
    assert len(t_json) == len(j_json) > 0
    for t_tr, j_tr in zip(t_json, j_json):
        assert t_tr['category_id'] == j_tr['category_id']
        assert abs(t_tr['score'] - j_tr['score']) <= 1e-4
        for ts, js in zip(t_tr['segmentations'], j_tr['segmentations']):
            assert (ts is None) == (js is None)
            if ts is not None:
                assert _mask_iou(ts, js) >= 0.99
