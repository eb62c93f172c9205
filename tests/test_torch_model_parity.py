"""The port's flagship model and video step against the JAX package.

One module-scoped fixture initializes the flax ``STMask_plus_resnet50`` at
96x128 (track_capacity 16, as tests/test_pipeline_e2e.py), randomizes its
BatchNorm statistics and DCN offset predictors (zero offsets would pass
under any offset-channel permutation), and carries the parameters across
with ``stmask_torch.convert.state_dict_from_flax``.  Tolerances of the
model outputs are those of tests/test_full_model_parity.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.convert import convert_state_dict
from stmask_tpu.inference import build_video_step as j_build_video_step
from stmask_tpu.inference import postprocess_frame as j_postprocess
from stmask_tpu.inference import results2json_videoseg as j_results2json
from stmask_tpu.models import STMask as JSTMask

from stmask_torch.config import get_config as t_get_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.inference import build_video_step as t_build_video_step
from stmask_torch.inference import postprocess_frame as t_postprocess
from stmask_torch.inference import results2json_videoseg as t_results2json
from stmask_torch.models import STMask as TSTMask
from stmask_torch.utils import rle

KW = dict(img_w=128, img_h=96, track_capacity=16)
JCFG = j_get_config('STMask_plus_resnet50').replace(**KW)
TCFG = t_get_config('STMask_plus_resnet50').replace(**KW)
N_FRAMES = 3


def _perturb(tree, rng, path=()):
    """Random BN statistics, DCN offset predictors, and a sharper conf head
    (so the untrained model detects and tracks objects), as numpy."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, p)
            continue
        a = np.asarray(v, np.float32)
        parent = p[-2]
        if parent.startswith('bn') or parent == 'downsample_bn':
            a = {'scale': rng.rand(*a.shape) + 0.5,
                 'bias': rng.randn(*a.shape) * 0.1,
                 'mean': rng.randn(*a.shape) * 0.1,
                 'var': rng.rand(*a.shape) + 0.5}[k]
        elif parent == 'conv_offset_mask':
            a = rng.randn(*a.shape) * (0.01 if k == 'kernel' else 0.5)
        elif parent.startswith('conf_layer') and k == 'kernel':
            a = a * 8.0
        out[k] = np.asarray(a, np.float32)
    return out


def _frames():
    rng = np.random.RandomState(5)
    coarse = rng.rand(JCFG.img_h // 16 + 2, JCFG.img_w // 16 + 2, 3)
    base = np.kron(coarse, np.ones((16, 16, 1)))[:JCFG.img_h, :JCFG.img_w]
    frame = np.clip(base * 200 + rng.rand(JCFG.img_h, JCFG.img_w, 3) * 55,
                    0, 255).astype(np.uint8)
    return [np.roll(frame, (2 * i, 3 * i), axis=(0, 1))
            for i in range(N_FRAMES)]


@pytest.fixture(scope='module')
def flax_init():
    """The flax model and its own initial parameters (numpy)."""
    jmodel = JSTMask(JCFG)
    x = jnp.zeros((1, JCFG.pad_h, JCFG.pad_w, 3), jnp.float32)
    # under jax.jit: eagerly, each op shape compiles on its own (~1 min)
    params = jax.jit(lambda k, v: jmodel.init(k, v, train=False))(
        jax.random.PRNGKey(0), x)
    return jmodel, jax.tree_util.tree_map(np.asarray, params['params'])


@pytest.fixture(scope='module')
def models(flax_init):
    jmodel, init = flax_init
    params = {'params': _perturb(init, np.random.RandomState(0))}
    tmodel = TSTMask(TCFG)
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    return jmodel, params, tmodel.eval()


def test_eval_outputs(models):
    jmodel, params, tmodel = models
    x = np.random.RandomState(1).randn(1, JCFG.pad_h, JCFG.pad_w, 3).astype(
        np.float32)
    ref = jax.jit(lambda p, v: jmodel.apply(p, v, train=False))(
        params, jnp.asarray(x))
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(x))
    tol = dict(loc=2e-3, conf=1e-4, centerness=1e-4, mask_coeff=2e-3,
               track=1e-3, proto=2e-3, T2S_feat=2e-3, fpn_feat=2e-3)
    assert set(out) == set(tol)
    for key, atol in tol.items():
        r = np.asarray(ref[key])
        m = out[key].numpy()
        assert m.shape == r.shape, (key, m.shape, r.shape)
        np.testing.assert_allclose(m, r, atol=atol, err_msg=key)


def test_state_dict_round_trip(models):
    """convert_state_dict(port.state_dict()) is the flax tree, leaf for
    leaf, and the port's keys are exactly the converter's."""
    _, params, tmodel = models
    back = convert_state_dict(tmodel.state_dict())['params']
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(params['params'])[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(flat_back) == set(flat_ref)
    for k, v in flat_ref.items():
        np.testing.assert_array_equal(np.asarray(flat_back[k]), v,
                                      err_msg=jax.tree_util.keystr(k))


def _mask_iou(a, b):
    ma, mb = rle.decode(a).astype(bool), rle.decode(b).astype(bool)
    union = (ma | mb).sum()
    return 1.0 if union == 0 else (ma & mb).sum() / union


def test_video_step_and_json(models):
    """3 frames through both video steps, then postprocess and the results
    JSON."""
    jmodel, params, tmodel = models
    j_step, j_init = j_build_video_step(JCFG, jmodel, uint8_input=True)
    t_step, t_init = t_build_video_step(TCFG, tmodel, uint8_input=True,
                                        device='cpu')
    j_state, t_state = j_init(), t_init()
    j_res, t_res = [], []
    n_kept = 0
    for f, frame in enumerate(_frames()):
        j_state, j_out = j_step(params, j_state, jnp.asarray(frame),
                                jnp.asarray(f == 0))
        t_state, t_out = t_step(t_state, frame, f == 0)
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
                'img_shape': (JCFG.img_h, JCFG.img_w)}
        j_res.append(j_postprocess(JCFG, j_out, meta))
        t_res.append(t_postprocess(TCFG, t_out, meta))
    assert n_kept > 0 and int(t_state.next_id) > 0

    j_json, t_json = j_results2json(j_res), t_results2json(t_res)
    assert len(t_json) == len(j_json) > 0
    for t_tr, j_tr in zip(t_json, j_json):
        assert t_tr['video_id'] == j_tr['video_id']
        assert t_tr['category_id'] == j_tr['category_id']
        assert abs(t_tr['score'] - j_tr['score']) <= 1e-4
        assert len(t_tr['segmentations']) == N_FRAMES
        for ts, js in zip(t_tr['segmentations'], j_tr['segmentations']):
            assert (ts is None) == (js is None)
            if ts is not None:
                assert ts['size'] == js['size'] == [JCFG.img_h, JCFG.img_w]
                assert _mask_iou(ts, js) >= 0.99


def test_flagship_dcn_sites():
    """R50 with dcn_layers (0, 4, 6, 3) at interval 2: exactly 7 DCN
    sites, three of them stride 2."""
    from stmask_torch.models.backbone import DCNConv
    sites = {n: m.stride for n, m in TSTMask(TCFG).named_modules()
             if isinstance(m, DCNConv)}
    assert sites == {'backbone.layers.1.0.conv2': 2,
                     'backbone.layers.1.2.conv2': 1,
                     'backbone.layers.2.0.conv2': 2,
                     'backbone.layers.2.2.conv2': 1,
                     'backbone.layers.2.4.conv2': 1,
                     'backbone.layers.3.0.conv2': 2,
                     'backbone.layers.3.2.conv2': 1}


def test_init_flax_draws_as_flax_init(flax_init):
    """``init_flax`` against flax's own init of the same model, tensor by
    tensor: the zeros (biases, DCN offset predictors, BN shift and mean)
    and ones (BN scale and variance) exactly; each random kernel's spread
    within 10% of flax's (15% under 2048 values), both truncated where
    flax truncates."""
    from stmask_torch.models.stmask import init_flax

    want = state_dict_from_flax({'params': flax_init[1]})
    got = init_flax(TSTMask(TCFG), torch.Generator().manual_seed(0)
                    ).state_dict()
    assert set(got) == set(want)
    n_random = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if not w.is_floating_point() or not bool((w != w.flatten()[0]).any()):
            assert torch.equal(g, w.to(g.dtype)), k
            continue
        n_random += 1
        ratio = float(g.std() / w.std())
        tol = 0.10 if w.numel() >= 2048 else 0.15
        assert abs(ratio - 1) < tol, (k, ratio)
        # truncated at 2 stddev of the underlying normal: 2 / 0.8796 of
        # the drawn values' spread
        bound = 1.1 * 2 / 0.87962566103423978 * float(w.std())
        assert float(w.abs().max()) <= bound, k
        assert float(g.abs().max()) <= bound, k
    assert n_random > 50
