"""The reduced ``STMask_plus_resnet50_ada`` / ``_ali`` models in the port
against the JAX package on the CPU (``layers=(1, 3, 3, 1)`` at 96x128, as
``tests/torch_eval_common.py`` cuts the flagship): eval outputs after a
strict load from ``state_dict_from_flax``, the _ada video step's results
JSON, and (no JAX) a reference-keyed load from the torch mirror's FCB
model.  Tolerances: ``test_full_model_parity.py``'s for the outputs; the
video step as ``test_torch_model_parity.py`` holds it, the JSON's masks
equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.inference import build_video_step as j_build_video_step
from stmask_tpu.inference import postprocess_frame as j_postprocess
from stmask_tpu.inference import results2json_videoseg as j_results2json
from stmask_tpu.models import STMask as JSTMask

from stmask_torch.config import get_config as t_get_config
from stmask_torch.convert import load_reference_weights, state_dict_from_flax
from stmask_torch.inference import build_video_step as t_build_video_step
from stmask_torch.inference import postprocess_frame as t_postprocess
from stmask_torch.inference import results2json_videoseg as t_results2json
from stmask_torch.models import STMask as TSTMask

from torch_eval_common import few_torch_threads  # noqa: F401

KW = dict(img_w=128, img_h=96, track_capacity=16)
MODEL_TOL = dict(loc=2e-3, conf=1e-4, centerness=1e-4, mask_coeff=2e-3,
                 track=1e-3, proto=2e-3, T2S_feat=2e-3, fpn_feat=2e-3)


def _reduced(cfg):
    return cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                    layers=(1, 3, 3, 1)),
                       **KW)


def _flax_params(jcfg, seed):
    """Flax parameters of a reduced model, drawn with numpy in the shapes
    of ``jax.eval_shape`` (as ``torch_eval_common.flax_params``): FCB's
    ``conv_offset`` of std 0.1 (offsets of a few pixels) and its
    deformable kernels of unit gain."""
    model = JSTMask(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, jcfg.pad_h, jcfg.pad_w, 3)),
        train=False))['params']
    rng = np.random.RandomState(seed)

    def fill(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, path + (k,))
                continue
            parent, shape = path[-1], v.shape
            if k in ('scale', 'mean', 'var') or (
                    k == 'bias' and (parent.startswith('bn')
                                     or parent == 'downsample_bn')):
                a = {'scale': rng.rand(*shape) + 0.5,
                     'bias': rng.randn(*shape) * 0.1,
                     'mean': rng.randn(*shape) * 0.1,
                     'var': rng.rand(*shape) + 0.5}[k]
            elif parent == 'conv_offset_mask':
                a = rng.randn(*shape) * (0.01 if k == 'kernel' else 0.5)
            elif parent == 'conv_offset':
                a = rng.randn(*shape) * 0.1
            elif k in ('kernel', 'adaption_kernel'):
                a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
                if k == 'kernel' and (parent.startswith('conf_layer') or (
                        parent == 'conv'
                        and path[-2].startswith('conf_align'))):
                    a = a * 8.0     # a sharper class head, as the flagship's
            else:
                a = rng.randn(*shape) * 0.05
            out[k] = np.asarray(a, np.float32)
        return out

    return model, {'params': fill(shapes)}


@pytest.fixture(scope='module', params=['ada', 'ali'])
def fcb_models(request):
    name = f'STMask_plus_resnet50_{request.param}'
    jcfg = _reduced(j_get_config(name))
    tcfg = _reduced(t_get_config(name))
    jmodel, params = _flax_params(jcfg, seed=len(request.param))
    tmodel = TSTMask(tcfg)
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    return request.param, jcfg, tcfg, jmodel, params, tmodel.eval()


def test_reduced_fcb_model_eval_matches_flax(fcb_models):
    """Eval outputs of the reduced _ada / _ali models (a strict load from
    ``state_dict_from_flax``) at ``test_full_model_parity.py``'s
    tolerances; FCB's banks are FeatureAlign modules under the
    reference's keys."""
    mode, jcfg, _, jmodel, params, tmodel = fcb_models
    keys = [k for k in tmodel.state_dict() if '.conf_layer.0.' in k]
    want_keys = ['conv_adaption.weight', 'conv.weight', 'conv.bias'] + (
        ['conv_offset.weight'] if mode == 'ada' else [])
    assert sorted(k.split('conf_layer.0.')[1] for k in keys) == sorted(
        want_keys)
    x = np.random.RandomState(1).randn(1, jcfg.pad_h, jcfg.pad_w, 3).astype(
        np.float32)
    ref = jmodel.apply(params, jnp.asarray(x), train=False)
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(x))
    assert set(out) == set(MODEL_TOL)
    for key, atol in MODEL_TOL.items():
        r = np.asarray(ref[key])
        assert out[key].shape == r.shape, key
        np.testing.assert_allclose(out[key].numpy(), r, atol=atol,
                                   err_msg=f'{mode} {key}')


def _frames(cfg, n):
    rng = np.random.RandomState(5)
    coarse = rng.rand(cfg.img_h // 16 + 2, cfg.img_w // 16 + 2, 3)
    base = np.kron(coarse, np.ones((16, 16, 1)))[:cfg.img_h, :cfg.img_w]
    frame = np.clip(base * 200 + rng.rand(cfg.img_h, cfg.img_w, 3) * 55,
                    0, 255).astype(np.uint8)
    return [np.roll(frame, (2 * i, 3 * i), axis=(0, 1)) for i in range(n)]


def test_reduced_fcb_video_step_json_matches_jax(fcb_models):
    """3 frames of the reduced _ada / _ali model through both video steps:
    the ids, keep flags and classes equal, boxes and scores to 1e-4, and
    the results JSON's tracks equal (scores to 1e-4, masks RLE for RLE)."""
    mode, jcfg, tcfg, jmodel, params, tmodel = fcb_models
    j_step, j_init = j_build_video_step(jcfg, jmodel, uint8_input=True)
    t_step, t_init = t_build_video_step(tcfg, tmodel, uint8_input=True,
                                        device='cpu')
    j_state, t_state = j_init(), t_init()
    j_res, t_res, n_kept = [], [], 0
    for f, frame in enumerate(_frames(jcfg, 3)):
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
                'img_shape': (jcfg.img_h, jcfg.img_w)}
        j_res.append(j_postprocess(jcfg, j_out, meta))
        t_res.append(t_postprocess(tcfg, t_out, meta))
    assert n_kept > 0
    j_json, t_json = j_results2json(j_res), t_results2json(t_res)
    assert len(t_json) == len(j_json) > 0
    for t_tr, j_tr in zip(t_json, j_json):
        assert t_tr['video_id'] == j_tr['video_id']
        assert t_tr['category_id'] == j_tr['category_id']
        assert abs(t_tr['score'] - j_tr['score']) <= 1e-4
        assert t_tr['segmentations'] == j_tr['segmentations']


@pytest.mark.parametrize('mode', ['ada', 'ali'])
def test_load_reference_weights_from_the_mirror(tmp_path, mode):
    """A reference-keyed ``.pth`` of the torch mirror (``TSTMask(fcb_ada /
    fcb_ali=True)``, full R50 depth) loads into the port unchanged, every
    tensor kept, and the port's eval outputs match the mirror's at
    ``test_full_model_parity.py``'s tolerances.  No JAX."""
    from torch_mirror import TSTMask as Mirror
    from test_full_model_parity import _randomize_bn, _randomize_dcn

    torch.manual_seed(3)
    mirror = Mirror(dcn_layers=(0, 4, 6, 3), dcn_interval=2,
                    **{f'fcb_{mode}': True}).eval()
    _randomize_bn(mirror)
    _randomize_dcn(mirror)
    path = tmp_path / 'ref.pth'
    torch.save(mirror.mirror_state_dict(), path)
    cfg = t_get_config(f'STMask_plus_resnet50_{mode}').replace(
        img_w=128, img_h=96)
    port = TSTMask(cfg)
    kept, dropped = load_reference_weights(port, str(path))
    assert dropped == [] and all(k.endswith('num_batches_tracked')
                                 for k in kept), (kept, dropped)
    x = torch.randn(1, 3, cfg.pad_h, cfg.pad_w,
                    generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        ref = mirror(x)
        out = port.eval()(x.permute(0, 2, 3, 1))
    for key, atol in MODEL_TOL.items():
        r = ref[key]
        if key in ('T2S_feat', 'fpn_feat'):
            r = r.permute(0, 2, 3, 1)
        np.testing.assert_allclose(out[key].numpy(), r.numpy(), atol=atol,
                                   err_msg=f'{mode} {key}')
