"""The mask-IoU net with the eval re-scoring, the semantic-seg and
class-existence heads, the focal conf-bias init and MakeNet's deconv entry,
in the port against the JAX package.

Flax parameters are drawn with numpy in the shapes ``jax.eval_shape``
gives and carried across by ``state_dict_from_flax``; the JAX modules run
eagerly.  Outputs are held to 1e-5 of their max|ref| (fp32 sums in another
order); the re-scored detections' scores to 1e-6 (a product of two
compared floats).
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.inference import candidates as JC
from stmask_tpu.inference.pipeline import cast_params
from stmask_tpu.models.heads import _focal_conf_bias_init
from stmask_tpu.models.layers import MakeNet as JMakeNet
from stmask_tpu.models.maskiou import FastMaskIoUNet as JMaskIoU

from stmask_torch.config import get_config as t_get_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.inference import candidates as TC
from stmask_torch.inference import pipeline as TP
from stmask_torch.models import STMask as TSTMask
from stmask_torch.models.heads import FeatureAlign, focal_conf_bias
from stmask_torch.models.layers import MakeNet as TMakeNet
from stmask_torch.models.maskiou import FastMaskIoUNet as TMaskIoU
from stmask_torch.models.stmask import init_flax, init_random

from torch_eval_common import JCFG, TCFG
from torch_eval_common import few_torch_threads  # noqa: F401

REL = 1e-5
NCLS = 41


def _draw(module, x, seed):
    """numpy parameters of a flax module, kernels LeCun-spread, biases
    small."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                   if len(s.shape) > 1 else rng.randn(*s.shape) * 0.1
                   ).astype(np.float32), shapes)


def _under(prefix, params, module):
    """Load ``state_dict_from_flax({prefix: params})`` into ``module``."""
    sd = state_dict_from_flax({prefix: params['params']})
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()},
                           strict=True)
    return module


def _close(got, want, rel=REL, msg=''):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-3),
                               err_msg=msg)


def _nets(seed=0, hw=(24, 32)):
    fnet = JMaskIoU(NCLS)
    params = _draw(fnet, jnp.zeros((1,) + hw + (1,)), seed)
    return fnet, params, _under('maskiou_net', params, TMaskIoU(NCLS))


def test_fast_maskiou_net_matches_flax():
    """fp32, and bf16 weights on fp32 masks: flax promotes to fp32 there,
    and so does the port."""
    fnet, params, tnet = _nets()
    masks = np.random.RandomState(1).rand(6, 24, 32, 1).astype(np.float32)
    ref = fnet.apply(params, jnp.asarray(masks))
    got = tnet(torch.from_numpy(masks))
    assert got.shape == (6, NCLS - 1)
    _close(got.detach(), ref, msg='fp32')
    ref16 = fnet.apply(cast_params(params), jnp.asarray(masks))
    got16 = tnet.to(torch.bfloat16)(torch.from_numpy(masks))
    assert got16.dtype == torch.float32 and ref16.dtype == jnp.float32
    _close(got16.detach(), ref16, msg='bf16 weights')


def test_rescore_maskiou_matches_jax():
    """Each valid detection's score times the net's IoU for its class;
    invalid slots keep theirs; nothing else changes."""
    rng = np.random.RandomState(2)
    d = 16
    a = rng.uniform(0.05, 0.5, (d, 2))
    det = dict(box=np.concatenate([a, a + rng.uniform(0.2, 0.45, (d, 2))],
                                  1).astype(np.float32),
               score=rng.uniform(0.1, 0.9, d).astype(np.float32),
               cls=rng.randint(1, NCLS, d).astype(np.int32),
               mask_coeff=(rng.randn(d, 32) * 2).astype(np.float32),
               track=rng.randn(d, 8).astype(np.float32),
               centerness=rng.rand(d).astype(np.float32),
               valid=np.arange(d) < 11)
    proto = np.abs(rng.randn(24, 32, 32)).astype(np.float32)
    fnet, params, tnet = _nets(3)
    cfg = JCFG.replace(use_maskiou=True, rescore_mask=True)
    ref = JC.rescore_maskiou(
        cfg, lambda m: fnet.apply(params, m),
        JC.Detections(**{k: jnp.asarray(v) for k, v in det.items()}),
        jnp.asarray(proto))
    got = TC.rescore_maskiou(
        TCFG, tnet, TC.Detections(**{k: torch.from_numpy(v)
                                     for k, v in det.items()}),
        torch.from_numpy(proto))
    for name in TC.Detections._fields:
        g, r = getattr(got, name).detach().numpy(), np.asarray(
            getattr(ref, name))
        if name == 'score':
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
            assert not np.array_equal(g[:11], det['score'][:11])
            np.testing.assert_array_equal(g[11:], det['score'][11:])
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


def test_video_step_rescores(monkeypatch):
    """The port's video steps call ``rescore_maskiou_lanes`` once a step,
    on every lane's detections, under ``use_maskiou`` + ``rescore_mask``
    (and not without), with the model's mask-IoU net; the model carries the
    net's parameters under the flax names."""
    tcfg = TCFG.replace(use_maskiou=True, rescore_mask=True)
    model = init_random(TSTMask(tcfg), torch.Generator().manual_seed(0))
    assert {k for k in model.state_dict() if k.startswith('maskiou_net.')} \
        == {f'maskiou_net.{n}.{p}' for n in ('conv0', 'conv1', 'conv2',
                                             'conv3', 'conv4', 'classifier')
            for p in ('weight', 'bias')}
    calls = []

    def counted(cfg, fn, det, proto):
        calls.append((fn, det.score.shape[0]))
        return TC.rescore_maskiou_lanes(cfg, fn, det, proto)

    monkeypatch.setattr(TP, 'rescore_maskiou_lanes', counted)
    x = torch.randn(tcfg.pad_h, tcfg.pad_w, 3,
                    generator=torch.Generator().manual_seed(0))
    step, init = TP.build_video_step(tcfg, model, device='cpu')
    step(init(), x, True)
    chunk, inits = TP.build_video_step_batched(tcfg, model, 2, 1,
                                               device='cpu')
    chunk(inits(), x[None, None].expand(1, 2, -1, -1, -1), [[True, True]])
    assert calls == [(model.maskiou, 1), (model.maskiou, 2)]
    step, init = TP.build_video_step(tcfg.replace(rescore_mask=False), model,
                                     device='cpu')
    step(init(), x, True)
    assert len(calls) == 2


@pytest.mark.parametrize('spec', [
    ((16, 3, 1), (8, -2, 0), (4, 1, 0)),
    ((8, -3, 0), (None, -2, 0), (6, 3, 1))])
def test_makenet_deconv_matches_flax(spec):
    """A make_net deconv entry (kernel = stride = |k|) against flax's
    ``ConvTranspose`` on kernels that are not symmetric: the converter
    flips them, since torch's transposed conv flips its kernel and flax's
    (``transpose_kernel=False``) does not."""
    jnet = JMakeNet(spec, include_last_relu=False)
    x = np.random.RandomState(4).randn(2, 5, 7, 12).astype(np.float32)
    params = _draw(jnet, jnp.asarray(x), 5)
    ref = jnet.apply(params, jnp.asarray(x))
    tnet = _under('proto_net', params, TMakeNet(12, spec,
                                                include_last_relu=False))
    deconv = [m for m in tnet if isinstance(m, torch.nn.ConvTranspose2d)]
    assert len(deconv) == 1
    w = deconv[0].weight
    assert not torch.equal(w, w.flip(2, 3))
    got = tnet(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape
    _close(got.detach(), ref)


def test_semantic_seg_and_class_existence_heads():
    """The two heads' flax modules (a 1x1 Conv, a Dense on the mean-pooled
    P7) through the converter: the Dense kernel [in, out] becomes
    [out, in].  The model builds them under the flags and its training
    branch emits ``segm`` on P3 and ``classes``."""
    rng = np.random.RandomState(6)
    p3 = rng.randn(2, 12, 16, 256).astype(np.float32)
    p7 = rng.randn(2, 1, 1, 256).astype(np.float32)
    conv = fnn.Conv(NCLS - 1, (1, 1))
    dense = fnn.Dense(NCLS - 1)
    pc = _draw(conv, jnp.asarray(p3), 7)
    pd = _draw(dense, jnp.zeros((1, 256)), 8)
    sd = state_dict_from_flax({'semantic_seg_conv': pc['params'],
                               'class_existence_fc': pd['params']})
    assert sd['class_existence_fc.weight'].shape == (NCLS - 1, 256)
    tcfg = TCFG.replace(use_semantic_segmentation_loss=True,
                        use_class_existence_loss=True)
    model = TSTMask(tcfg)
    model.semantic_seg_conv.load_state_dict(
        {'weight': sd['semantic_seg_conv.weight'],
         'bias': sd['semantic_seg_conv.bias']})
    model.class_existence_fc.load_state_dict(
        {'weight': sd['class_existence_fc.weight'],
         'bias': sd['class_existence_fc.bias']})
    _close(model.semantic_seg_conv(torch.from_numpy(p3).permute(
        0, 3, 1, 2)).permute(0, 2, 3, 1).detach(),
        conv.apply(pc, jnp.asarray(p3)), msg='segm')
    _close(model.class_existence_fc(torch.from_numpy(p7).mean(
        dim=(1, 2))).detach(),
        dense.apply(pd, jnp.mean(jnp.asarray(p7), axis=(1, 2))),
        msg='classes')
    init_flax(model, torch.Generator().manual_seed(0))
    out = model(torch.zeros(1, 2, tcfg.pad_h, tcfg.pad_w, 3), train=True)
    assert out['segm'].shape == (2, tcfg.pad_h // 8, tcfg.pad_w // 8,
                                 NCLS - 1)
    assert out['classes'].shape == (2, NCLS - 1)


def _conf_biases(model):
    head = model.prediction_layers[0]
    if model.cfg.head_type == 'legacy':
        return [head.conf_layer.bias]
    return [(m.conv if isinstance(m, FeatureAlign) else m).bias
            for m in head.conf_layer]


@pytest.mark.parametrize('name', ['STMask_plus_resnet50',
                                  'STMask_plus_resnet50_ada',
                                  'YOLACT_legacy_resnet50'])
def test_focal_conf_bias_init(name):
    """Under ``use_sigmoid_focal_loss`` both inits write JAX's focal conf
    bias (each prior's background channel +log((1-pi)/pi), scale-major)
    into every conf bank (FCB's ``conv`` where a bank aligns; the legacy
    head's one conf layer); without it the biases stay zero.  The
    backbone is cut to one block a stage (it has no conf bias)."""
    cfg = t_get_config(name).replace(img_h=96, img_w=128,
                                     use_sigmoid_focal_loss=True)
    cfg = cfg.replace(backbone=dataclasses.replace(
        cfg.backbone, layers=(1, 1, 1, 1), dcn_layers=(0, 0, 0, 0)))
    jcfg = j_get_config(name).replace(use_sigmoid_focal_loss=True)
    n = len(cfg.pred_scales[0]) * (3 if cfg.head_type == 'legacy' else 1)
    want = np.asarray(_focal_conf_bias_init(jcfg, n)(
        None, (n * cfg.num_classes,)))
    np.testing.assert_array_equal(focal_conf_bias(cfg, n), want)
    for init in (init_random, init_flax):
        model = init(TSTMask(cfg), torch.Generator().manual_seed(0))
        banks = _conf_biases(model)
        assert len(banks) == (1 if cfg.head_type == 'legacy' else 3)
        for b in banks:
            np.testing.assert_array_equal(b.detach().numpy(), want)
    plain = init_random(TSTMask(cfg.replace(use_sigmoid_focal_loss=False)),
                        torch.Generator().manual_seed(0))
    assert not any(b.any() for b in _conf_biases(plain))
