"""The other backbones (ResNet-GN, DarkNet53, VGG16) in the port against
the JAX package (every preset of the registry: test_torch_presets.py).

Each preset runs at 96x128 with flax parameters drawn in the shapes of
``jax.eval_shape`` (tests/torch_eval_common.py), carried across by
``state_dict_from_flax``.  ``STMask_resnet50_gn`` is cut to one bottleneck
a stage; DarkNet53 and VGG16 have fixed depths in the JAX package and run
whole.  DarkNet's residual branches get a tenth of their drawn BN scale
(and shift), as ``init_random`` cuts them: 23 blocks that each add an
unscaled branch grow the activations to O(100), where fp32's relative
rounding exceeds the absolute tolerances.  The JAX forward runs under
``jax.jit``, once a preset, and returns the backbone's outputs with the
model's.  Tolerances are those of test_torch_model_parity.py (absolute);
the backbone outputs are held to 1e-5 of their max|ref|.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.inference import candidates as JC
from stmask_tpu.ops.anchors import all_priors as j_all_priors

from stmask_torch.config import get_config as t_get_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.inference import build_video_step as t_build_video_step
from stmask_torch.models import STMask as TSTMask
from stmask_torch.models.backbones_extra import (DarkNetBackbone, GroupNorm,
                                                 ResNetBackboneGN,
                                                 VGGBackbone, leaky_relu)
from stmask_torch.models.stmask import init_flax

from torch_eval_common import KW, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401

PRESETS = ('STMask_resnet50_gn', 'STMask_darknet53', 'STMask_vgg16')
EVAL_TOL = dict(loc=2e-3, conf=1e-4, centerness=1e-4, mask_coeff=2e-3,
                track=1e-3, proto=2e-3, T2S_feat=2e-3, fpn_feat=2e-3)
BACKBONE_REL = 1e-5


def small(get_config, name):
    """A preset at 96x128, GN cut to one bottleneck a stage."""
    cfg = get_config(name).replace(**KW)
    if 'gn' in name:
        cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                       layers=(1, 1, 1, 1)))
    return cfg


def scaled_darknet(params):
    """DarkNet's residual branches at a tenth of the drawn BN affine."""
    bb = params['params']['backbone']
    for name, blk in bb.items():
        if name.startswith('layer'):
            blk['bn2'] = dict(blk['bn2'], scale=blk['bn2']['scale'] * 0.1,
                              bias=blk['bn2']['bias'] * 0.1)
    return params


def draw(name, seed=0):
    """(flax model, params, port model) of a reduced preset."""
    jcfg = small(j_get_config, name)
    jmodel, params = flax_params(seed, jcfg)
    if 'darknet' in name:
        params = scaled_darknet(params)
    return jmodel, params, port_model(params, small(t_get_config, name))


def frame(cfg, seed=1):
    return np.random.RandomState(seed).randn(1, cfg.pad_h, cfg.pad_w,
                                             3).astype(np.float32)


@pytest.fixture(scope='module', params=PRESETS)
def preset(request):
    """The preset's models and JAX's backbone and eval outputs on one
    frame."""
    name = request.param
    jmodel, params, tmodel = draw(name)
    x = frame(tmodel.cfg)

    def both(m, v):
        return m.backbone(v), m(v, train=False)

    bb, out = jax.jit(lambda p, v: jmodel.apply(p, v, method=both))(
        params, jnp.asarray(x))
    return dict(name=name, jmodel=jmodel, params=params, tmodel=tmodel,
                x=x, backbone=[np.asarray(b) for b in bb],
                out={k: np.asarray(v) for k, v in out.items()})


def test_backbone_outputs(preset):
    tmodel = preset['tmodel']
    x = torch.from_numpy(preset['x']).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = tmodel.backbone(x)
    want = preset['backbone']
    assert len(got) == len(want)
    kind = {'STMask_resnet50_gn': ResNetBackboneGN,
            'STMask_darknet53': DarkNetBackbone,
            'STMask_vgg16': VGGBackbone}[preset['name']]
    assert type(tmodel.backbone) is kind
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert w.shape[-1] == tmodel.backbone.channels[i]
        np.testing.assert_allclose(
            g, w, rtol=0, atol=BACKBONE_REL * np.abs(w).max(),
            err_msg=f'{preset["name"]} backbone output {i}')


def test_eval_outputs(preset):
    """Every eval output of the whole model (fp32)."""
    with torch.inference_mode():
        out = preset['tmodel'](torch.from_numpy(preset['x']))
    ref = preset['out']
    assert set(out) == set(ref) == set(EVAL_TOL)
    for key, atol in EVAL_TOL.items():
        m = out[key].numpy()
        assert m.shape == ref[key].shape, (key, m.shape, ref[key].shape)
        np.testing.assert_allclose(m, ref[key], rtol=0, atol=atol,
                                   err_msg=f'{preset["name"]} {key}')


def test_vgg16_anchor_count_fault(preset):
    """VGG's tail keeps stride 16, so its head emits 912 anchors against
    the 771 priors of 96x128 (ROADMAP C.8).  JAX's own detect_frame fails
    on the shapes; the port's video step and its losses raise a
    ValueError that names both counts, before decode and before the
    match."""
    if preset['name'] != 'STMask_vgg16':
        assert preset['out']['loc'].shape[1] == len(
            j_all_priors(small(j_get_config, preset['name'])))
        return
    jcfg = small(j_get_config, 'STMask_vgg16')
    priors = j_all_priors(jcfg)
    assert (preset['out']['loc'].shape[1], len(priors)) == (912, 771)
    one = {k: jnp.asarray(v[0]) for k, v in preset['out'].items()
           if k in ('loc', 'conf', 'mask_coeff', 'track', 'centerness')}
    with pytest.raises(TypeError, match=r'\(912, 2\), \(771, 2\)'):
        JC.detect_frame(jcfg, one, jnp.asarray(priors))

    tmodel = preset['tmodel']
    step, init = t_build_video_step(tmodel.cfg, tmodel, device='cpu')
    with pytest.raises(ValueError, match='912 anchors.*771 priors'):
        step(init(), torch.from_numpy(preset['x'][0]), True)

    from stmask_torch.train import losses as TL
    preds = {k: torch.tensor(v) for k, v in preset['out'].items()}
    with pytest.raises(ValueError, match='912 anchors.*771 priors'):
        TL.compute_losses(tmodel.cfg, preds, {}, torch.from_numpy(priors))


def test_state_dict_and_init_flax(preset):
    """The port's keys are the converter's (the backbone's under the flax
    names; with ``include_bn=False``, its parameters), and ``init_flax``
    draws the backbone as flax's initializers
    do: GroupNorm scale 1 and bias 0, the VGG biases 0, each kernel
    LeCun-normal (spread within 15% of 1 / sqrt(fan-in), truncated at two
    standard deviations).  DarkNet's draw is not repeated here: its
    modules are the ResNet's classes (Conv2d, FrozenBatchNorm), whose
    draw test_torch_model_parity.py holds against flax's own init."""
    tmodel = preset['tmodel']
    want = state_dict_from_flax(preset['params'])
    assert set(want) == set(tmodel.state_dict())
    # a flax gradient tree maps onto exactly the port's parameters (GroupNorm
    # trains; under freeze_bn the BatchNorms are buffers)
    assert set(state_dict_from_flax(preset['params'], include_bn=False)) \
        == {n for n, _ in tmodel.named_parameters()}
    gn = [m for m in tmodel.modules() if isinstance(m, GroupNorm)]
    assert bool(gn) == (preset['name'] == 'STMask_resnet50_gn')
    if preset['name'] == 'STMask_darknet53':
        return
    got = init_flax(TSTMask(tmodel.cfg), torch.Generator().manual_seed(0)
                    ).state_dict()
    assert set(got) == set(want)
    bb = {k: v for k, v in got.items() if k.startswith('backbone.')}
    assert bb
    for k, v in bb.items():
        if k.endswith(('running_mean', 'bias')):
            assert not v.any(), k
        elif k.endswith('running_var') or (
                k.endswith('weight') and v.dim() == 1):
            assert bool((v == 1).all()), k
        elif k.endswith('weight'):
            std = float(v.std() * np.sqrt(v[0].numel()))
            assert 0.85 < std < 1.15, (k, std)
            bound = 2 / 0.87962566103423978 / np.sqrt(v[0].numel())
            assert float(v.abs().max()) <= 1.01 * bound, k


def test_leaky_relu_derivative_at_zero():
    """DarkNet's leaky ReLU has JAX's derivative: 1 at exactly 0 (torch's
    ``F.leaky_relu`` gives 0.1)."""
    v = np.array([-2.0, -0.0, 0.0, 3.0], np.float32)
    want = jax.vmap(jax.grad(lambda a: jax.nn.leaky_relu(a, 0.1)))(v)
    x = torch.from_numpy(v).requires_grad_()
    leaky_relu(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        leaky_relu(x).detach().numpy(),
        np.asarray(jax.nn.leaky_relu(jnp.asarray(v), 0.1)))


def test_groupnorm_matches_flax():
    """GroupNorm alone against flax's (epsilon 1e-6, the fast variance)
    on a zero-mean input of variance 0.25, where torch's ``nn.GroupNorm``
    (epsilon 1e-5) is 1.0e-4 away from flax: the port is held to 1e-5 of
    max|ref| (measured 9.5e-7 of 6.55)."""
    import flax.linen as fnn
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 5, 7, 64) * 0.5).astype(np.float32)
    scale = (rng.rand(64) + 0.5).astype(np.float32)
    bias = rng.randn(64).astype(np.float32)
    ref = fnn.GroupNorm(32).apply(
        {'params': {'scale': scale, 'bias': bias}}, jnp.asarray(x))
    gn = GroupNorm(32, 64)
    gn.load_state_dict({'weight': torch.from_numpy(scale),
                        'bias': torch.from_numpy(bias)})
    got = gn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
