"""Shared set-up of the eval-slice tests (tests/test_torch_eval_*.py).

A reduced flagship: ``STMask_plus_resnet50`` at 96x128 with
``layers=(1, 3, 3, 1)`` (five DCN sites, three of them stride 2) and 16
track slots; and a reduced ``YOLACT_legacy_resnet50`` (one bottleneck a
stage), the preset without TF.  Flax parameters are drawn with numpy
from a seed in the shapes ``jax.eval_shape`` gives (flax's own init of
the model costs about a minute on the CPU): LeCun-normal kernels as flax
draws them, random BatchNorm statistics, DCN offset predictors that move
the samples off the grid, and a sharper class head so that the untrained
model detects and tracks objects.  ``state_dict_from_flax`` carries them
to the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.models import STMask as JSTMask

from stmask_torch.config import get_config as t_get_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.models import STMask as TSTMask

KW = dict(img_w=128, img_h=96, track_capacity=16)
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope='module')
def few_torch_threads():
    """Two intra-op threads while a module of these tests runs: the suite
    runs in several worker processes at once, and a torch that spreads
    every op over all the cores of a shared host spends most of its time
    waiting for its own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


def _reduced(cfg):
    return cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                    layers=(1, 3, 3, 1)),
                       **KW)


JCFG = _reduced(j_get_config('STMask_plus_resnet50'))
TCFG = _reduced(t_get_config('STMask_plus_resnet50'))


def _reduced_legacy(cfg):
    """The legacy YOLACT preset (R50 without DCN, no TF) at 96x128 with one
    bottleneck a stage."""
    return cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                    layers=(1, 1, 1, 1)),
                       **KW)


JLEG = _reduced_legacy(j_get_config('YOLACT_legacy_resnet50'))
TLEG = _reduced_legacy(t_get_config('YOLACT_legacy_resnet50'))


def flax_params(seed: int = 0, cfg=None):
    """(flax STMask, {'params': numpy tree}) of the reduced flagship, or of
    the JAX config ``cfg``."""
    cfg = cfg or JCFG
    model = JSTMask(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.pad_h, cfg.pad_w, 3)),
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
            elif k == 'kernel':
                a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
                if parent.startswith('conf_layer'):
                    a = a * 8.0
            else:
                a = rng.randn(*shape) * 0.05
            out[k] = np.asarray(a, np.float32)
        return out

    return model, {'params': fill(shapes)}


def port_model(params, cfg=None):
    """The port's model (the reduced flagship, or the port's config
    ``cfg``) with the same weights, eval mode, on the CPU."""
    model = TSTMask(cfg or TCFG)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model.eval()
