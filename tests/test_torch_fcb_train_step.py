"""One training step of the reduced ``STMask_plus_resnet50_ada`` in the port
against the JAX package's on the CPU (its own file, so that ``--dist
loadfile`` gives the JAX compile a worker of its own).

The set-up of ``test_torch_train_step_parity.py`` (``layers=(1, 3, 3,
1)`` at 96x128, one clip, lr 1e3 so that JAX's gradient reads back from its
update) with FCB on: the three conf banks are ``FeatureAlign`` modules that
train through the window-clamped deformable conv.  Their ``conv_offset``
and deformable kernels are LeCun-normal, so that the offsets reach past
the window and the kernels pass a gradient.

The model is cut further so that JAX compiles it in about a minute on a
CPU: JAX unrolls each window op into (2 * radius + 2)^2 static slices a
tap, and its compile time grows with their count (~5.5 min for the 15 FCB
sites at radius 2 and the 5 backbone DCN sites beside them).  Here FCB runs
at ``fcb_window_radius`` 1 on 3 FPN levels (P3-P5: ``num_downsample`` 0),
9 sites, and the backbone has no DCN (``test_torch_train_step_parity.py``
trains the backbone's DCN; ``test_torch_fcb.py`` one FCB bank at radius 2
on five levels against ``jax.grad``).

Tolerances: losses rtol 1e-4, every gradient and update ``REL`` (1e-2) of
max|ref| per parameter, as that file states them.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.convert import convert_state_dict
from stmask_tpu.models import STMask as JSTMask
from stmask_tpu.train.train_step import build_train_step as j_build_train_step

from stmask_torch.config import get_config as t_get_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.models import STMask as TSTMask
from stmask_torch.train.train_step import build_train_step as t_build_train_step

from test_torch_model_parity import _perturb
from test_torch_train_step_parity import KW, REL, _batch, _close, _lecun
from torch_eval_common import few_torch_threads  # noqa: F401

NAME = 'STMask_plus_resnet50_ada'


def _cut(cfg):
    """The preset at the size of the module docstring."""
    return cfg.replace(
        backbone=dataclasses.replace(cfg.backbone, layers=(1, 3, 3, 1),
                                     dcn_layers=(0, 0, 0, 0)),
        fpn=dataclasses.replace(cfg.fpn, num_downsample=0),
        pred_scales=cfg.pred_scales[:3], fcb_window_radius=1, **KW)


JCFG, TCFG = _cut(j_get_config(NAME)), _cut(t_get_config(NAME))


def _params():
    """Flax parameters in the tree of the port's ``state_dict``: kernels
    LeCun-normal (FCB's deformable kernels too), BN statistics perturbed as
    in ``test_torch_model_parity.py``."""
    zeros = jax.tree_util.tree_map(np.asarray, convert_state_dict(
        TSTMask(TCFG).state_dict())['params'])
    rng = np.random.RandomState(1)
    params = _lecun(zeros, rng)
    for name, mod in params['prediction_head'].items():
        if name.startswith('conf_align'):
            k = mod['adaption_kernel']
            mod['adaption_kernel'] = (rng.randn(*k.shape) / np.sqrt(
                np.prod(k.shape[:-1]))).astype(np.float32)
    perturbed = _perturb(params, np.random.RandomState(0))
    perturbed['prediction_head'] = params['prediction_head']
    return {'params': perturbed}


def test_one_ada_train_step_matches_jax():
    params = _params()
    batch = _batch(JCFG)
    j_step, j_init = j_build_train_step(JCFG, JSTMask(JCFG))
    j_state, j_metrics = j_step(j_init(params),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    j_new = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, j_state.params), include_bn=False)

    model = TSTMask(TCFG)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    t_step, t_init = t_build_train_step(TCFG, model, device='cpu')
    state, metrics = t_step(t_init(), {k: torch.from_numpy(v)
                                       for k, v in batch.items()})

    for k in ('BIoU', 'C', 'center', 'M', 'T', 'B_shift', 'M_shift',
              'total', 'gnorm'):
        assert np.isfinite(float(metrics[k])), k
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=1e-4, err_msg=k)
    lr = float(j_metrics['lr'])
    named = dict(model.named_parameters())
    assert set(named) == set(j_new)
    fcb = [k for k in named if '.conf_layer.' in k]
    assert len(fcb) == 12, fcb          # 3 banks x 4 tensors
    for k, p in named.items():
        p0 = before[k].numpy()
        j_update = j_new[k].numpy() - p0
        j_grad = -j_update / lr - TCFG.decay * p0
        _close(p.grad, j_grad, f'grad {k}')
        _close(p.detach().numpy() - p0, j_update, f'update {k}')
    for k in fcb:
        if 'conv_offset' in k or 'conv_adaption' in k:
            assert float(named[k].grad.abs().max()) > 0, k
