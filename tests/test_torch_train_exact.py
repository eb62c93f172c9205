"""One training step through the exact deformable gather (window radius 0)
in the port against the JAX package's on the CPU: the backbone's DCN at
``dcn_window_radius`` 0 and FCB at ``fcb_window_radius`` 0 together, so
that one JAX compile covers both exact paths.

``STMask_plus_resnet50_ada`` at 96x128 with ``layers=(1, 3, 3, 1)`` (five
backbone DCN sites) and its 15 FCB sites (P3..P7 under 3x3, 3x5 and 5x3
taps), one clip, and the settings of ``test_torch_train_step_parity.py``
(lr 1e3, so that JAX's gradient reads back from its update).  Two
parameter sets go through the same compiled step: the offset predictors
perturbed as in that file (the backbone's ``conv_offset_mask`` by
``_perturb``, FCB's ``conv_offset`` and deformable kernels LeCun-normal,
so that the samples leave the grid), and every ``conv_offset_mask`` and
``conv_offset`` zeroed, so that every sample of both paths sits on the
ties whose subgradients K5 follows (``kernels/deform_exact_bwd.py``).

Tolerances are that file's: losses rtol 1e-4, every gradient and update
``REL`` (1e-2) of max|ref| per parameter.  A ReLU whose input lies within
fp32 rounding of 0 can be on in one framework and off in the other (that
file's top says why), and here two such units tip at zero offsets (AMD
EPYC host, torch 2.13.0+cpu, oneDNN v3.12.0):
  - one of the mask branch, which takes JAX's side when the port sums in
    the other order (``other_order``): it moves
    ``mask_extra.0.weight``'s gradient by 2.9% of max|ref|;
  - one of FCB's 3x3 bank at P4, -7.9e-7 before its ReLU in the port in
    both orders and on in JAX: it moves one output channel of that bank's
    deformable weight gradient (``conv_adaption``) by 2.8% of max|ref|.
So the port's step runs twice: as it is, and summed in the other order
with every unit of FCB's deformable conv within ``MARGIN`` of 0 on the
other side of its ReLU (``_OtherSide``).  Each gradient and update must
match JAX's in one of the two runs, FCB's deformable kernels each output
channel's row (a unit moves only its own channel's row there), and the
losses in both; a fault of the port misses in both runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.convert import convert_state_dict
from stmask_tpu.models import STMask as JSTMask
from stmask_tpu.train.train_step import build_train_step as j_build_train_step

from stmask_torch.config import get_config as t_get_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.models import STMask as TSTMask
from stmask_torch.models import heads
from stmask_torch.train.train_step import build_train_step as t_build_train_step

from test_torch_model_parity import _perturb
from test_torch_train_step_parity import (KW, REL, _batch, _lecun,
                                          other_order)
from torch_eval_common import few_torch_threads  # noqa: F401

NAME = 'STMask_plus_resnet50_ada'
# FCB's pre-ReLU units this close to 0 may take the other decision: 2.5x
# the one seen (see the top)
MARGIN = 2e-6


def _cut(cfg):
    """The preset at 96x128, reduced depth, both window radii 0."""
    return cfg.replace(
        backbone=dataclasses.replace(cfg.backbone, layers=(1, 3, 3, 1),
                                     dcn_window_radius=0),
        fcb_window_radius=0, **KW)


JCFG, TCFG = _cut(j_get_config(NAME)), _cut(t_get_config(NAME))


def _zeroed(tree):
    return {k: (jax.tree_util.tree_map(np.zeros_like, v)
                if k in ('conv_offset_mask', 'conv_offset')
                else _zeroed(v) if isinstance(v, dict) else v)
            for k, v in tree.items()}


class _OtherSide(torch.autograd.Function):
    """Every value within MARGIN of 0 negated (so a ReLU after it takes the
    other decision), the gradient passed through as it is."""

    @staticmethod
    def forward(ctx, v):
        return torch.where(v.abs() < MARGIN, -v, v)

    @staticmethod
    def backward(ctx, g):
        return g


@pytest.fixture(scope='module')
def setup():
    """The perturbed flax parameters and JAX's compiled train step."""
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
    j_step, j_init = j_build_train_step(JCFG, JSTMask(JCFG))
    return perturbed, j_step, j_init


def _port_step(params, batch):
    """The port's step from ``params``: (losses, {name: (gradient,
    update)}) as numpy."""
    model = TSTMask(TCFG)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    t_step, t_init = t_build_train_step(TCFG, model, device='cpu')
    _, metrics = t_step(t_init(), {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    return ({k: float(v) for k, v in metrics.items()},
            {k: (p.grad.numpy(), (p.detach() - before[k]).numpy())
             for k, p in model.named_parameters()})


@pytest.mark.parametrize('offsets', ['perturbed', 'zero'])
def test_exact_train_step_matches_jax(setup, offsets, monkeypatch):
    tree, j_step, j_init = setup
    params = {'params': tree if offsets == 'perturbed' else _zeroed(tree)}
    batch = _batch(JCFG)
    j_state, j_metrics = j_step(j_init(params),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    j_new = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, j_state.params), include_bn=False)
    p0 = state_dict_from_flax(params, include_bn=False)
    lr = float(j_metrics['lr'])
    want = {}
    for k, v in p0.items():
        j_update = j_new[k].numpy() - v.numpy()
        want[k] = (-j_update / lr - TCFG.decay * v.numpy(), j_update)

    runs = [_port_step(params, batch)]
    exact = heads.deform_conv_exact
    monkeypatch.setattr(heads, 'deform_conv_exact',
                        lambda *a, **k: _OtherSide.apply(exact(*a, **k)))
    with other_order():
        runs.append(_port_step(params, batch))

    for losses, _ in runs:
        for k in ('BIoU', 'C', 'center', 'M', 'T', 'B_shift', 'M_shift',
                  'total', 'gnorm'):
            assert np.isfinite(losses[k]), k
            np.testing.assert_allclose(losses[k], float(j_metrics[k]),
                                       rtol=1e-4, err_msg=k)
    assert set(runs[0][1]) == set(want)
    for k, (j_grad, j_update) in want.items():
        for i, (what, ref) in enumerate((('grad', j_grad),
                                         ('update', j_update))):
            bound = max(REL * float(np.abs(ref).max()), 1e-6)
            rows = [np.all(np.abs(r[k][i] - ref).reshape(len(ref), -1)
                           <= bound, axis=1) for _, r in runs]
            ok = (rows[0] | rows[1] if 'conv_adaption' in k
                  else rows[0] if rows[0].all() else rows[1])
            worst = min(float(np.abs(r[k][i] - ref).max()) for _, r in runs)
            assert ok.all(), (what, k, worst, bound)
    # both exact paths pass gradients to their offset predictors
    offs = [k for k in want
            if 'conv_offset_mask.weight' in k or 'conv_offset.weight' in k]
    assert len(offs) == 5 + 3, offs
    for k in offs:
        assert float(np.abs(runs[0][1][k][0]).max()) > 0, k
