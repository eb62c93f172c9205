"""The port's ``compute_losses`` against the JAX package's on the CPU.

The fixture is ``tests/test_train_parity.py``'s (F = 4 frames in 2 clips,
P = 300 priors, G = 6 gt slots, persisting / vanishing / new instances).
Both sides get the same predictions and the same TemporalNet weights
(carried across with ``state_dict_from_flax``).  Compared: every loss
value (rtol 1e-5), the gradient of the total with respect to every
prediction tensor (atol 1e-5 relative to max|ref|: fp32 sums in another
order), and the TemporalNet parameter gradients and the gradient of
``T2S_concat_feat``, which flows back through TemporalNet (atol 2e-3
relative to max|ref|).  The looser bound is for TemporalNet's ReLUs: the
two frameworks' convolutions sum in another order, so a pre-activation
within fp32 rounding of 0 can switch its unit on one side and off on the
other.  At seed 2 one RoI has such units (|pre-activation| < 1e-6), and
its gradients differ by up to 1.3e-3 of max|ref|; elsewhere the two agree
to 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.models.temporal import TemporalNet as JTemporalNet
from stmask_tpu.train import losses as JL

from stmask_torch.config import get_config as t_get_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.models.temporal import TemporalNet as TTemporalNet
from stmask_torch.train import losses as TL

from test_train_parity import CFG, CORR_CH, PRIORS, _fixture

TEMPORAL_REL = 2e-3
TCFG = t_get_config(CFG.name).replace(max_gt_per_frame=CFG.max_gt_per_frame)


def _temporal_nets(seed):
    fnet = JTemporalNet(32)
    params = jax.tree_util.tree_map(np.asarray, fnet.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 7, 7, CORR_CH))))
    tnet = TTemporalNet(CORR_CH)
    tnet.load_state_dict({k[len('TemporalNet.'):]: v for k, v in
                          state_dict_from_flax(
                              {'temporal_net': params['params']}).items()})
    return fnet, params, tnet


def _close(got, want, rel, msg):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * scale, err_msg=msg)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_compute_losses_values_and_gradients(seed):
    preds_np, gt_np = _fixture(seed)
    fnet, fparams, tnet = _temporal_nets(seed)

    def loss_fn(preds, tnp):
        d = JL.compute_losses(CFG, preds, {k: jnp.asarray(v) for k, v in
                                           gt_np.items()},
                              jnp.asarray(PRIORS),
                              temporal_net_fn=lambda x: fnet.apply(tnp, x))
        return sum(d.values()), d

    (_, jl), (jg, jtg) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in preds_np.items()}, fparams)

    preds = {k: torch.tensor(v, requires_grad=True)
             for k, v in preds_np.items()}
    gt = {k: torch.from_numpy(v) for k, v in gt_np.items()}
    tl = TL.compute_losses(TCFG, preds, gt, torch.from_numpy(PRIORS), tnet)
    sum(tl.values()).backward()

    assert set(tl) == set(jl) == {'BIoU', 'C', 'center', 'M', 'T',
                                  'B_shift', 'M_shift'}
    for k in sorted(jl):
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-5,
                                   atol=1e-7, err_msg=f'loss {k}')
        assert float(jl[k]) != 0.0, k
    for k, t in preds.items():
        rel = TEMPORAL_REL if k == 'T2S_concat_feat' else 1e-5
        _close(t.grad, jg[k], rel, f'd total / d {k}')
    jtg = state_dict_from_flax({'temporal_net': jtg['params']})
    for name, p in tnet.named_parameters():
        _close(p.grad, jtg[f'TemporalNet.{name}'], TEMPORAL_REL,
               f'd total / d TemporalNet.{name}')


def test_unported_loss_keys_raise():
    preds_np, gt_np = _fixture(0)
    preds = {k: torch.from_numpy(v) for k, v in preds_np.items()}
    gt = {k: torch.from_numpy(v) for k, v in gt_np.items()}
    for kw in (dict(use_sigmoid_focal_loss=True),
               dict(mask_proto_coeff_diversity_loss=True),
               dict(mask_proto_loss='l1'), dict(use_maskiou_loss=True),
               dict(use_semantic_segmentation_loss=True)):
        with pytest.raises(NotImplementedError, match='ROADMAP A.12'):
            TL.compute_losses(TCFG.replace(**kw), preds, gt,
                              torch.from_numpy(PRIORS), None)
