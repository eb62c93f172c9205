"""The global batch of ``tests/test_torch_parallel.py`` through the port's
single-process training step (which the two gloo ranks there equal) and
JAX's ``build_train_step`` (the single-device mesh), two steps: the first
from the same converted parameters, the second from JAX's parameters and
momentum after its first step.  Losses, ``gnorm``, raw gradients (read
back from JAX's momentum trace, the clip's scale divided out) and updates,
within the limits of ``tests/test_torch_train_step_parity.py`` (losses
rtol 1e-4, gradients and updates atol 1e-2 x max|ref| per parameter).

The second step starts from JAX's state, not the port's own: the first
step's parameters differ between the two by up to 4.7e-3 of a tensor's
max|.| (their gradients by up to 9.3e-3 of it, summed in other orders),
and from the port's own the second step turned ~260 ReLU outputs on or
off whose inputs lay within 7e-4 of 0, which moved 113 elements of
``prediction_layers.0.track_extra.0.weight``'s gradient past the bound
(2.2e-2 of max|ref|) on an AMD EPYC host.  From JAX's state the second
step's gradients lie within 1.03e-3 of max|ref| there, the first step's
within 9.3e-3.  Each step is held in either of two summation orders
(``test_torch_train_step_parity.in_either_order``).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.models import STMask as JSTMask
from stmask_tpu.train.train_step import build_train_step as j_build_train_step

from stmask_torch.convert import state_dict_from_flax
from stmask_torch.models import STMask as TSTMask

import torch_parallel_worker as W
from test_torch_parallel import LOSSES, TCFG, _steps, flax_params
from test_torch_train_step_parity import (_close, _trace, in_either_order,
                                         refuses_off_bound)
from torch_eval_common import few_torch_threads  # noqa: F401

JCFG = W.reduce(j_get_config('STMask_plus_resnet50'))


def test_global_batch_matches_jax():
    params = flax_params()
    sd = state_dict_from_flax(params)
    batches = [W.global_batch(TCFG, seed) for seed in (0, 1)]
    j_step, j_init = j_build_train_step(JCFG, JSTMask(JCFG))
    j_state = j_init(params)

    def port_keys(tree):
        return {k: v.numpy() for k, v in state_dict_from_flax(
            tree, include_bn=False).items()}

    j_prev_p = port_keys(params)
    j_prev_m = {k: np.zeros_like(v) for k, v in j_prev_p.items()}
    # the port's parameters, in the order of its momentum buffers
    names = [k for k, _ in TSTMask(TCFG).named_parameters()]
    assert set(j_prev_p) == set(names)
    for i, batch in enumerate(batches):
        j_state, jm = j_step(j_state, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        j_p = port_keys(jax.tree_util.tree_map(np.asarray, j_state.params))
        j_m = port_keys(_trace(j_state.opt_state))
        scale = min(1.0, TCFG.grad_clip_norm / float(jm['gnorm']))
        assert scale < 1.0                      # the clip engaged
        j_grad = {k: (j_m[k].astype(np.float64) - TCFG.momentum * j_prev_m[k]
                      - TCFG.decay * j_prev_p[k]) / scale for k in names}

        def run():
            """The port's step i from JAX's parameters and momentum."""
            return _steps(sd, [batch], start=None if i == 0 else (
                {k: torch.from_numpy(j_prev_p[k]) for k in names},
                [torch.from_numpy(j_prev_m[k]) for k in names], i))

        def check(ref):
            for k in LOSSES + ('gnorm',):
                np.testing.assert_allclose(ref['metrics'][0][k],
                                           float(jm[k]), rtol=1e-4,
                                           err_msg=f'step {i} {k}')
            for k, g in ref['grads'][0].items():
                _close(g, j_grad[k], f'step {i} grad {k}')
                _close(ref['params'][0][k].numpy() - j_prev_p[k],
                       j_p[k] - j_prev_p[k], f'step {i} update {k}')
            assert isinstance(ref['params'][0][k], torch.Tensor)
            refuses_off_bound(g, j_grad[k])

        in_either_order(run, check)
        j_prev_p, j_prev_m = j_p, j_m
