"""The global batch of ``tests/test_torch_parallel.py`` through the port's
single-process training step (which the two gloo ranks there equal) and
JAX's ``build_train_step`` (the single-device mesh), two steps from the
same converted parameters: losses, ``gnorm``, raw gradients (read back
from JAX's momentum trace, the clip's scale divided out) and updates,
within the limits of ``tests/test_torch_train_step_parity.py`` (losses
rtol 1e-4, gradients and updates atol 1e-2 x max|ref| per parameter).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.models import STMask as JSTMask
from stmask_tpu.train.train_step import build_train_step as j_build_train_step

from stmask_torch.convert import state_dict_from_flax

import torch_parallel_worker as W
from test_torch_parallel import LOSSES, TCFG, _steps, flax_params
from test_torch_train_step_parity import _close, _trace
from torch_eval_common import few_torch_threads  # noqa: F401

JCFG = W.reduce(j_get_config('STMask_plus_resnet50'))


def test_global_batch_matches_jax():
    params = flax_params()
    sd = state_dict_from_flax(params)
    batches = [W.global_batch(TCFG, seed) for seed in (0, 1)]
    ref = _steps(sd, batches)
    j_step, j_init = j_build_train_step(JCFG, JSTMask(JCFG))
    j_state = j_init(params)

    def port_keys(tree):
        return {k: v.numpy() for k, v in state_dict_from_flax(
            tree, include_bn=False).items()}

    j_prev_p = port_keys(params)
    j_prev_m = {k: np.zeros_like(v) for k, v in j_prev_p.items()}
    assert set(j_prev_p) == set(ref['grads'][0])
    for i, batch in enumerate(batches):
        j_state, jm = j_step(j_state, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        for k in LOSSES + ('gnorm',):
            np.testing.assert_allclose(ref['metrics'][i][k], float(jm[k]),
                                       rtol=1e-4, err_msg=f'step {i} {k}')
        j_p = port_keys(jax.tree_util.tree_map(np.asarray, j_state.params))
        j_m = port_keys(_trace(j_state.opt_state))
        scale = min(1.0, TCFG.grad_clip_norm / float(jm['gnorm']))
        assert scale < 1.0                      # the clip engaged
        prev = sd if i == 0 else ref['params'][i - 1]
        for k, g in ref['grads'][i].items():
            j_grad = (j_m[k].astype(np.float64) - TCFG.momentum * j_prev_m[k]
                      - TCFG.decay * j_prev_p[k]) / scale
            _close(g, j_grad, f'step {i} grad {k}')
            _close(ref['params'][i][k] - prev[k], j_p[k] - j_prev_p[k],
                   f'step {i} update {k}')
        j_prev_p, j_prev_m = j_p, j_m
    assert isinstance(ref['params'][0][k], torch.Tensor)
