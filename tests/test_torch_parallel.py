"""The port's data-parallel training step (``stmask_torch.parallel``) on
the CPU: two gloo processes against one process over the global batch
(``tests/test_torch_parallel_jax.py`` holds that batch against the JAX
package's training step).

The reduced flagship of ``tests/test_multiprocess.py`` (96x128,
``layers=(1, 1, 1, 1)``, ``dcn_layers=(0, 1, 1, 1)``) with the gradient
clip engaged (``torch_parallel_worker.KW``).  Global batches of four clips;
rank 0's two clips hold five and four instances a frame pair, rank 1's
two and three, with track ids shared across the shards, so that OHEM's
rank over the batch and T's pairs across the ranks decide the result.
Each rank (``tests/torch_parallel_worker.py``, a process of its own with
two torch threads) takes its two clips through three steps; the third
batch holds NaN frames in rank 1's shard only.

Limits, against one process over the global batch from the same state:
losses and ``gnorm`` rtol 1e-5; raw gradients atol 1e-4 x max|ref| per
parameter in the first step (5.3e-6 measured) and 1e-2 in the second
(7.9e-3 measured; see ``GRAD_REL``), parameters atol that fraction of the
update's max|ref| plus two float32 ulps (rtol 2^-22).  The ranks hold
identical gradients and parameters.  Averaging the losses and gradients
that each shard gives alone (DDP's semantics, with per-shard normalizers)
misses the loss limit and ten times the first step's gradient limit.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from stmask_tpu.convert import convert_state_dict

from stmask_torch.config import get_config as t_get_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.models import STMask as TSTMask
from stmask_torch.train.train_step import build_train_step

import torch_parallel_worker as W
from test_torch_model_parity import _perturb
from test_torch_train_step_parity import _lecun
from torch_eval_common import few_torch_threads  # noqa: F401

TCFG = W.reduce(t_get_config('STMask_plus_resnet50'))
LOSSES = ('BIoU', 'C', 'center', 'M', 'T', 'B_shift', 'M_shift', 'total')
RTOL = 1e-5
# per step: a 1-ulp perturbation of the parameters after the first step
# moves the second step's gradient by up to 8.0e-3 of max|ref| (a ReLU or
# an OHEM cut within rounding of its kink), and the ranks' convolutions
# over two clips round otherwise than one over four
GRAD_REL = (1e-4, 1e-2)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def spawn_ranks(args, world=2):
    """Start ``python args...`` as ``world`` ranks with torchrun's
    environment on a free loopback port; returns the processes."""
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR='localhost', MASTER_PORT=str(port),
                   OMP_NUM_THREADS='2')
        procs.append(subprocess.Popen(
            [sys.executable, *args], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def wait_ranks(procs, timeout=600):
    """Wait for the ranks (killing any left at the timeout); each must exit
    0.  Returns their (returncode, output) pairs."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out in outs:
        assert rc == 0, out[-4000:]
    return outs


def flax_params():
    zeros = jax.tree_util.tree_map(np.asarray, convert_state_dict(
        TSTMask(TCFG).state_dict())['params'])
    params = _lecun(zeros, np.random.RandomState(1))
    perturbed = _perturb(params, np.random.RandomState(0))
    perturbed['prediction_head'] = params['prediction_head']
    return {'params': perturbed}


def _steps(sd, batches, start=None):
    """The port's single process over ``batches`` from the parameters
    ``sd``, or from a rank's state (``start``: its parameters, momentum and
    optimizer count after some steps): the metrics, raw gradients and
    parameters after each step."""
    model = TSTMask(TCFG)
    model.load_state_dict(sd, strict=True)
    step, init = build_train_step(TCFG, model, device='cpu')
    state = init()
    if start is not None:
        params, momentum, count = start
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(params[k])
            for m, v in zip(state.momentum, momentum):
                m.copy_(v)
        state = state._replace(count=torch.tensor(count), step=count)
    out = {'metrics': [], 'grads': [], 'params': []}
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        out['metrics'].append({k: float(v) for k, v in m.items()})
        out['grads'].append({k: p.grad.clone()
                             for k, p in model.named_parameters()})
        out['params'].append({k: p.detach().clone()
                              for k, p in model.named_parameters()})
    return out


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """Both ranks' results; one process over the same global batches: the
    first step from the initial parameters, the second from rank 0's state
    after the first (a float32 rounding apart from one process's own
    trajectory, where a ReLU or OHEM boundary within rounding of a tie
    moves the next gradient by more than the limit); and the averaged
    per-shard control of the first batch."""
    work = tmp_path_factory.mktemp('dp')
    sd = state_dict_from_flax(flax_params())
    batches = [W.global_batch(TCFG, seed) for seed in (0, 1, 2)]
    batches[2]['images'][2:] = np.nan        # rank 1's shard of step 3
    torch.save(sd, work / 'init.pt')
    torch.save(batches, work / 'batches.pt')
    procs = spawn_ranks([W.__file__, str(work)])
    try:
        first = _steps(sd, batches[:1])
        shards = [_steps(sd, [{k: v[2 * r:2 * r + 2]
                               for k, v in batches[0].items()}])
                  for r in range(2)]
    finally:
        wait_ranks(procs)
    ranks = [torch.load(work / f'rank{r}.pt', weights_only=False)
             for r in range(2)]
    r0 = ranks[0]
    second = _steps(sd, batches[1:2], start=(r0['params'][0], r0['momentum'],
                                             1))
    ref = {k: first[k] + second[k] for k in first}
    control = {k: np.mean([s['metrics'][0][k] for s in shards])
               for k in LOSSES}
    control_grads = {k: (shards[0]['grads'][0][k] + shards[1]['grads'][0][k])
                     / 2 for k in shards[0]['grads'][0]}
    return {'sd': sd, 'ref': ref, 'ranks': ranks, 'control': control,
            'control_grads': control_grads}


def test_two_ranks_equal_one_process_over_the_global_batch(run):
    ref, ranks = run['ref'], run['ranks']
    for rk in ranks:
        # rank 1 started from shifted parameters: replicate broadcast rank 0's
        assert rk['param_diff'] == [0.0] * 4
        # (the NaN step's gradients are NaN on both ranks)
        assert rk['grad_diff'][:2] == [0.0] * 2
        for i in range(W.KEEP):
            for k in LOSSES + ('gnorm',):
                np.testing.assert_allclose(
                    rk['metrics'][i][k], ref['metrics'][i][k], rtol=RTOL,
                    err_msg=f'step {i} {k}')
            assert rk['metrics'][i]['lr'] == ref['metrics'][i]['lr']
    got = ranks[0]
    for i in range(W.KEEP):
        prev = run['sd'] if i == 0 else got['params'][i - 1]
        for k, g in ref['grads'][i].items():
            atol = max(GRAD_REL[i] * float(g.abs().max()), 1e-12)
            torch.testing.assert_close(
                got['grads'][i][k], g, rtol=0, atol=atol,
                msg=lambda m: f'step {i} grad {k}: {m}')
            # the parameters within 1e-5 x the update's max, or two
            # float32 ulps of the parameter (p + update rounds to one)
            atol = GRAD_REL[i] * float((ref['params'][i][k]
                                     - prev[k]).abs().max())
            torch.testing.assert_close(
                got['params'][i][k], ref['params'][i][k], rtol=2 ** -22,
                atol=atol, msg=lambda m: f'step {i} params {k}: {m}')
    # the clip engaged: the summed gradient's norm decides it on each rank
    assert ref['metrics'][0]['gnorm'] > TCFG.grad_clip_norm


def test_local_normalizers_miss_the_limit(run):
    """Each shard's losses with its own F, positive counts, OHEM rank and
    T pairs, averaged over the shards: the per-rank losses that DDP would
    average give another value (and so another gradient)."""
    ref = run['ref']['metrics'][0]
    rel = {k: abs(run['control'][k] - ref[k]) / abs(ref[k]) for k in LOSSES}
    assert max(rel.values()) > 100 * RTOL, rel
    assert rel['C'] > RTOL and rel['T'] > RTOL, rel
    grads = run['ref']['grads'][0]
    worst = max(float((run['control_grads'][k] - g).abs().max()
                      / g.abs().max()) for k, g in grads.items()
                if g.abs().max() > 0)
    assert worst > 10 * GRAD_REL[0], worst


def test_nonfinite_shard_skips_the_step_on_every_rank(run):
    for rk in run['ranks']:
        assert not np.isfinite(rk['metrics'][2]['total'])
        assert rk['unchanged'] == [False, False, True]
        assert rk['count'] == 2 and rk['step'] == 3


def test_initialize_multihost_reads_torchrun_environment(monkeypatch):
    """The group comes from torchrun's variables alone, gloo for CPU
    ranks, with a timeout that covers rank 0's validation while the
    others wait at a barrier; a world of one opens nothing."""
    import torch.distributed as dist
    from stmask_torch.parallel import GROUP_TIMEOUT, initialize_multihost

    opened = []
    monkeypatch.setattr(dist, 'init_process_group',
                        lambda *a, **kw: opened.append((a, kw)))
    monkeypatch.setenv('WORLD_SIZE', '1')
    assert initialize_multihost(device='cpu') == torch.device('cpu')
    assert not opened
    monkeypatch.setenv('WORLD_SIZE', '3')
    monkeypatch.setenv('RANK', '2')
    monkeypatch.setenv('MASTER_ADDR', 'localhost')
    monkeypatch.setenv('MASTER_PORT', '12345')
    assert initialize_multihost(device='cpu') == torch.device('cpu')
    assert opened == [(('gloo',), dict(
        init_method='tcp://localhost:12345', world_size=3, rank=2,
        timeout=GROUP_TIMEOUT))]
    assert GROUP_TIMEOUT.total_seconds() >= 3600
