"""The port's training step against the JAX package's on the CPU: the slice
as a whole, and the optimizer alone.

``STMask_plus_resnet50`` at 96x128 with the backbone cut to
``layers=(1, 3, 3, 1)`` (a full-depth JAX step costs minutes on a CPU).
Under ``_dcn_flags`` that keeps five DCN sites: ``layers.1.0``,
``layers.2.0`` and ``layers.3.0`` at stride 2, ``layers.1.2`` and
``layers.2.2`` at stride 1.  One clip of two frames (a persisting, a
vanishing and a new instance) goes through one step of JAX's
``build_train_step`` and of the port's, from the same parameters: BN
statistics and DCN offset predictors perturbed as in
``test_torch_model_parity.py``.  JAX's gradients are read back from its
update (see ``KW``).  A second case zeroes every ``conv_offset_mask``, so
that every offset sits on the bilinear kink.  A third runs three steps with
the BN affine trainable (``freeze_bn=False``) under the overfit gate's
settings (warm-up, ``grad_clip_norm=1e3``); JAX's gradients are read back
from its momentum trace there.

Tolerances: loss values rtol 1e-4 (they agree to ~1e-6); gradients and
updates atol 1e-2 of max|ref| per parameter (floor 1e-6).  Most agree to
5e-5.  The bound is for ReLUs whose pre-activation lies within fp32
rounding of 0: the two frameworks' convolutions sum in another order, so
such a unit can be on in one and off in the other.  One such unit, seen in
a run of this fixture with the model in the contiguous layout, moved one
output channel of ``layers.3.0.conv1``'s weight gradient by 0.97% of
max|ref|.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.convert import convert_state_dict
from stmask_tpu.models import STMask as JSTMask
from stmask_tpu.train.train_step import build_train_step as j_build_train_step

from stmask_torch.config import get_config as t_get_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.models import STMask as TSTMask
from stmask_torch.models.layers import FrozenBatchNorm
from stmask_torch.train.schedule import learning_rate
from stmask_torch.train.train_step import build_train_step as t_build_train_step

from test_torch_model_parity import _perturb
from torch_eval_common import few_torch_threads  # noqa: F401

# lr 1e3 from the first step (no warm-up): JAX's update is then
# -1e3 * (scale * grad + decay * param), large against the parameter, so
# JAX's gradient is read back from its update without cancellation
KW = dict(img_w=128, img_h=96, max_gt_per_frame=6, masks_to_train=16,
          lr=1e3, lr_warmup_until=0, grad_clip_norm=0.0)
J0 = j_get_config('STMask_plus_resnet50')
JCFG = J0.replace(backbone=dataclasses.replace(J0.backbone,
                                               layers=(1, 3, 3, 1)), **KW)
T0 = t_get_config('STMask_plus_resnet50')
TCFG = T0.replace(backbone=dataclasses.replace(T0.backbone,
                                               layers=(1, 3, 3, 1)), **KW)
REL = 1e-2


def _batch(cfg):
    """One clip: ids 1 and 2 in the ref frame, 1 and 3 in the next."""
    rng = np.random.RandomState(7)
    g, hp, wp = cfg.max_gt_per_frame, cfg.pad_h // 4, cfg.pad_w // 4
    images = rng.randn(1, 2, cfg.pad_h, cfg.pad_w, 3).astype(np.float32)
    boxes = np.zeros((1, 2, g, 4), np.float32)
    labels = np.zeros((1, 2, g), np.int32)
    ids = np.zeros((1, 2, g), np.int32)
    valid = np.zeros((1, 2, g), bool)
    masks = np.zeros((1, 2, g, hp, wp), np.uint8)
    objs = {1: (0.1, 0.1, 0.45, 0.55), 2: (0.55, 0.45, 0.9, 0.9),
            3: (0.3, 0.5, 0.7, 0.95)}
    for f, frame_ids in enumerate(((1, 2), (1, 3))):
        for j, gid in enumerate(frame_ids):
            x1, y1, x2, y2 = objs[gid]
            x1, x2 = x1 + 0.03 * f, x2 + 0.03 * f
            boxes[0, f, j] = [x1, y1, x2, y2]
            labels[0, f, j] = gid + 1
            ids[0, f, j] = gid
            valid[0, f, j] = True
            masks[0, f, j, int(y1 * hp):int(y2 * hp),
                  int(x1 * wp):int(x2 * wp)] = 1
    return {'images': images, 'boxes': boxes, 'labels': labels, 'ids': ids,
            'valid': valid, 'masks_proto': masks}


def _lecun(tree, rng):
    """Every conv / dense kernel drawn from flax's default init (LeCun
    normal, variance 1 / fan-in), biases kept at 0: the predictions come
    out O(1), so the losses are not dominated by saturated sigmoids."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _lecun(v, rng)
        elif k == 'kernel':
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = (rng.randn(*v.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        elif k == 'bias':
            out[k] = np.zeros_like(v)
        else:
            out[k] = v
    return out


@pytest.fixture(scope='module')
def setup():
    """Flax parameters (the tree shape from the port's ``state_dict``
    through ``convert_state_dict``, which is cheaper than a flax init;
    kernels from ``_lecun``; BN statistics and DCN offset predictors
    perturbed by ``_perturb``, whose sharper conf head is not taken) and
    JAX's compiled train step."""
    zeros = jax.tree_util.tree_map(np.asarray, convert_state_dict(
        TSTMask(TCFG).state_dict())['params'])
    params = _lecun(zeros, np.random.RandomState(1))
    perturbed = _perturb(params, np.random.RandomState(0))
    perturbed['prediction_head'] = params['prediction_head']
    j_step, j_init = j_build_train_step(JCFG, JSTMask(JCFG))
    return {'params': perturbed}, j_step, j_init


def _zero_offsets(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = (jax.tree_util.tree_map(np.zeros_like, v)
                      if k == 'conv_offset_mask' else _zero_offsets(v))
        else:
            out[k] = v
    return out


def _close(got, want, msg):
    want = np.asarray(want)
    atol = max(REL * float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize('offsets', ['perturbed', 'zero'])
def test_one_train_step_matches_jax(setup, offsets):
    params, j_step, j_init = setup
    if offsets == 'zero':
        params = {'params': _zero_offsets(params['params'])}
    batch = _batch(JCFG)
    j_state, j_metrics = j_step(j_init(params),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    j_new = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, j_state.params), include_bn=False)

    model = TSTMask(TCFG)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    t_step, t_init = t_build_train_step(TCFG, model, device='cpu')
    state, metrics = t_step(t_init(), {k: torch.from_numpy(v)
                                       for k, v in batch.items()})

    assert state.step == 1 and int(state.count) == 1
    for k in ('BIoU', 'C', 'center', 'M', 'T', 'B_shift', 'M_shift',
              'total', 'gnorm'):
        assert np.isfinite(float(metrics[k])), k
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=1e-4, err_msg=k)
    assert metrics['lr'] == pytest.approx(float(j_metrics['lr']), rel=1e-6)
    lr = float(j_metrics['lr'])
    named = dict(model.named_parameters())
    assert set(named) == set(j_new)
    for k, p in named.items():
        p0 = before[k].numpy()
        j_update = j_new[k].numpy() - p0
        j_grad = -j_update / lr - TCFG.decay * p0
        _close(p.grad, j_grad, f'grad {k}')
        _close(p.detach().numpy() - p0, j_update, f'update {k}')
    om = named['backbone.layers.1.0.conv2.conv_offset_mask.weight']
    assert float(om.grad.abs().max()) > 0
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k


def test_optimizer_matches_optax():
    """Four steps of the port's update against optax's chain on random
    parameters and gradients: warm-up lr, the clip engaged, a NaN-injected
    step skipped with the optimizer's count held."""
    cfg = TCFG.replace(lr=1e-2, lr_warmup_init=1e-3, lr_warmup_until=3,
                       grad_clip_norm=2.0)
    jcfg = JCFG.replace(lr=1e-2, lr_warmup_init=1e-3, lr_warmup_until=3,
                        grad_clip_norm=2.0)
    rng = np.random.RandomState(0)
    shapes = {'a': (3, 4), 'b': (5,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    grads[2]['b'][1] = np.nan

    def j_lr(count):
        from stmask_tpu.train.schedule import learning_rate as jl
        return jl(jcfg, count)
    tx = optax.chain(optax.add_decayed_weights(jcfg.decay),
                     optax.sgd(learning_rate=j_lr, momentum=jcfg.momentum))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt = tx.init(jp)
    for g in grads:
        g = {k: jnp.asarray(v) for k, v in g.items()}
        gnorm = optax.global_norm(g)
        finite = jnp.isfinite(gnorm)
        scale = jnp.minimum(1.0, jcfg.grad_clip_norm
                            / jnp.maximum(gnorm, 1e-12))
        g = jax.tree_util.tree_map(
            lambda x: jnp.where(finite, x * scale, 0.0), g)
        upd, new_opt = tx.update(g, opt, jp)
        new_p = optax.apply_updates(jp, upd)
        jp = jax.tree_util.tree_map(lambda n, o: jnp.where(finite, n, o),
                                    new_p, jp)
        opt = jax.tree_util.tree_map(lambda n, o: jnp.where(finite, n, o),
                                     new_opt, opt)

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Parameter(torch.from_numpy(p0['a'].copy()))
            self.b = torch.nn.Parameter(torch.from_numpy(p0['b'].copy()))
            self.g = iter(grads)
            self.temporal_shift = None

        def forward(self, images, train):
            g = next(self.g)
            return (self.a * torch.from_numpy(g['a'])).sum() + \
                (self.b * torch.from_numpy(g['b'])).sum()

    tiny = Tiny()
    import stmask_torch.train.train_step as TS
    orig = TS.compute_losses
    TS.compute_losses = lambda cfg_, preds, gt, priors, fn: {'L': preds}
    try:
        step, init = TS.build_train_step(cfg, tiny, device='cpu')
        state = init()
        counts = []
        for i in range(4):
            state, m = step(state, {'images': torch.zeros(1, 2, 1, 1, 3)})
            counts.append(int(state.count))
            assert m['lr'] == pytest.approx(learning_rate(cfg, i))
    finally:
        TS.compute_losses = orig
    assert counts == [1, 2, 2, 3] and state.step == 4
    for k in shapes:
        np.testing.assert_allclose(getattr(tiny, k).detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


# the overfit gate's optimizer settings (stmask_torch/overfit_sanity.py)
BN_KW = dict(lr=2e-3, lr_warmup_until=100, lr_steps=(10 ** 9,),
             grad_clip_norm=1e3, freeze_bn=False)


@pytest.fixture(scope='module')
def bn_step():
    """JAX's train step with the BN affine trainable, compiled once."""
    jcfg = JCFG.replace(**BN_KW)
    return j_build_train_step(jcfg, JSTMask(jcfg))


def _trace(opt_state):
    """JAX's momentum trace (``u + momentum * m``, before the lr) as a
    flax tree without the masked (frozen) leaves."""
    def drop(tree):
        return {k: drop(v) if isinstance(v, dict) else np.asarray(v)
                for k, v in tree.items()
                if isinstance(v, dict) or not isinstance(v, optax.MaskedNode)}
    return drop(opt_state.inner_states['train'].inner_state[1][0].trace)


def test_trainable_bn_three_steps_match_jax(setup, bn_step):
    params, _, _ = setup
    j_step, j_init = bn_step
    tcfg = TCFG.replace(**BN_KW)
    batch = _batch(JCFG)

    model = TSTMask(tcfg)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    t_step, t_init = t_build_train_step(tcfg, model, device='cpu')
    named = dict(model.named_parameters())
    bn = sorted(f'{n}.{p}' for n, m in model.named_modules()
                if isinstance(m, FrozenBatchNorm) for p in ('weight', 'bias'))
    assert len(bn) == 2 * sum(isinstance(m, FrozenBatchNorm)
                              for m in model.modules()) and set(bn) <= set(
        named)
    assert not any(k.endswith(('running_mean', 'running_var'))
                   for k in named)

    def port_keys(tree):
        return {k: v.numpy() for k, v in state_dict_from_flax(
            tree, include_bn=False, freeze_bn=False).items()}

    j_state, state = j_init(params), t_init()
    j_prev_p = port_keys(params)
    j_prev_m = {k: np.zeros_like(v) for k, v in j_prev_p.items()}
    assert set(j_prev_p) == set(named)
    for i in range(3):
        before = {k: named[k].detach().clone().numpy() for k in bn}
        j_state, j_metrics = j_step(
            j_state, {k: jnp.asarray(v) for k, v in batch.items()})
        state, metrics = t_step(state, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
        for k in ('BIoU', 'C', 'center', 'M', 'T', 'B_shift', 'M_shift',
                  'total', 'gnorm'):
            assert np.isfinite(float(metrics[k])), (i, k)
            np.testing.assert_allclose(float(metrics[k]),
                                       float(j_metrics[k]), rtol=1e-4,
                                       err_msg=f'step {i} {k}')
        j_p = port_keys(jax.tree_util.tree_map(np.asarray, j_state.params))
        j_m = port_keys(_trace(j_state.opt_state))
        scale = min(1.0, tcfg.grad_clip_norm
                    / max(float(j_metrics['gnorm']), 1e-12))
        for k in bn:
            j_grad = (j_m[k].astype(np.float64)
                      - tcfg.momentum * j_prev_m[k]
                      - tcfg.decay * j_prev_p[k]) / scale
            _close(named[k].grad, j_grad, f'step {i} grad {k}')
            _close(named[k].detach().numpy() - before[k],
                   j_p[k] - j_prev_p[k], f'step {i} update {k}')
        j_prev_p, j_prev_m = j_p, j_m
    assert state.step == 3 and int(state.count) == 3
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k
    j_final = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, j_state.params))
    j_first = state_dict_from_flax(params)
    stats = [k for k in j_first if k.endswith(('running_mean',
                                               'running_var'))]
    assert stats
    for k in stats:
        assert torch.equal(j_final[k], j_first[k]), k
