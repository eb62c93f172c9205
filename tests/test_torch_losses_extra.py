"""The loss keys behind the JAX package's config flags, in the port against
the JAX package: C under ``use_sigmoid_focal_loss``, D
(``mask_proto_coeff_diversity_loss``), P (``mask_proto_loss`` 'l1' and
'disj'), MIoU (``use_maskiou_loss``), I (``use_maskiou``: the mask-IoU
net), E (``use_class_existence_loss``), S
(``use_semantic_segmentation_loss``), the softmax focal loss that no
config reaches, and ``compute_losses`` with every flag on.

The fixture is tests/test_train_parity.py's (F = 4 frames in 2 clips,
P = 300 priors, G = 6 gt slots), plus class-existence logits, P3
semantic logits and P3 gt masks (every other prototype pixel).  Each side
matches its own targets (``match_batch``, held by
test_torch_losses_parity.py).  Compared, JAX's side under ``jax.jit``
(the loss function and its gradient alone): each
value (rtol 1e-5) and its gradient with respect to every prediction and,
for I, to the mask-IoU net's parameters (atol 1e-5 relative to max|ref|:
fp32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.models.maskiou import FastMaskIoUNet as JMaskIoU
from stmask_tpu.train import losses as JL

from stmask_torch.config import get_config as t_get_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.models.maskiou import FastMaskIoUNet as TMaskIoU
from stmask_torch.train import losses as TL

from test_train_parity import CFG, F, HP, PRIORS, WP, _fixture
from torch_eval_common import few_torch_threads  # noqa: F401

REL = 1e-5
TCFG = t_get_config(CFG.name).replace(max_gt_per_frame=CFG.max_gt_per_frame)
C1 = CFG.num_classes - 1
FLAGS = dict(use_sigmoid_focal_loss=True,
             mask_proto_coeff_diversity_loss=True, mask_proto_loss='l1',
             use_maskiou_loss=True, use_maskiou=True,
             use_class_existence_loss=True,
             use_semantic_segmentation_loss=True)


def _inputs(seed):
    preds, gt = _fixture(seed)
    rng = np.random.RandomState(100 + seed)
    preds['classes'] = rng.randn(F, C1).astype(np.float32)
    preds['segm'] = rng.randn(F, HP // 2, WP // 2, C1).astype(np.float32)
    gt['masks_p3'] = np.ascontiguousarray(gt['masks_proto'][..., ::2, ::2])
    del preds['T2S_concat_feat']
    return preds, gt


def _maskiou_nets(seed):
    """The flax mask-IoU net (random parameters, numpy) and the port's with
    the same weights."""
    fnet = JMaskIoU(CFG.num_classes)
    shapes = jax.eval_shape(lambda: fnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, HP, WP, 1))))['params']
    rng = np.random.RandomState(seed)
    params = {'params': jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                   if len(s.shape) == 4 else rng.randn(*s.shape) * 0.1
                   ).astype(np.float32), shapes)}
    tnet = TMaskIoU(CFG.num_classes)
    sd = state_dict_from_flax({'maskiou_net': params['params']})
    tnet.load_state_dict({k[len('maskiou_net.'):]: v for k, v in sd.items()})
    return fnet, params, tnet


def _close(got, want, msg):
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else got.numpy()
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale,
                               err_msg=msg)


def _key_fns(key, fnet, tnet):
    """(cfg overrides, JAX fn(cfg, preds, gt, t, net_params), port fn(cfg,
    preds, gt, t))."""
    jp, tp = jnp.asarray(PRIORS), torch.from_numpy(PRIORS)
    table = {
        'C_focal_sigmoid': (
            dict(use_sigmoid_focal_loss=True),
            lambda c, p, g, t, n: JL.focal_conf_sigmoid_loss(c, p, t),
            lambda c, p, g, t: TL.focal_conf_sigmoid_loss(c, p, t)),
        'focal_softmax': (
            {}, lambda c, p, g, t, n: JL.focal_conf_loss(c, p, t),
            lambda c, p, g, t: TL.focal_conf_loss(c, p, t)),
        'D': (
            dict(mask_proto_coeff_diversity_loss=True),
            lambda c, p, g, t, n: JL.coeff_diversity_loss(c, p, t),
            lambda c, p, g, t: TL.coeff_diversity_loss(c, p, t)),
        'P_l1': (
            dict(mask_proto_loss='l1'),
            lambda c, p, g, t, n: JL.proto_loss(c, p),
            lambda c, p, g, t: TL.proto_loss(c, p)),
        'P_disj': (
            dict(mask_proto_loss='disj'),
            lambda c, p, g, t, n: JL.proto_loss(c, p),
            lambda c, p, g, t: TL.proto_loss(c, p)),
        'MIoU': (
            dict(use_maskiou_loss=True),
            lambda c, p, g, t, n: JL.maskiou_direct_loss(
                c, jp, p, t, g['masks_proto']),
            lambda c, p, g, t: TL.maskiou_direct_loss(
                c, tp, p, t, g['masks_proto'])),
        'I': (
            dict(use_maskiou=True),
            lambda c, p, g, t, n: JL.maskiou_loss(
                c, lambda m: fnet.apply(n, m), jp, p, t, g['masks_proto']),
            lambda c, p, g, t: TL.maskiou_loss(
                c, tnet, tp, p, t, g['masks_proto'])),
        'E': (
            dict(use_class_existence_loss=True),
            lambda c, p, g, t, n: JL.class_existence_loss(
                c, p['classes'], g['labels'], g['valid'],
                c.class_existence_alpha),
            lambda c, p, g, t: TL.class_existence_loss(
                c, p['classes'], g['labels'], g['valid'],
                c.class_existence_alpha)),
        'S': (
            dict(use_semantic_segmentation_loss=True),
            lambda c, p, g, t, n: JL.semantic_segmentation_loss(
                c, p['segm'], g['masks_p3'], g['labels'], g['valid']),
            lambda c, p, g, t: TL.semantic_segmentation_loss(
                c, p['segm'], g['masks_p3'], g['labels'], g['valid'])),
    }
    return table[key]


@pytest.fixture(scope='module')
def fixture():
    """Inputs, the mask-IoU nets and each side's matched targets (the
    flags do not change the match)."""
    preds_np, gt_np = _inputs(0)
    jgt = {k: jnp.asarray(v) for k, v in gt_np.items()}
    jpreds = {k: jnp.asarray(v) for k, v in preds_np.items()}
    jt = JL.match_batch(CFG, jnp.asarray(PRIORS), jpreds, jgt)
    gt = {k: torch.from_numpy(v) for k, v in gt_np.items()}
    t = TL.match_batch(TCFG, torch.from_numpy(PRIORS),
                       {k: torch.from_numpy(v) for k, v in preds_np.items()},
                       gt)
    return preds_np, jpreds, jgt, jt, gt, t, _maskiou_nets(1)


@pytest.mark.parametrize('key', ['C_focal_sigmoid', 'focal_softmax', 'D',
                                 'P_l1', 'P_disj', 'MIoU', 'I', 'E', 'S'])
def test_loss_key_value_and_gradient(key, fixture):
    preds_np, jpreds, jgt, jt, gt, t, (fnet, fparams, tnet) = fixture
    kw, jfn, tfn = _key_fns(key, fnet, tnet)
    jcfg, tcfg = CFG.replace(**kw), TCFG.replace(**kw)
    want, (jg, jng) = jax.jit(jax.value_and_grad(
        lambda p, n, g, mt: jfn(jcfg, p, g, mt, n), argnums=(0, 1)))(
        jpreds, fparams, jgt, jt)

    preds = {k: torch.tensor(v, requires_grad=True)
             for k, v in preds_np.items()}
    tnet.zero_grad()
    got = tfn(tcfg, preds, gt, t)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                               atol=1e-7, err_msg=key)
    assert float(want) != 0.0, key
    if got.requires_grad:
        got.backward()
    n_moved = 0
    for k, p in preds.items():
        _close(p.grad, jg[k], f'd {key} / d {k}')
        n_moved += bool(np.abs(np.asarray(jg[k])).max() > 0)
    # MIoU carries no gradient, and I trains the net alone (its input is
    # detached), as in JAX
    assert (n_moved == 0) == (key in ('MIoU', 'I')), (key, n_moved)
    if key == 'I':
        jng = state_dict_from_flax({'maskiou_net': jng['params']})
        for name, p in tnet.named_parameters():
            _close(p.grad, jng[f'maskiou_net.{name}'],
                   f'd I / d maskiou_net.{name}')


def test_compute_losses_every_flag():
    """Every flag at once (P as 'l1'; 'disj' is held above): the same keys
    as JAX's in the dispatch order (C is the sigmoid focal loss and
    ``center`` is left out), each value, and the gradient of the total
    with respect to every prediction and the mask-IoU net."""
    preds_np, gt_np = _inputs(1)
    fnet, fparams, tnet = _maskiou_nets(2)
    jcfg, tcfg = CFG.replace(**FLAGS), TCFG.replace(**FLAGS)
    jgt = {k: jnp.asarray(v) for k, v in gt_np.items()}

    def loss_fn(preds, n):
        d = JL.compute_losses(jcfg, preds, jgt, jnp.asarray(PRIORS),
                              maskiou_fn=lambda m: fnet.apply(n, m))
        return sum(d.values()), d

    (_, jl), (jg, jng) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in preds_np.items()}, fparams)
    preds = {k: torch.tensor(v, requires_grad=True)
             for k, v in preds_np.items()}
    gt = {k: torch.from_numpy(v) for k, v in gt_np.items()}
    tl = TL.compute_losses(tcfg, preds, gt, torch.from_numpy(PRIORS),
                           maskiou_fn=tnet)
    sum(tl.values()).backward()
    assert list(tl) == ['BIoU', 'C', 'M', 'MIoU', 'D', 'P', 'I', 'E', 'T',
                        'S']
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=f'loss {k}')
    for k, p in preds.items():
        _close(p.grad, jg[k], f'd total / d {k}')
    jng = state_dict_from_flax({'maskiou_net': jng['params']})
    for name, p in tnet.named_parameters():
        _close(p.grad, jng[f'maskiou_net.{name}'],
               f'd total / d maskiou_net.{name}')
