"""The training step (port of ``stmask_tpu/train/train_step.py``).

SGD with momentum and weight decay, as the JAX package's optax chain
(``add_decayed_weights`` then ``sgd``, ``train_step.py:54-66``):

    g  <- g * min(1, grad_clip_norm / max(|g|, 1e-12))   (global norm)
    u  <- g + decay * p
    m  <- u + momentum * m
    p  <- p - lr(count) * m

FrozenBatchNorm statistics and (under ``freeze_bn``, the flagship's
setting) the BN affine are buffers, never parameters, so they are neither
updated nor counted in the norm; with ``freeze_bn=False`` the BN scale and
bias become parameters (``models.layers.set_bn_affine_trainable``) and
train like every other.  When the loss or the gradient norm is not
finite, parameters and momentum keep their values but ``step`` still
advances; ``count``, the optimizer's own step that the learning rate reads,
does not.  The skip is a ``torch.where`` on the card, so a step never waits
for the host.  Parameters and momentum are updated in place (the model
stays channels-last, so does every buffer).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from ..config import STMaskConfig
from ..models.layers import set_bn_affine_trainable
from ..models.stmask import STMask
from ..ops.anchors import all_priors
from ..utils.device import resolve_device
from .losses import compute_losses
from .schedule import learning_rate

GT_KEYS = ('boxes', 'labels', 'ids', 'valid', 'masks_proto', 'masks_p3',
           'crowd_boxes', 'crowd_valid')


class TrainState(NamedTuple):
    model: STMask                  # the parameters, updated in place
    momentum: List[torch.Tensor]   # one buffer per parameter, in order
    count: torch.Tensor            # optimizer steps taken (0-dim int64)
    step: int                      # steps taken, skipped ones included


def build_train_step(cfg: STMaskConfig, model: STMask,
                     device: torch.device | str = 'cuda',
                     remat: bool = False, compute_dtype=None
                     ) -> Tuple[Callable, Callable[[], TrainState]]:
    """Returns (train_step, init_state).

    ``train_step(state, batch) -> (state, metrics)``; batch on the device:
    images [B, 2, H, W, 3] normalized; boxes [B, 2, G, 4]; labels / ids /
    valid [B, 2, G]; masks_proto [B, 2, G, Hp, Wp] uint8; optionally
    crowd_boxes [B, 2, Gc, 4] / crowd_valid [B, 2, Gc] and, for the
    semantic-seg loss S, masks_p3 [B, 2, G, H3, W3].  ``metrics`` holds
    each loss, ``total`` and ``gnorm`` as 0-dim tensors on the device (read
    them when needed) and ``lr``, ``learning_rate(cfg, state.step)``.
    Each parameter's ``.grad`` keeps the step's raw (unclipped) gradient
    until the next step starts.

    The model is moved to ``device`` (default ``cuda``; raises when there
    is no GPU) in the channels-last format, with TF32 off.
    """
    if remat or compute_dtype is not None:
        raise NotImplementedError('remat and compute_dtype are not ported '
                                  '(ROADMAP A.9)')
    dev = resolve_device(device)
    set_bn_affine_trainable(model, not cfg.freeze_bn)
    model.to(device=dev, memory_format=torch.channels_last).train()
    priors = torch.as_tensor(all_priors(cfg), device=dev)
    params = list(model.parameters())

    def loss_fn(batch: Dict[str, torch.Tensor]):
        preds = model(batch['images'], train=True)
        gt = {k: batch[k].reshape((-1,) + batch[k].shape[2:])
              for k in GT_KEYS if k in batch}
        # the mask-IoU net's loss 'I' only where the model has the net
        kw = {'maskiou_fn': model.maskiou} if cfg.use_maskiou else {}
        losses = compute_losses(cfg, preds, gt, priors, model.temporal_shift,
                                **kw)
        return sum(losses.values()), losses

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict]:
        for p in params:
            p.grad = None
        total, losses = loss_fn(batch)
        total.backward()
        with torch.no_grad():
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            gnorm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            finite = torch.isfinite(total) & torch.isfinite(gnorm)
            if cfg.grad_clip_norm > 0:
                scale = torch.clamp(cfg.grad_clip_norm
                                    / torch.clamp(gnorm, min=1e-12), max=1.0)
            else:
                scale = torch.ones_like(gnorm)
            neg_lr = -learning_rate(cfg, state.count)
            upd = torch._foreach_mul(grads, scale)
            torch._foreach_add_(upd, params, alpha=cfg.decay)
            torch._foreach_add_(upd, state.momentum, alpha=cfg.momentum)
            for p, m, n in zip(params, state.momentum, upd):
                m.copy_(torch.where(finite, n, m))
                p.copy_(torch.where(finite, p + n * neg_lr, p))
            count = state.count + finite.long()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics['total'] = total.detach()
        metrics['gnorm'] = gnorm
        metrics['lr'] = learning_rate(cfg, state.step)
        return TrainState(model, state.momentum, count,
                          state.step + 1), metrics

    def init_state() -> TrainState:
        return TrainState(model, [torch.zeros_like(p) for p in params],
                          torch.zeros((), dtype=torch.long, device=dev), 0)

    return train_step, init_state
