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

Under W processes (``stmask_torch.parallel``; the same parameters on every
rank, ``parallel.replicate``) each rank's losses are its shares of the
batch-global losses (``losses.py``); the step sums the shares' gradients
and the losses over the ranks in one ``all_reduce``, so that the norm, the
clip, the non-finite skip and the update are those of the single-process
step over the rank-ordered concatenation of the shards, on every rank: a
rank whose own shard is finite skips the step when another's is not.

``remat`` and ``compute_dtype`` are the JAX package's
(``train_step.py:69-100``).  ``remat`` wraps the model's forward (the
casts included) in ``torch.utils.checkpoint``: its activations are
recomputed in the backward instead of kept.  ``compute_dtype=
torch.bfloat16`` runs that forward through ``torch.func.functional_call``
on bf16 copies of every fp32 parameter and buffer (the frozen-BN
statistics too) and on bf16 images, and casts the bf16 predictions back
to fp32 before the losses.  The losses' TemporalNet and mask-IoU net run
on the fp32 parameters, as JAX's ``temporal_net_fn`` and ``maskiou_fn``
close over the uncast ones.  The casts are differentiable, so every
gradient reaches its fp32 parameter in fp32 (after the bf16 rounding of
the weight cotangent); the norm, the clip, the skip, the update and the
sum over ranks stay fp32.  On the CPU the bf16 step runs its forward and
backward with oneDNN off (``without_onednn``).

The step's parts are ``torch.profiler`` ranges, ``train_step.forward``,
``.losses``, ``.backward`` and ``.update`` (``scripts/trace_train.py``
splits the step's host time by them).
"""

from __future__ import annotations

import contextlib
from itertools import chain
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
import torch.utils.checkpoint
from torch.profiler import record_function

from ..config import STMaskConfig
from ..models.layers import set_bn_affine_trainable
from ..models.stmask import STMask
from ..ops.anchors import all_priors
from ..parallel.collectives import world_size
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
    them when needed; the batch-global values on every rank) and ``lr``,
    ``learning_rate(cfg, state.step)``.  Each parameter's ``.grad`` keeps
    the step's raw (unclipped) gradient of the whole batch until the next
    step starts.

    The model is moved to ``device`` (default ``cuda``; raises when there
    is no GPU) in the channels-last format, with TF32 off.  ``remat``
    recomputes the forward in the backward; ``compute_dtype`` is None,
    ``torch.float32`` (the same step) or ``torch.bfloat16`` (the forward
    and its backward in bf16, everything else fp32; see the top).
    """
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f'compute_dtype {compute_dtype}: None, '
                         'torch.float32 or torch.bfloat16')
    dev = resolve_device(device)
    set_bn_affine_trainable(model, not cfg.freeze_bn)
    model.to(device=dev, memory_format=torch.channels_last).train()
    priors = torch.as_tensor(all_priors(cfg), device=dev)
    params = list(model.parameters())

    def forward(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        if compute_dtype != torch.bfloat16:
            return model(images, train=True)
        cast = {n: t.to(compute_dtype) if t.dtype == torch.float32 else t
                for n, t in chain(model.named_parameters(),
                                  model.named_buffers())}
        preds = torch.func.functional_call(
            model, cast, (images.to(compute_dtype),), {'train': True})
        return {k: v.float() if v.dtype == compute_dtype else v
                for k, v in preds.items()}

    if remat:
        plain_forward = forward

        def forward(images: torch.Tensor) -> Dict[str, torch.Tensor]:
            return torch.utils.checkpoint.checkpoint(
                plain_forward, images, use_reentrant=False)

    def loss_fn(batch: Dict[str, torch.Tensor]):
        with record_function('train_step.forward'):
            preds = forward(batch['images'])
        with record_function('train_step.losses'):
            gt = {k: batch[k].reshape((-1,) + batch[k].shape[2:])
                  for k in GT_KEYS if k in batch}
            # the mask-IoU net's loss 'I' only where the model has the net
            kw = {'maskiou_fn': model.maskiou} if cfg.use_maskiou else {}
            losses = compute_losses(cfg, preds, gt, priors,
                                    model.temporal_shift, **kw)
            return sum(losses.values()), losses

    # the CPU's bf16 step without oneDNN (see without_onednn)
    onednn = (without_onednn if dev.type == 'cpu'
              and compute_dtype == torch.bfloat16 else contextlib.nullcontext)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict]:
        for p in params:
            p.grad = None
        with onednn():
            total, losses = loss_fn(batch)
            with record_function('train_step.backward'):
                total.backward()
        with torch.no_grad(), record_function('train_step.update'):
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            if world_size() > 1:
                total, losses = _sum_over_ranks(params, grads, total, losses)
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


@contextlib.contextmanager
def without_onednn():
    """oneDNN off while the context is open: the bf16 step's forward and
    backward on the CPU.

    oneDNN v3.12.0 (torch 2.13.0+cpu, AVX512) computes the weight gradient
    of a bf16 channels-last conv with a 5x3 kernel and padding (2, 1) over a
    1x1 map (an FCA bank's 5x3 kernel at P7 of a 96x128 input) from memory
    it never wrote: values up to 1e34, or inf, that change from call to
    call.  3x3, 3x5 and 1x1 kernels, and larger maps, are right.  torch's
    own CPU convolutions are used instead.  On the card cuDNN runs them.
    """
    before = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = before


def _sum_over_ranks(params: List[torch.Tensor], grads: List[torch.Tensor],
                    total: torch.Tensor, losses: Dict[str, torch.Tensor]):
    """Sum the gradients (written back into ``grads`` and each ``.grad``)
    and the losses over the ranks, in one ``all_reduce`` of a flat buffer;
    returns the summed (total, losses)."""
    keys = list(losses)
    vals = torch.stack([total.detach()] + [losses[k].detach() for k in keys])
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [vals.to(grads[0].dtype)])
    torch.distributed.all_reduce(flat)
    off = 0
    for p, g in zip(params, grads):
        g.copy_(flat[off:off + g.numel()].view(g.shape))
        p.grad = g
        off += g.numel()
    vals = flat[off:]
    return vals[0], dict(zip(keys, vals[1:]))
