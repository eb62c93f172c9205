"""LR schedule: linear warmup + step decay, with batch-size autoscaling
(port of ``stmask_tpu/train/schedule.py``; reference ``train.py:88-96`` and
``train.py:294-302``)."""

from __future__ import annotations

from typing import Union

import torch

from ..config import STMaskConfig


def autoscale(cfg: STMaskConfig, batch_size: int) -> STMaskConfig:
    """Scale lr / max_iter / lr_steps for a batch of ``batch_size`` CLIPS
    (``factor = batch_size * 2 / 8``: the recipe's baseline is 4 clips = 8
    frames, where nothing changes)."""
    factor = batch_size * 2 / 8.0
    if factor == 1.0:
        return cfg
    return cfg.replace(
        lr=cfg.lr * factor,
        max_iter=int(cfg.max_iter / factor),
        lr_steps=tuple(int(s / factor) for s in cfg.lr_steps),
    )


def learning_rate(cfg: STMaskConfig, step: Union[int, torch.Tensor]
                  ) -> Union[float, torch.Tensor]:
    """The learning rate at ``step``: a plain Python float for an int step;
    a float32 tensor on the step's device for a tensor step (the
    optimizer's own count, read without a host sync)."""
    warm = cfg.lr_warmup_until
    if isinstance(step, torch.Tensor):
        s = step.float()
        lr = torch.full_like(s, cfg.lr)
        if warm > 0:
            lr = torch.where(s < warm, (cfg.lr - cfg.lr_warmup_init)
                             * (s / warm) + cfg.lr_warmup_init, lr)
        for b in cfg.lr_steps:
            lr = torch.where(s >= b, lr * cfg.gamma, lr)
        return lr
    lr = cfg.lr
    if warm > 0 and step < warm:
        lr = (cfg.lr - cfg.lr_warmup_init) * (step / warm) + cfg.lr_warmup_init
    for b in cfg.lr_steps:
        if step >= b:
            lr *= cfg.gamma
    return lr
