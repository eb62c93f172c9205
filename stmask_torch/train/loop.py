"""The training loop (port of ``train.py:154-251``, without the data
loading and the in-train validation).

    state = train(cfg, model, batches, save_folder, log_folder)

``batches`` is any iterator of batches in ``ClipLoader``'s format
(``image_u8=True``: uint8 frames [B, 2, img_h, img_w, 3], bit-packed gt
masks, numpy or tensors); each is prepared on the device
(``data.transforms.prepare_batch``).  Delayed settings apply at their exact
iteration, with the loss averages reset (reference ``train.py:278-291``);
checkpoints are saved every ``save_interval`` iterations, on Ctrl-C and at
the end; ``resume`` takes a path, ``'latest'`` or ``'interrupt'``.  A
step's metrics are read after the next step is dispatched, so the host
never waits on the card inside the loop.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

import torch

from ..config import STMaskConfig
from ..data.transforms import prepare_batch
from ..models.stmask import STMask
from ..utils.logger import Log, MovingAverage
from .checkpoint import CheckpointManager, InterruptSaver, parse_ckpt_name
from .train_step import TrainState, build_train_step


def train(cfg: STMaskConfig, model: STMask, batches: Iterable[Dict],
          save_folder: str, log_folder: str, save_interval: int = 10000,
          keep_latest: int = 0, resume: Optional[str] = None,
          device: torch.device | str = 'cuda') -> TrainState:
    """Train until ``cfg.max_iter`` or the end of ``batches``; returns the
    final state.  ``batches`` is one stream, so checkpoint names and the
    log carry epoch 0."""
    train_step, init_state = build_train_step(cfg, model, device)
    state = init_state()
    dev = state.count.device
    ckpt = CheckpointManager(save_folder, cfg.name, keep_latest=keep_latest)
    start_iter = 0
    if resume:
        path = {'latest': ckpt.get_latest(),
                'interrupt': ckpt.get_interrupt()}.get(resume, resume)
        if path:
            state = ckpt.restore(path, state)
            parsed = parse_ckpt_name(path)
            if parsed:
                start_iter = parsed[2]
            print(f'Resumed from {path} at iteration {start_iter}')

    log = Log(cfg.name, log_folder, session_data={'config': cfg.name})
    loss_avgs: Dict[str, MovingAverage] = {}
    time_avg = MovingAverage()
    pending_delayed = sorted(cfg.delayed_settings)
    iteration = start_iter

    def apply_delayed():
        nonlocal cfg, train_step
        changed = False
        while pending_delayed and iteration >= pending_delayed[0][0]:
            _, changes = pending_delayed.pop(0)
            cfg = cfg.replace(**dict(changes))
            print('Applying delayed settings:', dict(changes))
            changed = True
        if changed:
            train_step, _ = build_train_step(cfg, model, dev)
            for avg in loss_avgs.values():
                avg.reset()

    def consume(pending):
        metrics, m_epoch, m_iter = pending
        metrics = {k: float(v) for k, v in metrics.items()}
        for k, v in metrics.items():
            loss_avgs.setdefault(k, MovingAverage(100)).append(v)
        if m_iter % 10 == 0:
            eta = (cfg.max_iter - m_iter) * time_avg.get_avg()
            msg = ' '.join(f'{k}: {loss_avgs[k].get_avg():.3f}'
                           for k in sorted(loss_avgs))
            print(f'[{m_epoch:3d}] {m_iter:7d} | {msg} | '
                  f'ETA: {eta / 3600:.2f}h')
        log.log('train', data=metrics, epoch=m_epoch, iter=m_iter)

    with InterruptSaver(ckpt) as saver:
        apply_delayed()                 # catch up after a resume
        pending = None
        t0 = time.perf_counter()
        for batch in batches:
            if iteration >= cfg.max_iter:
                break
            if pending_delayed and iteration >= pending_delayed[0][0]:
                # the last pre-change step's metrics go into the old window
                if pending is not None:
                    consume(pending)
                    pending = None
                apply_delayed()
            state, metrics = train_step(state, prepare_batch(cfg, batch,
                                                             dev))
            iteration += 1
            saver.update(state, 0, iteration)
            if pending is not None:
                consume(pending)
            pending = (metrics, 0, iteration)
            time_avg.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            if iteration % save_interval == 0:
                print('Saving state, iter:', iteration)
                ckpt.save(state, 0, iteration)
        if pending is not None:
            consume(pending)
    ckpt.save(state, 0, iteration)
    return state
