"""The training loop over epochs (port of ``train.py:154-277``).

    state = train(cfg, model, epoch_batches, epoch_size, save_folder,
                  log_folder)

``epoch_batches(epoch)`` gives one epoch's batches in ``ClipLoader``'s
format (``ClipLoader.epoch``; ``image_u8=True``: uint8 frames [B, 2,
img_h, img_w, 3], bit-packed gt masks), ``epoch_size`` batches each.  A
``Prefetcher`` thread prepares each batch on the device
(``data.transforms.prepare_batch``) while the step before runs; on the
card it copies from pinned memory on a side stream, and the step's stream
waits for that copy's event.  Epochs that a resumed run has already done
are skipped; delayed settings apply at their exact iteration, with the
loss averages reset (reference ``train.py:278-291``); checkpoints carry
the epoch and iteration in their names and are saved every
``save_interval`` iterations, on Ctrl-C and at the end; ``resume`` takes a
path, ``'latest'`` or ``'interrupt'``.  A step's metrics are copied to the
host behind it and read after the next step is dispatched, so the host
never waits for the step in flight.  ``validate(model, epoch, iteration)``
runs after every ``validation_epoch``-th epoch and its result is logged.
With ``vis_every`` N > 0, every N-th iteration writes the overlays of
its batch to ``vis_dir`` (``utils.visualization.save_train_output``, as
``train.py:243-247``).

Under W processes (``stmask_torch.parallel``), each rank passes its own
shard's batches; the state starts from rank 0's (``parallel.replicate``,
after a resume, which every rank loads).  Only rank 0 saves checkpoints
(on Ctrl-C too), writes the log, validates and writes the overlays; the
others wait for it at a barrier.  That wait lasts a whole validation
pass, so the process group is opened with ``parallel.GROUP_TIMEOUT``
(two hours) instead of torch's default, under which NCCL's watchdog
aborts the waiting ranks after ten minutes.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..config import STMaskConfig
from ..data.loader import Prefetcher
from ..data.transforms import prepare_batch
from ..models.stmask import STMask
from ..parallel.collectives import barrier, rank
from ..parallel.mesh import replicate
from ..utils.logger import Log, MovingAverage
from ..utils.visualization import save_train_output
from .checkpoint import CheckpointManager, InterruptSaver, parse_ckpt_name
from .train_step import TrainState, build_train_step


def _device_put(cfg: STMaskConfig, dev: torch.device) -> Callable:
    """The prefetch thread's put: the batch prepared on ``dev``.  On the
    card the host arrays are pinned and copied on a side stream, and the
    returned event marks the end of the preparation."""
    if dev.type != 'cuda':
        return lambda b: (prepare_batch(cfg, b, dev), None)
    side = torch.cuda.Stream(dev)

    def put(b):
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in b.items()}
        with torch.cuda.stream(side):
            out = prepare_batch(cfg, pinned, dev)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready
    return put


def _on_step_stream(item, dev: torch.device) -> Dict[str, torch.Tensor]:
    """Make the current stream wait for a prefetched batch, and tell the
    allocator that the batch's memory is in use there."""
    batch, ready = item
    if ready is not None:
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(ready)
        for t in batch.values():
            t.record_stream(stream)
    return batch


def train(cfg: STMaskConfig, model: STMask,
          epoch_batches: Callable[[int], Iterable[Dict]], epoch_size: int,
          save_folder: str, log_folder: str, save_interval: int = 10000,
          keep_latest: int = 0, resume: Optional[str] = None,
          device: torch.device | str = 'cuda',
          validate: Optional[Callable[[STMask, int, int], Optional[Dict]]]
          = None, validation_epoch: int = 0,
          session_data: Optional[Dict] = None, vis_every: int = 0,
          vis_dir: str = 'results/train_vis') -> TrainState:
    """Train until ``cfg.max_iter``; returns the final state."""
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
    state = replicate(state)
    main = rank() == 0

    def save(epoch, iteration):
        if main:
            ckpt.save(state, epoch, iteration)
        barrier(dev)

    log = Log(cfg.name, log_folder,
              session_data=session_data or {'config': cfg.name}) \
        if main else None
    loss_avgs: Dict[str, MovingAverage] = {}
    time_avg = MovingAverage()
    pending_delayed = sorted(cfg.delayed_settings)
    iteration = start_iter
    num_epochs = (cfg.max_iter + epoch_size - 1) // epoch_size
    put = _device_put(cfg, dev)

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

    def to_host(metrics):
        """The step's metrics copied to the host behind the step, with the
        event that marks the copy's end."""
        keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
        vals = torch.stack([metrics[k].float() for k in keys])
        host = vals.to('cpu', non_blocking=True)
        done = None
        if dev.type == 'cuda':
            done = torch.cuda.Event()
            done.record()
        rest = {k: v for k, v in metrics.items() if k not in keys}
        return keys, host, done, rest

    def consume(pending):
        (keys, host, done, rest), m_epoch, m_iter = pending
        if done is not None:
            done.synchronize()
        metrics = dict(zip(keys, host.tolist()), **rest)
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
        for epoch in range(num_epochs):
            if (epoch + 1) * epoch_size < iteration:
                continue
            apply_delayed()                 # catch up after a resume
            batches = Prefetcher(iter(epoch_batches(epoch)), put_fn=put)
            pending = None
            t0 = time.perf_counter()
            try:
                for item in batches:
                    if iteration >= cfg.max_iter:
                        break
                    if pending_delayed and iteration >= pending_delayed[0][0]:
                        # the last pre-change step's metrics go into the
                        # old window
                        if pending is not None:
                            consume(pending)
                            pending = None
                        apply_delayed()
                    batch = _on_step_stream(item, dev)
                    state, metrics = train_step(state, batch)
                    iteration += 1
                    if main:
                        saver.update(state, epoch, iteration)
                        if pending is not None:
                            consume(pending)
                        pending = (to_host(metrics), epoch, iteration)
                    time_avg.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    if iteration % save_interval == 0:
                        if main:
                            print('Saving state, iter:', iteration)
                        save(epoch, iteration)
                    if vis_every > 0 and iteration % vis_every == 0:
                        if main:
                            save_train_output(cfg, model, batch, vis_dir,
                                              epoch, iteration)
                        barrier(dev)
            finally:
                batches.close()
            if pending is not None:
                consume(pending)
            if iteration >= cfg.max_iter:
                break
            if (validate is not None and validation_epoch > 0
                    and (epoch + 1) % validation_epoch == 0):
                stats = validate(model, epoch, iteration) if main else None
                if stats:
                    log.log('validation', data=stats, epoch=epoch,
                            iter=iteration)
                barrier(dev)
    save(num_epochs, iteration)
    return state
