"""Checkpoints of the train state: save, restore, prune, interrupt (port of
``stmask_tpu/train/checkpoint.py`` with ``torch.save`` / ``torch.load``).

Names follow the JAX package's codec ``<config>_<epoch>_<iter>`` with an
``_interrupt`` suffix for a Ctrl-C save (reference ``utils/functions.py:
96-159``); the file adds ``.pth``.  A checkpoint holds the model's
``state_dict`` (reference key names), the momentum buffers, the
optimizer's count and the step, so a restored run continues exactly.
"""

from __future__ import annotations

import os
import re
import signal
from typing import Optional, Tuple

import torch

from .train_step import TrainState

_NAME_RE = re.compile(r'^(.*)_(\d+)_(\d+)(_interrupt)?(?:\.pth)?$')


def ckpt_name(config_name: str, epoch: int, iteration: int,
              interrupt: bool = False) -> str:
    suffix = '_interrupt' if interrupt else ''
    return f'{config_name}_{epoch}_{iteration}{suffix}'


def parse_ckpt_name(name: str) -> Optional[Tuple[str, int, int, bool]]:
    m = _NAME_RE.match(os.path.basename(name.rstrip('/')))
    if not m:
        return None
    return m.group(1), int(m.group(2)), int(m.group(3)), bool(m.group(4))


class CheckpointManager:
    def __init__(self, save_dir: str, config_name: str,
                 keep_latest: int = 0):
        self.save_dir = os.path.abspath(save_dir)
        self.config_name = config_name
        self.keep_latest = keep_latest
        os.makedirs(self.save_dir, exist_ok=True)

    def save(self, state: TrainState, epoch: int, iteration: int,
             interrupt: bool = False) -> str:
        path = os.path.join(self.save_dir, ckpt_name(
            self.config_name, epoch, iteration, interrupt) + '.pth')
        tmp = f'{path}.{os.getpid()}.tmp'       # renamed: never half written
        torch.save({'model': state.model.state_dict(),
                    'momentum': list(state.momentum), 'count': state.count,
                    'step': state.step}, tmp)
        os.replace(tmp, path)
        if self.keep_latest > 0 and not interrupt:
            self._prune()
        return path

    def restore(self, path: str, state: TrainState) -> TrainState:
        """Load ``path`` into ``state`` in place (the tensors keep their
        device and channels-last strides) and return it with the saved
        count and step."""
        dev = state.count.device
        saved = torch.load(os.path.abspath(path), map_location=dev,
                           weights_only=True)
        state.model.load_state_dict(saved['model'])
        if len(saved['momentum']) != len(state.momentum):
            raise ValueError(f'{path}: {len(saved["momentum"])} momentum '
                             f'buffers, the model has {len(state.momentum)}')
        with torch.no_grad():
            for m, v in zip(state.momentum, saved['momentum']):
                m.copy_(v)
        return TrainState(state.model, state.momentum,
                          saved['count'].to(dev), int(saved['step']))

    def _list(self):
        out = []
        for name in os.listdir(self.save_dir):
            parsed = parse_ckpt_name(name)
            if parsed and parsed[0] == self.config_name \
                    and name.endswith('.pth'):
                out.append((parsed[2], parsed[3], name))
        return sorted(out)

    def _prune(self):
        ckpts = [c for c in self._list() if not c[1]]
        for _, _, name in ckpts[:-self.keep_latest]:
            os.remove(os.path.join(self.save_dir, name))

    def get_latest(self) -> Optional[str]:
        ckpts = [c for c in self._list() if not c[1]]
        return os.path.join(self.save_dir, ckpts[-1][2]) if ckpts else None

    def get_interrupt(self) -> Optional[str]:
        ckpts = [c for c in self._list() if c[1]]
        return os.path.join(self.save_dir, ckpts[-1][2]) if ckpts else None


class InterruptSaver:
    """SIGINT handler that checkpoints before exiting (reference
    ``train.py:382-389``)."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager
        self.state = None
        self.epoch = 0
        self.iteration = 0
        self._orig = None

    def update(self, state: TrainState, epoch: int, iteration: int):
        self.state = state
        self.epoch = epoch
        self.iteration = iteration

    def __enter__(self):
        def handler(signum, frame):
            if self.state is not None:
                print('Stopping early. Saving interrupt checkpoint...')
                self.manager.save(self.state, self.epoch, self.iteration,
                                  interrupt=True)
            raise SystemExit(0)

        self._orig = signal.signal(signal.SIGINT, handler)
        return self

    def __exit__(self, *a):
        signal.signal(signal.SIGINT, self._orig)
        return False
