"""JSON-lines training log, console progress bar and the benchmark's stage
timer (port of ``stmask_tpu/utils/logger.py``: ``Log``, ``MovingAverage``,
``ProgressBar``, ``StageTimer``; reference ``utils/logger.py:22-120``,
``utils/functions.py``, ``utils/timer.py``).

One log file per config name: a session header with the device, then one
entry per logged iteration.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, Optional

import torch


def device_info() -> Dict[str, Any]:
    """The CUDA devices and the first one's memory in use, or the CPU."""
    if not torch.cuda.is_available():
        return {'platform': 'cpu', 'count': 1}
    n = torch.cuda.device_count()
    return {'platform': 'gpu', 'count': n,
            'kinds': sorted({torch.cuda.get_device_name(i)
                             for i in range(n)}),
            'bytes_in_use': torch.cuda.memory_allocated(0)}


class Log:
    def __init__(self, config_name: str, log_dir: str = 'logs',
                 session_data: Optional[dict] = None,
                 log_device_stats: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f'{config_name}.log')
        self.log_device_stats = log_device_stats
        self.session_start = time.time()
        self._write({'type': 'session', 'data': session_data or {},
                     'devices': device_info()})

    def _write(self, entry: dict):
        entry['time'] = time.time()
        entry['elapsed'] = entry['time'] - self.session_start
        with open(self.path, 'a') as f:
            f.write(json.dumps(entry, default=float) + '\n')

    def log(self, type_: str, data: Optional[dict] = None, **kw):
        entry = {'type': type_, 'data': {**(data or {}), **kw}}
        if self.log_device_stats:
            entry['devices'] = device_info()
        self._write(entry)


class MovingAverage:
    """Finite-window moving average rejecting non-finite values
    (reference ``utils/functions.py:9-45``)."""

    def __init__(self, max_window_size: int = 1000):
        self.max_window_size = max_window_size
        self.window = []
        self.sum = 0.0

    def append(self, elem: float):
        if not math.isfinite(elem):
            return
        self.window.append(elem)
        self.sum += elem
        if len(self.window) > self.max_window_size:
            self.sum -= self.window.pop(0)

    def get_avg(self) -> float:
        if not self.window:
            return 0.0
        return self.sum / len(self.window)

    def reset(self):
        self.window = []
        self.sum = 0.0

    def __len__(self):
        return len(self.window)


class ProgressBar:
    """Console progress bar (reference utils/functions.py:48-84)."""

    def __init__(self, length: int = 30, max_val: int = 100):
        self.length = length
        self.max_val = max(max_val, 1)

    def get_bar(self, val: int) -> str:
        fill = int(self.length * min(val, self.max_val) / self.max_val)
        return '\u2588' * fill + '\u2591' * (self.length - fill)

    def set_val(self, val: int) -> str:
        return self.get_bar(val)


class StageTimer:
    """Host wall time of named stages, for ``--benchmark``'s table
    (reference ``utils/timer.py``).  CUDA launches return before the device
    finishes, so a stage's time is its host time: a stage that waits for
    the device (the fetch of a step's outputs) carries the device time of
    the stages before it."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    class _Env:
        def __init__(self, timer, name):
            self.timer = timer
            self.name = name

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *a):
            dt = time.perf_counter() - self.t0
            self.timer.totals[self.name] = \
                self.timer.totals.get(self.name, 0.0) + dt
            self.timer.calls[self.name] = \
                self.timer.calls.get(self.name, 0) + 1
            return False

    def env(self, name: str) -> '_Env':
        return self._Env(self, name)

    def stats(self) -> Dict[str, Dict[str, float]]:
        """stage -> {'total_s', 'calls', 'avg_ms'}, by total, largest
        first."""
        return {k: {'total_s': self.totals[k], 'calls': self.calls[k],
                    'avg_ms': 1000 * self.totals[k] / self.calls[k]}
                for k in sorted(self.totals, key=lambda k: -self.totals[k])}

    def print_stats(self):
        if not self.totals:
            return
        width = max(len(k) for k in self.totals)
        print(f'{"stage".ljust(width)}  total_s   calls   avg_ms')
        for k, st in self.stats().items():
            print(f'{k.ljust(width)}  {st["total_s"]:7.3f}  '
                  f'{st["calls"]:6d}  {st["avg_ms"]:7.2f}')
