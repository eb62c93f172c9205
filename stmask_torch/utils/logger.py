"""JSON-lines training log (port of ``stmask_tpu/utils/logger.py``:
``Log`` and ``MovingAverage``; reference ``utils/logger.py:22-120``).

One file per config name: a session header with the device, then one
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
