"""Timing and profiling helpers shared by ``stmask_torch/scripts/`` and
``chip_smoke.py``.

On a CUDA device the times come from CUDA events and the kernel tables
from ``torch.profiler``'s device events.  On the CPU (the tests) the host
clock times the calls and the profiler's CPU op events stand in for device
events: those rows are host numbers, not a device metric.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    why it could not."""
    try:
        res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60)
    except OSError as e:
        return f'nvidia-smi failed: {e}'
    return res.stdout.strip() or f'nvidia-smi failed: {res.stderr.strip()}'


def sync(device: torch.device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def median_ms(fn: Callable[[], object], repeats: int,
              device: torch.device, warmup: int = 1) -> float:
    """Median ms of one call of ``fn`` over ``repeats`` calls after
    ``warmup`` calls: CUDA events around each call on a CUDA device (the
    time a caller sees, launch cost included), the host clock after a
    synchronize on the CPU."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn()
    sync(dev)
    times = []
    for _ in range(repeats):
        if dev.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn: Callable[[], object], iters: int) -> float:
    """Device ms per call of ``fn`` (CUDA events), with every call enqueued
    behind a sleep kernel so that the kernels run back to back and the
    host's launch cost is hidden.  ``fn`` must launch few kernels (the
    launch queue holds about a thousand)."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 20_000_000
    for _ in range(4):
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > host_ms:   # the queue never drained
            return ev[1].elapsed_time(ev[2]) / iters
        cycles *= 4
    raise RuntimeError('the sleep kernel never outlasted the launches')


def profile(fn: Callable[[], object], iters: int,
            device: torch.device | str = 'cuda', warmup: bool = True):
    """Run ``fn`` once (unless ``warmup`` is False), then ``iters`` times
    under torch.profiler (host and, on a CUDA device, device activity);
    returns the profile."""
    from torch.profiler import ProfilerActivity, profile as _profile
    dev = torch.device(device)
    if warmup:
        fn()
    sync(dev)
    acts = [ProfilerActivity.CPU]
    if dev.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        sync(dev)
    return prof


def device_rows(prof, ranges: Sequence[str] = ()
                ) -> List[Tuple[str, int, float]]:
    """The key_averages() rows of device kernels as (name, count, device
    us); the device-side rows of the ``record_function`` ranges named in
    ``ranges`` span kernels already counted, and are left out."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, 'self_device_time_total', None)
        if us is None:
            us = getattr(e, 'self_cuda_time_total', 0)
        if us > 0 and str(e.device_type).endswith('CUDA') and \
                e.key not in ranges:
            rows.append((e.key, e.count, us))
    return rows


def kernel_rows(prof, device: torch.device | str,
                ranges: Sequence[str] = ()) -> List[Tuple[str, int, float]]:
    """``device_rows`` on a CUDA device; on the CPU the host ops' self
    times (name, count, us), the ``record_function`` ranges left out."""
    if torch.device(device).type == 'cuda':
        return device_rows(prof, ranges)
    return [(e.key, e.count, e.self_cpu_time_total)
            for e in prof.key_averages()
            if e.self_cpu_time_total > 0 and e.key not in ranges
            and not e.key.startswith('ProfilerStep')]


def print_top(rows: List[Tuple[str, int, float]], n_units: int, unit: str,
              top: int = 40) -> float:
    """Print the total and the ``top`` rows by time, with share,
    cumulative share, count and ms a ``unit`` (the columns of the JAX
    package's ``scripts/trace_step.py``); returns the total ms."""
    total = sum(us for _, _, us in rows)
    print(f'total device-op time {total / 1e3:.3f} ms '
          f'({total / 1e3 / max(n_units, 1):.4f} ms/{unit})')
    cum = 0.0
    for i, (name, count, us) in enumerate(
            sorted(rows, key=lambda r: -r[2])[:top]):
        cum += us
        print(f'{i + 1:3d} {us / 1e3:10.3f} ms {100 * us / max(total, 1):5.1f}'
              f'% cum {100 * cum / max(total, 1):5.1f}% x{count:<5d} '
              f'{us / 1e3 / max(n_units, 1):8.4f} ms/{unit}  {name[:90]}')
    return total / 1e3


def _union_us(spans: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, float('-inf')
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_shares(prof, device: torch.device | str) -> Dict[str, float]:
    """Over the profiled window (the first host event's start to the last
    event's end): ``host_idle``, the share in which the profiled thread
    that ran most ran no op; ``device_idle`` on a CUDA device, the share in
    which no kernel ran.  Both from the profiler's own events."""
    events = [e for e in prof.events() if e.time_range.end > 0]
    host = [e for e in events if not str(e.device_type).endswith('CUDA')]
    dev = [e for e in events if str(e.device_type).endswith('CUDA')]
    if not host:
        return {}
    t0 = min(e.time_range.start for e in host)
    t1 = max(e.time_range.end for e in events)
    wall = max(t1 - t0, 1e-9)
    by_thread: Dict[int, List[Tuple[float, float]]] = {}
    for e in host:
        by_thread.setdefault(e.thread, []).append(
            (e.time_range.start, e.time_range.end))
    busy = max(_union_us(s) for s in by_thread.values())
    out = {'window_ms': wall / 1e3, 'host_idle': 1 - busy / wall}
    if torch.device(device).type == 'cuda':
        out['device_idle'] = 1 - _union_us(
            [(e.time_range.start, e.time_range.end) for e in dev]) / wall
    return out


def host_split(prof, span: str):
    """Where the host time of the ``record_function`` ranges named ``span``
    goes: (ranges, mean ms a range, {name: (self ms a range, calls a
    range)}) over the host events of the range's thread that lie inside a
    range.  The range's own self time (key ``span``) is the Python that no
    profiled op covers."""
    import bisect
    host = [e for e in prof.events()
            if not str(e.device_type).endswith('CUDA')]
    ranges = sorted((e.time_range.start, e.time_range.end, e.thread)
                    for e in host if e.name == span)
    if not ranges:
        return 0, 0.0, {}
    starts = [r[0] for r in ranges]
    split = {}
    for e in host:
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i < 0 or e.thread != ranges[i][2] or \
                e.time_range.end > ranges[i][1]:
            continue
        ms, calls = split.get(e.name, (0.0, 0))
        split[e.name] = (ms + e.self_cpu_time_total / 1e3, calls + 1)
    n = len(ranges)
    mean = sum(b - a for a, b, _ in ranges) / n / 1e3
    return n, mean, {k: (ms / n, c / n) for k, (ms, c) in split.items()}


def range_split(prof, prefix: str) -> Dict[str, Tuple[float, int]]:
    """{name: (host ms in all, count)} of the ``record_function`` ranges
    whose name starts with ``prefix``, on the host clock."""
    out: Dict[str, Tuple[float, int]] = {}
    for e in prof.events():
        if e.name.startswith(prefix) and \
                not str(e.device_type).endswith('CUDA'):
            ms, n = out.get(e.name, (0.0, 0))
            out[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
    return out
