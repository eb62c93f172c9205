"""Competing-process guard for timed runs (port of
``stmask_tpu/utils/hostguard.py``).

A timed run on a shared host is only as good as the host is quiet:
measurement entry points (``overfit_sanity``) call ``wait_for_quiet_host``
before their timed part, which waits for other CPU-active python
processes to go quiet, or proceeds and records them, so that a
contended run says so.

Pure ``/proc`` sampling, no psutil.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _ancestors() -> set:
    """PIDs of this process and its parent chain (never competitors)."""
    out = set()
    pid = os.getpid()
    while pid > 1 and pid not in out:
        out.add(pid)
        try:
            stat = _read(f'/proc/{pid}/stat')
            # field 4 is the ppid; comm (field 2) may hold spaces, so split
            # after its closing parenthesis
            pid = int(stat.rsplit(')', 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            break
    return out


def _python_cpu_ticks() -> Dict[int, int]:
    """pid -> utime + stime of every python-like process outside our
    chain."""
    skip = _ancestors()
    ticks = {}
    for ent in os.listdir('/proc'):
        if not ent.isdigit() or int(ent) in skip:
            continue
        try:
            comm = _read(f'/proc/{ent}/comm').strip()
            if 'python' not in comm and 'pytest' not in comm:
                continue
            parts = _read(f'/proc/{ent}/stat').rsplit(')', 1)[1].split()
            ticks[int(ent)] = int(parts[11]) + int(parts[12])
        except (OSError, IndexError, ValueError):
            continue
    return ticks


def competing_processes(sample_s: float = 0.6,
                        min_cpu_frac: float = 0.15) -> List[Dict]:
    """Python processes outside our process tree that burn CPU (at least
    ``min_cpu_frac`` of one core over a ``sample_s`` window)."""
    before = _python_cpu_ticks()
    if not before:
        return []
    time.sleep(sample_s)
    after = _python_cpu_ticks()
    hz = os.sysconf('SC_CLK_TCK')
    busy = []
    for pid, t1 in after.items():
        t0 = before.get(pid)
        if t0 is None:
            continue
        frac = (t1 - t0) / hz / sample_s
        if frac >= min_cpu_frac:
            try:
                cmd = _read(f'/proc/{pid}/cmdline').replace('\0', ' ')[:120]
            except OSError:
                cmd = '?'
            busy.append({'pid': pid, 'cpu_frac': round(frac, 2),
                         'cmdline': cmd.strip()})
    return busy


def wait_for_quiet_host(max_wait_s: float = 600.0,
                        poll_s: float = 30.0) -> Dict:
    """Block until no competing python process is CPU-active, for at most
    ``max_wait_s``; returns a record for the run's output.

    It never refuses: the record carries ``competitors``, so a contended
    run describes itself.  ``STMASK_IGNORE_HOSTGUARD=1`` skips the wait
    (nested tooling)."""
    if os.environ.get('STMASK_IGNORE_HOSTGUARD'):
        return {'skipped': True}
    t0 = time.perf_counter()
    while True:
        busy = competing_processes()
        waited = time.perf_counter() - t0
        if not busy:
            return {'waited_s': round(waited, 1), 'competitors': []}
        print(f'[hostguard] WARNING: competing CPU-active python '
              f'process(es) on this host: {busy}; timings taken under '
              f'contention are unreliable', file=sys.stderr, flush=True)
        if waited >= max_wait_s:
            print(f'[hostguard] proceeding CONTENDED after {waited:.0f}s '
                  f'wait; the record names the competitors',
                  file=sys.stderr, flush=True)
            return {'waited_s': round(waited, 1), 'competitors': busy}
        time.sleep(poll_s)
