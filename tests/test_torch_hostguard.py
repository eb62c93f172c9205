"""The port's competing-process guard (``stmask_torch.utils.hostguard``):
the cases of ``tests/test_hostguard.py`` on its copy, and the overfit
gate calling it before its timed run."""

import subprocess
import sys
import time

from stmask_torch.utils.hostguard import (competing_processes,
                                          wait_for_quiet_host)


def test_detects_busy_python_process():
    # a CPU-spinning python child is outside our ancestor chain
    p = subprocess.Popen([sys.executable, '-c', 'while True:\n    pass'])
    try:
        time.sleep(0.3)
        busy = competing_processes(sample_s=0.4)
        assert any(b['pid'] == p.pid for b in busy), busy
    finally:
        p.kill()
        p.wait()


def test_quiet_host_returns_immediately():
    rec = wait_for_quiet_host(max_wait_s=5, poll_s=1)
    # quiet, or (under parallel tooling, after the 5 s wait) the record
    # names the competitors
    assert 'competitors' in rec or rec.get('skipped')


def test_env_override_skips(monkeypatch):
    monkeypatch.setenv('STMASK_IGNORE_HOSTGUARD', '1')
    assert wait_for_quiet_host()['skipped']


def test_overfit_gate_waits_for_a_quiet_host(monkeypatch, capsys, tmp_path):
    """``overfit_sanity.main`` asks the guard (for at most 300 s) before it
    writes its set and trains, and prints the record."""
    from stmask_torch import overfit_sanity
    from stmask_torch.utils import hostguard

    calls = []

    class Stop(Exception):
        pass

    def guard(max_wait_s=600.0, poll_s=30.0):
        calls.append(max_wait_s)
        return {'waited_s': 0.0, 'competitors': []}

    def no_dataset(root, *a, **k):
        raise Stop

    monkeypatch.setattr(hostguard, 'wait_for_quiet_host', guard)
    monkeypatch.setattr(overfit_sanity, 'make_dataset', no_dataset)
    try:
        overfit_sanity.main(['--device', 'cpu', '--out', str(tmp_path)])
    except Stop:
        pass
    assert calls == [300.0]
    assert '[hostguard] {"waited_s": 0.0, "competitors": []}' in \
        capsys.readouterr().out
