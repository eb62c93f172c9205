"""The profiling scripts run on the CPU at the reduced flagship (96x128)
and print their tables: ``trace_step`` (one-frame; the chunked program in
``test_torch_scripts_parity.py``), ``trace_train``, ``profile_step`` and
``bench_dcn``.  On the CPU the
profiler's host op events stand in for device kernels."""

import pytest

from stmask_torch import config as t_config
from stmask_torch.scripts import (bench_dcn, profile_step, trace_step,
                                  trace_train)
from torch_eval_common import TCFG
from torch_eval_common import few_torch_threads  # noqa: F401

NAME = 'STMask_plus_resnet50_scripts'


def _trace_step(argv):
    assert trace_step.main(['--config', NAME, '--device', 'cpu'] + argv) \
        == 0


CASES = {
    'trace_step': (lambda: _trace_step([]),
                   ['10 frames profiled', 'ms/frame', 'stmask::deform_conv',
                    'idle shares of the profiled window']),
    'trace_train': (
        lambda: trace_train.main(['--config', NAME, '--device', 'cpu',
                                  '--batch_size', '1', '--top', '10']),
        ['step time:', 'ms/step', 'aten::convolution_backward',
         'train_step.backward', 'train_step.update']),
    'profile_step': (
        lambda: profile_step.run(t_config.get_config(NAME), 'cpu', 3),
        ['forward only', 'forward + detect', 'full video step',
         'candidate shift']),
    'bench_dcn': (
        lambda: bench_dcn.run('cpu', 'f32', 2, 2, 2,
                              [('s2b0', 24, 32, 16, 2),
                               ('s3b2', 6, 8, 32, 1)]),
        ['s2b0  [ 12x 16x 16 s2] conv=', 'exact-vs-window maxdiff=0.0000',
         'totals: conv=']),
}


@pytest.mark.parametrize('script', sorted(CASES))
def test_script_prints_its_table(script, monkeypatch, capsys):
    monkeypatch.setitem(t_config.REGISTRY, NAME, TCFG.replace(name=NAME))
    fn, expect = CASES[script]
    fn()
    out = capsys.readouterr().out
    for text in expect:
        assert text in out, (text, out[-2000:])
