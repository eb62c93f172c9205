"""``stmask_torch.scripts.parity_run --dryrun`` on the CPU at 96x128 with
the reduced flagship: the synthetic overfit set (frames at 360x640, gt at
the model's input size), the eval CLI's batched evaluation in process under
cross-class and per-class NMS, both results JSONs, their scores and the
table against BASELINE.md's row.  And ``trace_step --chunked`` (the eval
CLI's batched program) on the CPU at the same size."""

import json
import tempfile

from stmask_torch import config as t_config
from stmask_torch.scripts import parity_run, trace_step
from torch_eval_common import TCFG
from torch_eval_common import few_torch_threads  # noqa: F401


def test_dryrun_writes_both_jsons_and_the_table(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setitem(t_config.REGISTRY, 'STMask_plus_resnet50_dryrun',
                        TCFG.replace(name='STMask_plus_resnet50_dryrun'))
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    out = tmp_path / 'parity'
    assert parity_run.main([
        '--dryrun', '--device', 'cpu', '--img_h', '96', '--img_w', '128',
        '--config', 'STMask_plus_resnet50_dryrun', '--fp32',
        '--batch_videos', '4', '--out_dir', str(out)]) == 0
    text = capsys.readouterr().out
    for nms in ('cc', 'per_class'):
        res = json.loads((out / f'results_{nms}.json').read_text())
        assert res and all(len(t['segmentations']) == 8 for t in res)
    summary = json.loads((out / 'parity_summary.json').read_text())
    assert set(summary['rows']) == {'mAP', 'mAP*'}
    for label, row in summary['rows'].items():
        assert 0.0 <= row['measured'] <= 100.0
        assert row['baseline'] is None           # no row for the preset
        assert f'{label:8s} {row["nms"]:10s}' in text
    assert 'config: STMask_plus_resnet50_dryrun' in text


def test_trace_step_chunked_prints_its_table(monkeypatch, capsys):
    monkeypatch.setitem(t_config.REGISTRY, 'STMask_plus_resnet50_chunked',
                        TCFG.replace(name='STMask_plus_resnet50_chunked'))
    assert trace_step.main(['--config', 'STMask_plus_resnet50_chunked',
                            '--device', 'cpu', '--chunked', '--streams', '1',
                            '--chunk', '2']) == 0
    out = capsys.readouterr().out
    for text in ('8 frames profiled', 'ms/frame', 'stmask::correlate',
                 'idle shares of the profiled window'):
        assert text in out, text
