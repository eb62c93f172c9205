"""The eval CLI's other modes (``python -m stmask_torch.eval``) on the CPU,
against the JAX package's ``eval.py`` on the same synthetic YouTube-VIS
set (3 videos of 3 PNG frames at 192x256, resized 2x down to the reduced
flagship's 96x128; gt at 96x128) and the same weights:

* ``--sequential`` without ``--fp32`` runs in fp32, as JAX's sequential
  eval does (it casts nothing): JAX's ``evaluate_dataset`` tracks;
* ``--display --display_lincomb --display_fpn_outs``: JAX's JSON, its
  file set, overlays equal on at least 99.5% of their pixels (boxes are
  cut to int and scores printed to 2 decimals, so an fp32 ulp can move an
  edge) and the grey grids within 2 levels;
* ``--video_dir D --display``: JAX's ``evaluate_video_dir``;
* ``--benchmark``: the stage table (load, step, postprocess, one call a
  frame), ``FPS:``, no JSON;
* ``--metrics_only --tensorboard_dir``: the scalars of an events file.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import eval as j_eval       # the JAX package's eval.py, at the root
from stmask_tpu.utils.logger import ProgressBar as JProgressBar
from stmask_tpu.utils.logger import StageTimer as JStageTimer

from stmask_torch import config as t_config
from stmask_torch import eval as t_eval
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.data.synthetic import write_ytvis_set
from stmask_torch.utils.logger import ProgressBar, StageTimer

from torch_eval_common import JCFG, TCFG, flax_params, same_tracks
from torch_eval_common import few_torch_threads  # noqa: F401

cv2 = pytest.importorskip('cv2')

NAME = 'STMask_plus_resnet50_modestest'
SCORE_ATOL = 1e-4          # fp32 against fp32, as test_torch_eval_cli.py
PIXEL_SHARE = 0.995


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp('modes')
    ann, prefix = write_ytvis_set(str(root), 3, 3, 2 * TCFG.img_h,
                                  2 * TCFG.img_w, seed=2,
                                  gt_hw=(TCFG.img_h, TCFG.img_w))
    jmodel, params = flax_params(seed=2)
    weights = str(root / 'weights.pth')
    torch.save(state_dict_from_flax(params), weights)
    return dict(root=root, ann=ann, prefix=prefix, jmodel=jmodel,
                params=params, weights=weights)


@pytest.fixture(autouse=True, scope='module')
def registered():
    """The reduced flagship under a preset name of its own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(t_config.REGISTRY, NAME, TCFG.replace(name=NAME))
        yield


def _jax(setup, fn, *flags):
    """JAX eval.py's ``fn`` ('evaluate_dataset' or 'evaluate_video_dir')
    with ``flags`` on the reduced flagship."""
    args = j_eval.parse_args(list(flags))
    return getattr(j_eval, fn)(args, JCFG, setup['jmodel'], setup['params'])


def _port(setup, *flags):
    return t_eval.evaluate(['--config', NAME, '--trained_model',
                            setup['weights'], '--device', 'cpu', *flags])


def _data(setup):
    return ['--ann_file', setup['ann'], '--img_prefix', setup['prefix']]


@pytest.fixture(scope='module')
def jax_display(setup):
    """JAX's sequential eval with every --display* flag over 2 videos:
    its results JSON and display directory."""
    out = setup['root'] / 'jax_display'
    _jax(setup, 'evaluate_dataset', *_data(setup), '--display',
         '--display_lincomb', '--display_fpn_outs', '--max_videos', '2',
         '--display_dir', str(out), '--mask_det_file', str(out / 'r.json'))
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith('.png'))


def _equal_share(a_path, b_path) -> float:
    a, b = cv2.imread(str(a_path)), cv2.imread(str(b_path))
    assert a.shape == b.shape, (a_path, a.shape, b.shape)
    return float((a == b).all(-1).mean())


def test_sequential_runs_fp32_like_jax(setup):
    """``--sequential`` without ``--fp32``: the JAX sequential eval's
    tracks (it runs in the fp32 parameters' dtype whatever --bf16 says)."""
    j_out, t_out = setup['root'] / 'jax_seq.json', setup['root'] / 'seq.json'
    j_stats = _jax(setup, 'evaluate_dataset', *_data(setup),
                   '--eval_metrics', '--mask_det_file', str(j_out))
    t_stats = _port(setup, *_data(setup), '--sequential', '--eval_metrics',
                    '--mask_det_file', str(t_out))
    same_tracks(json.loads(t_out.read_text()), json.loads(j_out.read_text()),
                SCORE_ATOL)
    assert t_stats['n_frames'] == 9
    for k in ('mAP', 'AP50', 'AP75', 'AR'):
        assert abs(t_stats[k] - j_stats[k]) <= 1e-6, k


def test_display_matches_jax(setup, jax_display):
    """--display --display_lincomb --display_fpn_outs: the same JSON, the
    same files (an overlay, three proto/ grids and five fpn/ grids a
    frame), overlays equal on 99.5% of pixels, grids within 2 levels."""
    out = setup['root'] / 'port_display'
    stats = _port(setup, *_data(setup), '--display', '--display_lincomb',
                  '--display_fpn_outs', '--max_videos', '2',
                  '--display_dir', str(out), '--mask_det_file',
                  str(out / 'r.json'))
    assert stats['n_frames'] == 6
    same_tracks(json.loads((out / 'r.json').read_text()),
                json.loads((jax_display / 'r.json').read_text()), SCORE_ATOL)
    files = _files(out)
    assert files == _files(jax_display)
    frames = [f for f in files if os.sep not in f]
    assert len(frames) == 6
    assert len([f for f in files if f.startswith('fpn')]) == 5 * 6
    assert {f.rsplit('_', 1)[1] for f in files if f.startswith('fpn')} == {
        f'P{i}.png' for i in range(3, 8)}
    n_proto = len([f for f in files if f.startswith('proto')])
    assert n_proto > 0 and n_proto % 3 == 0
    for f in frames:
        assert _equal_share(out / f, jax_display / f) >= PIXEL_SHARE, f
    for f in files:
        if f in frames:
            continue
        a = cv2.imread(str(out / f), cv2.IMREAD_GRAYSCALE).astype(int)
        b = cv2.imread(str(jax_display / f), cv2.IMREAD_GRAYSCALE).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 2, f
    # each fpn/ grid tiles 4 x 4 channels of its level at 96x128 (P3 is
    # 12x16)
    p3 = cv2.imread(str(out / [f for f in files if f.endswith('P3.png')][0]),
                    cv2.IMREAD_GRAYSCALE)
    assert p3.shape == (4 * TCFG.pad_h // 8, 4 * TCFG.pad_w // 8)


def test_video_dir_matches_jax(setup):
    """--video_dir over one video's frames with --display: JAX's
    ``evaluate_video_dir`` tracks, overlay names and 99.5% of pixels."""
    frames = os.path.join(setup['prefix'], 'video002')
    j_dir, t_dir = setup['root'] / 'jax_vd', setup['root'] / 'port_vd'
    _jax(setup, 'evaluate_video_dir', '--video_dir', frames, '--display',
         '--display_dir', str(j_dir), '--mask_det_file', str(j_dir / 'r.json'))
    stats = _port(setup, '--video_dir', frames, '--display', '--display_dir',
                  str(t_dir), '--mask_det_file', str(t_dir / 'r.json'))
    assert stats['n_frames'] == 3 and stats['e2e_fps'] > 0
    tracks = json.loads((t_dir / 'r.json').read_text())
    assert {t['video_id'] for t in tracks} == {0}
    same_tracks(tracks, json.loads((j_dir / 'r.json').read_text()),
                SCORE_ATOL)
    files = _files(t_dir)
    assert files == _files(j_dir) == [f'00000_{f:04d}.png' for f in range(3)]
    for f in files:
        assert _equal_share(t_dir / f, j_dir / f) >= PIXEL_SHARE, f


def test_video_dir_without_frames(setup, tmp_path):
    assert _port(setup, '--video_dir', str(tmp_path)) == {'n_frames': 0}


def test_benchmark_prints_stage_table_and_fps(setup, capsys):
    """--benchmark: the stages load, step and postprocess, one call a
    frame; FPS over the frames after the fifth; no JSON written."""
    out = setup['root'] / 'bench.json'
    res = _port(setup, *_data(setup), '--benchmark', '--mask_det_file',
                str(out))
    assert not out.exists()
    assert res['n_frames'] == 9
    assert math.isfinite(res['fps']) and res['fps'] > 0
    assert set(res['stages']) == {'load', 'step', 'postprocess'}
    assert all(st['calls'] == 9 for st in res['stages'].values())
    totals = [st['total_s'] for st in res['stages'].values()]
    assert totals == sorted(totals, reverse=True)
    text = capsys.readouterr().out
    assert 'stage' in text and 'total_s   calls   avg_ms' in text
    assert f'FPS: {res["fps"]:.2f}' in text


def test_stage_table_prints_as_jax(capsys):
    """The same table as the JAX package's StageTimer for the same
    totals: the same columns, sorted by total."""
    tables = []
    for cls in (StageTimer, JStageTimer):
        timer = cls()
        timer.totals = {'load': 0.25, 'step': 3.5, 'postprocess': 0.125}
        timer.calls = {'load': 9, 'step': 9, 'postprocess': 9}
        timer.print_stats()
        tables.append(capsys.readouterr().out)
    assert tables[0] == tables[1] and tables[0].splitlines()[1][:4] == 'step'


@pytest.mark.parametrize('length, max_val, val', [
    (10, 100, 0), (10, 100, 55), (30, 7, 7), (30, 7, 12), (5, 0, 1)])
def test_progress_bar_as_jax(length, max_val, val):
    got = ProgressBar(length, max_val)
    want = JProgressBar(length, max_val)
    assert got.set_val(val) == want.set_val(val) == want.get_bar(val)
    assert len(got.get_bar(val)) == length


@pytest.fixture(scope='module')
def results_json(setup):
    out = setup['root'] / 'tb_results.json'
    _port(setup, *_data(setup), '--max_videos', '2', '--batch_videos', '2',
          '--chunk_frames', '3', '--fp32', '--mask_det_file', str(out))
    return out


def test_metrics_only_writes_tensorboard_scalars(setup, results_json):
    """--metrics_only --tensorboard_dir: one events file (suffix VIS) whose
    valid_metrics/* scalars at step 1 are the printed stats."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    tb = setup['root'] / 'tb'
    stats = t_eval.evaluate(['--metrics_only', '--ann_file', setup['ann'],
                             '--mask_det_file', str(results_json),
                             '--tensorboard_dir', str(tb)])
    files = os.listdir(tb)
    assert len(files) == 1 and files[0].endswith('VIS'), files
    acc = EventAccumulator(str(tb))
    acc.Reload()
    assert set(acc.Tags()['scalars']) == {f'valid_metrics/{k}'
                                          for k in stats}
    for k, v in stats.items():
        (ev,) = acc.Scalars(f'valid_metrics/{k}')
        assert ev.step == 1 and ev.value == np.float32(v), k


def test_metrics_only_without_tensorboard(setup, results_json, monkeypatch,
                                          capsys, tmp_path):
    """Where TensorBoard does not import, JAX's message and no file."""
    monkeypatch.setitem(__import__('sys').modules, 'torch.utils.tensorboard',
                        None)
    stats = t_eval.evaluate(['--metrics_only', '--ann_file', setup['ann'],
                             '--mask_det_file', str(results_json),
                             '--tensorboard_dir', str(tmp_path / 'tb')])
    assert set(stats) == {'mAP', 'AP50', 'AP75', 'AR'}
    assert 'tensorboard not available; skipping scalar export' in \
        capsys.readouterr().err
    assert not (tmp_path / 'tb').exists()
