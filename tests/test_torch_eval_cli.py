"""The port's eval CLI (``python -m stmask_torch.eval``) end to end on the
CPU, against ``evaluate_dataset_batched`` of the JAX package's ``eval.py``
on the same synthetic YouTube-VIS set (3 videos of 3 PNG frames at
192x256, resized 2x down to the model's 96x128, where both resizes agree
exactly; gt at 96x128, the size both eval scripts write their masks at)
and the same weights: the reduced flagship under cc and greedy NMS, and a
reduced legacy YOLACT preset.  Two lanes of two-frame chunks, so a lane
starts its next video mid-chunk and one lane idles at the end."""

import json
import math

import pytest
import torch

from stmask_tpu.utils.ytvis_eval import evaluate_ytvis as j_evaluate_ytvis

from stmask_torch import config as t_config
from stmask_torch import eval as t_eval
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.data.synthetic import write_ytvis_set

from torch_eval_common import (JCFG, JLEG, TCFG, TLEG, flax_params,
                               same_tracks)
from torch_eval_common import few_torch_threads  # noqa: F401

NAME = 'STMask_plus_resnet50_evaltest'


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp('ytvis')
    ann, prefix = write_ytvis_set(str(root), 3, 3, 2 * TCFG.img_h,
                                  2 * TCFG.img_w, seed=2,
                                  gt_hw=(TCFG.img_h, TCFG.img_w))
    jmodel, params = flax_params(seed=2)
    weights = str(root / 'weights.pth')
    torch.save(state_dict_from_flax(params), weights)
    return dict(root=root, ann=ann, prefix=prefix, jmodel=jmodel,
                params=params, weights=weights)


@pytest.fixture
def registered(monkeypatch):
    """The reduced flagship under a preset name of its own."""
    monkeypatch.setitem(t_config.REGISTRY, NAME, TCFG.replace(name=NAME))


def _port(setup, out, *extra):
    return t_eval.evaluate([
        '--config', NAME, '--trained_model', setup['weights'],
        '--ann_file', setup['ann'], '--img_prefix', setup['prefix'],
        '--mask_det_file', str(out), '--device', 'cpu', '--eval_metrics',
        *extra])


def _cli_against_jax(setup, jcfg, jmodel, params, weights, name, tag,
                     flags=()):
    """The port's CLI (fp32, 2 lanes x 2-frame chunks) and the JAX
    eval.py's ``evaluate_dataset_batched`` on ``jcfg`` with the same
    weights: the same tracks, scores within 1e-4, the same metrics."""
    import eval as j_eval       # the JAX package's eval.py, at the root
    j_out = setup['root'] / f'jax_{tag}.json'
    t_out = setup['root'] / f'port_{tag}.json'
    args = j_eval.parse_args([
        '--ann_file', setup['ann'], '--img_prefix', setup['prefix'],
        '--mask_det_file', str(j_out), '--eval_metrics', '--fp32',
        '--batch_videos', '2', '--chunk_frames', '2'])
    j_stats = j_eval.evaluate_dataset_batched(args, jcfg, jmodel, params)
    assert t_eval.main([
        '--config', name, '--trained_model', weights,
        '--ann_file', setup['ann'], '--img_prefix', setup['prefix'],
        '--mask_det_file', str(t_out), '--device', 'cpu', '--fp32',
        '--batch_videos', '2', '--chunk_frames', '2', *flags]) == 0
    same_tracks(json.loads(t_out.read_text()), json.loads(j_out.read_text()),
                 1e-4)
    stats = j_evaluate_ytvis(setup['ann'], str(t_out))
    for k in ('mAP', 'AP50', 'AP75', 'AR'):
        assert abs(stats[k] - j_stats[k]) <= 1e-6, k


def test_cli_matches_jax_eval_script(setup, registered):
    """fp32: the JAX eval.py's tracks, scores within 1e-4."""
    _cli_against_jax(setup, JCFG, setup['jmodel'], setup['params'],
                     setup['weights'], NAME, 'cc')


def test_cli_greedy_nms_matches_jax_eval_script(setup, registered):
    """--nms greedy (exact per-class greedy NMS, B5's plain version on the
    CPU): the JAX eval.py's tracks with ``eval_nms_method='greedy'``."""
    _cli_against_jax(setup, JCFG.replace(eval_nms_method='greedy'),
                     setup['jmodel'], setup['params'], setup['weights'],
                     NAME, 'greedy', ('--nms', 'greedy'))


def test_cli_legacy_preset_matches_jax_eval_script(setup, monkeypatch):
    """--config of a reduced YOLACT_legacy_resnet50 (no TF: the simple
    tracker, whose output is each frame's detections)."""
    name = 'YOLACT_legacy_resnet50_evaltest'
    monkeypatch.setitem(t_config.REGISTRY, name, TLEG.replace(name=name))
    jmodel, params = flax_params(seed=2, cfg=JLEG)
    weights = str(setup['root'] / 'legacy.pth')
    torch.save(state_dict_from_flax(params), weights)
    _cli_against_jax(setup, JLEG, jmodel, params, weights, name, 'legacy')


def test_cli_sequential_equals_batched(setup, registered):
    """fp32: one video at a time gives the batched eval's tracks (the
    CPU's convolutions sum a batch of 2 and of 1 in other orders: scores
    within 1e-5)."""
    a, b = setup['root'] / 'seq.json', setup['root'] / 'bat.json'
    _port(setup, a, '--fp32', '--sequential')
    _port(setup, b, '--fp32', '--batch_videos', '2', '--chunk_frames', '2')
    same_tracks(json.loads(a.read_text()), json.loads(b.read_text()), 1e-5)


def test_cli_bf16_writes_json_and_map(setup, registered):
    """bf16, the default (3 lanes x 2-frame chunks here: the CPU's bf16
    convolutions are slow): a valid results JSON and finite metrics;
    --metrics_only scores the file as the JAX evaluator does."""
    out = setup['root'] / 'bf16.json'
    stats = _port(setup, out, '--batch_videos', '3', '--chunk_frames', '2')
    tracks = json.loads(out.read_text())
    assert tracks and stats['n_frames'] == 9 and stats['n_chunks'] == 2
    for tr in tracks:
        assert set(tr) == {'video_id', 'score', 'category_id',
                           'segmentations'}
        assert len(tr['segmentations']) == 3
        for s in tr['segmentations']:
            assert s is None or s['size'] == [TCFG.img_h, TCFG.img_w]
    for k in ('mAP', 'AP50', 'AP75', 'AR'):
        assert math.isfinite(stats[k]), k
    again = t_eval.evaluate(['--metrics_only', '--ann_file', setup['ann'],
                             '--mask_det_file', str(out)])
    want = j_evaluate_ytvis(setup['ann'], str(out))
    assert all(abs(again[k] - want[k]) <= 1e-12 for k in want)


def test_default_flags():
    args = t_eval.parse_args(['--ann_file', 'a.json', '--nms', 'cc'])
    assert (args.bf16, args.batch_videos, args.chunk_frames, args.device,
            args.sequential) == (True, 8, 4, 'cuda', False)
    assert not t_eval.parse_args(['--fp32']).bf16
