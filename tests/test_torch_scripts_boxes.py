"""The port's host-side scripts against the JAX package's: the anchor
scripts (``bbox_recall``, ``optimize_bboxes``) and
``display_gt_annotations`` print and write what the JAX scripts print and
write on the same seeded inputs; ``convert_weights`` carries a
reference-keyed ``.pth`` into a checkpoint that the eval CLI's loader
reads back unchanged."""

import argparse
import importlib.util
import pickle
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from stmask_torch import config as t_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.data.synthetic import write_ytvis_set
from stmask_torch.scripts import (bbox_recall, convert_weights,
                                  display_gt_annotations, optimize_bboxes)
from torch_eval_common import TCFG, flax_params
from torch_eval_common import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _run_jax_script(name, argv, monkeypatch, capsys):
    """``scripts/<name>.py``'s main() under ``argv``; returns its stdout."""
    monkeypatch.syspath_prepend(str(ROOT / 'scripts'))
    spec = importlib.util.spec_from_file_location(
        f'jax_{name}', ROOT / 'scripts' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, 'argv', [name] + argv)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def _boxes_set(tmp_path):
    return write_ytvis_set(str(tmp_path / 'set'), 3, 4, 72, 96, seed=3)


def test_bbox_recall_matches_jax(tmp_path, monkeypatch, capsys):
    ann, _ = _boxes_set(tmp_path)
    want = _run_jax_script('bbox_recall', ['--ann_file', ann], monkeypatch,
                           capsys)
    assert bbox_recall.main(['--ann_file', ann]) == 0
    got = capsys.readouterr().out
    assert got == want and 'recall@0.5' in got


def test_optimize_bboxes_matches_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.RandomState(5)
    xy = rng.uniform(0, 0.5, (200, 2))
    rows = np.concatenate([xy, xy + rng.uniform(0.05, 0.5, (200, 2))], 1)
    box_file = str(tmp_path / 'boxes.pkl')
    with open(box_file, 'wb') as fh:
        pickle.dump(rows.tolist(), fh)
    want = _run_jax_script('optimize_bboxes', ['--box_file', box_file],
                           monkeypatch, capsys)
    assert optimize_bboxes.main(['--box_file', box_file]) == 0
    got = capsys.readouterr().out
    assert got == want and 'optimized mean best IoU' in got


def test_display_gt_annotations_matches_jax(tmp_path, monkeypatch, capsys):
    ann, prefix = _boxes_set(tmp_path)
    common = ['--ann_file', ann, '--img_prefix', prefix, '--max_videos', '2']
    _run_jax_script('display_gt_annotations',
                    common + ['--out_dir', str(tmp_path / 'jax')],
                    monkeypatch, capsys)
    assert display_gt_annotations.main(
        common + ['--out_dir', str(tmp_path / 'port')]) == 0
    want = sorted((tmp_path / 'jax').glob('*.png'))
    assert [p.name for p in sorted((tmp_path / 'port').glob('*.png'))] == \
        [p.name for p in want] and len(want) == 8
    for p in want:
        assert np.array_equal(cv2.imread(str(tmp_path / 'port' / p.name)),
                              cv2.imread(str(p)))


def test_convert_weights_round_trip(tmp_path, monkeypatch, capsys):
    """A reference-keyed ``.pth`` (``state_dict_from_flax``) through
    ``convert_weights`` and the eval CLI's ``load_model``: every tensor as
    it was in the file, nothing dropped."""
    from stmask_torch.eval import load_model
    monkeypatch.setitem(t_config.REGISTRY, 'scripts_reduced', TCFG)
    sd = state_dict_from_flax(flax_params(0)[1])
    ref, out = str(tmp_path / 'ref.pth'), str(tmp_path / 'out.pth')
    torch.save(sd, ref)
    kept, dropped = convert_weights.run(TCFG, ref, out)
    assert not dropped
    assert convert_weights.main(['--config', 'scripts_reduced',
                                 '--torch_ckpt', ref, '--out', out]) == 0
    assert 'wrote' in capsys.readouterr().out
    args = argparse.Namespace(config='scripts_reduced', trained_model=out,
                              nms=None, nms_as_miou=False, img_w=None,
                              img_h=None)
    _, model = load_model(args)
    got = model.state_dict()
    assert set(kept) == set(got) - set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
