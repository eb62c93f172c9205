"""The training CLI (``python -m stmask_torch.train``) and the overfit
gate's data on the CPU.

The reduced flagship of ``torch_eval_common`` (``layers=(1, 3, 3, 1)``,
96x128) trains on one synthetic video of two JPEG frames at 96x128, two
clips a step, so that an epoch is one step: step 1, validation (the eval
CLI's batched bf16 path), step 2, then ``--resume latest`` for step 3.
``--init_weights`` is held against the JAX package's
``load_torch_checkpoint`` + ``merge_params``.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from stmask_tpu.convert import (convert_state_dict, load_torch_checkpoint,
                                merge_params)

from stmask_torch import config as t_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.data.synthetic import write_ytvis_set
from stmask_torch.models import STMask as TSTMask
from stmask_torch.models.stmask import init_flax, init_random
from stmask_torch.train import __main__ as cli

from torch_eval_common import TCFG, few_torch_threads  # noqa: F401

NAME = 'STMask_plus_resnet50_cli96'
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def reduced_preset(monkeypatch):
    monkeypatch.setitem(t_config.REGISTRY, NAME, TCFG.replace(name=NAME))
    return NAME


def _argv(tmp_path, ann, prefix, *extra):
    return ['--config', NAME, '--ann_file', ann, '--img_prefix', prefix,
            '--batch_size', '2', '--num_workers', '2',
            '--save_folder', str(tmp_path / 'w'),
            '--log_folder', str(tmp_path / 'logs'), '--device', 'cpu',
            *extra]


def test_train_cli_validates_checkpoints_and_resumes(tmp_path, monkeypatch,
                                                      reduced_preset):
    ann, prefix = write_ytvis_set(str(tmp_path / 'set'), 1, 2, 96, 128,
                                  seed=2, ext='.jpg')
    seen = []

    def checked_validate(args, cfg, model, epoch, iteration):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        stats = validate(args, cfg, model, epoch, iteration)
        after = model.state_dict()
        for k, v in before.items():
            assert after[k].dtype == v.dtype and torch.equal(after[k], v), k
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert model.training
        seen.append((epoch, iteration, stats['mAP']))
        return stats

    validate = cli.validate
    monkeypatch.setattr(cli, 'validate', checked_validate)
    out = cli.run(_argv(tmp_path, ann, prefix, '--max_iter', '2',
                        '--validation_epoch', '1', '--valid_ann_file', ann,
                        '--valid_max_videos', '1'))
    assert out['state'].step == 2 and int(out['state'].count) == 2
    assert seen and seen[0][:2] == (0, 1) and np.isfinite(seen[0][2])
    files = sorted(os.listdir(tmp_path / 'w'))
    assert files == [f'{NAME}_2_2.pth', 'valid_results.json'], files

    assert cli.main(_argv(tmp_path, ann, prefix, '--max_iter', '3',
                          '--resume', 'latest')) == 0
    assert f'{NAME}_3_3.pth' in os.listdir(tmp_path / 'w')
    saved = torch.load(tmp_path / 'w' / f'{NAME}_3_3.pth',
                       weights_only=True)
    assert saved['step'] == 3 and int(saved['count']) == 3
    entries = [json.loads(ln) for ln in open(tmp_path / 'logs'
                                             / f'{NAME}.log')]
    steps = [(e['data']['epoch'], e['data']['iter'])
             for e in entries if e['type'] == 'train']
    assert steps == [(0, 1), (1, 2), (1, 3)], steps    # epoch 0 skipped
    assert [e['type'] for e in entries].count('validation') == 1
    assert all(np.isfinite(e['data']['total']) for e in entries
               if e['type'] == 'train')


def test_init_weights_match_jax_merge_params(tmp_path, reduced_preset):
    """A .pth without the prediction head's tensors: the port's overlay on
    its seed-0 initial weights equals JAX's merge of the converted file on
    the same initial weights; a shape mismatch raises."""
    init = init_flax(TSTMask(TCFG), torch.Generator().manual_seed(0))
    other = init_random(TSTMask(TCFG), torch.Generator().manual_seed(1))
    sd = {k: v for k, v in other.state_dict().items()
          if not k.startswith('prediction_layers.')}
    pth = str(tmp_path / 'partial.pth')
    torch.save({'state_dict': sd}, pth)

    ann, prefix = write_ytvis_set(str(tmp_path / 'set'), 1, 2, 96, 128,
                                  ext='.jpg')
    cli.run(_argv(tmp_path, ann, prefix, '--max_iter', '0',
                  '--init_weights', pth))
    got = torch.load(tmp_path / 'w' / f'{NAME}_0_0.pth',
                     weights_only=True)['model']

    merged = merge_params(convert_state_dict(init.state_dict()),
                          load_torch_checkpoint(pth))
    want = state_dict_from_flax(merged)
    assert set(got) == set(want)
    head = [k for k in want if k.startswith('prediction_layers.')]
    assert head
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
    for k in head:
        assert torch.equal(got[k], init.state_dict()[k]), k
    assert torch.equal(got['fpn.lat_layers.0.weight'],
                       other.state_dict()['fpn.lat_layers.0.weight'])

    sd['fpn.lat_layers.0.weight'] = sd['fpn.lat_layers.0.weight'][:, :8]
    torch.save(sd, pth)
    with pytest.raises(ValueError, match='shape'):
        cli.run(_argv(tmp_path, ann, prefix, '--max_iter', '0',
                      '--init_weights', pth))


def test_train_cli_default_device_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is usable')
    ann, prefix = write_ytvis_set(str(tmp_path / 'set'), 1, 2, 24, 32,
                                  ext='.jpg')
    with pytest.raises(RuntimeError, match='CUDA'):
        cli.main(['--ann_file', ann, '--img_prefix', prefix,
                  '--save_folder', str(tmp_path / 'w'),
                  '--log_folder', str(tmp_path / 'logs')])
    assert not (tmp_path / 'w').exists()


def test_overfit_dataset_matches_jax(tmp_path):
    """The overfit gate's synthetic set (JPEG frames and annotation JSON)
    is the JAX script's, byte for byte, at a reduced size."""
    from stmask_torch.overfit_sanity import make_dataset

    spec = importlib.util.spec_from_file_location(
        'jax_overfit_sanity', os.path.join(ROOT, 'scripts',
                                           'overfit_sanity.py'))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    got = make_dataset(str(tmp_path / 't'), 2, 3, 200, 240)
    want = jax_script.make_dataset(str(tmp_path / 'j'), 2, 3, 200, 240)
    with open(got[0]) as a, open(want[0]) as b:
        assert json.load(a) == json.load(b)
    names = sorted(os.path.relpath(os.path.join(d, f), want[1])
                   for d, _, fs in os.walk(want[1]) for f in fs)
    assert len(names) == 6
    for n in names:
        with open(os.path.join(got[1], n), 'rb') as a, \
                open(os.path.join(want[1], n), 'rb') as b:
            assert a.read() == b.read(), n
