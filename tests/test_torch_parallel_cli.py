"""The training CLI as two data-parallel processes on the CPU:

    torchrun --standalone --nproc_per_node=2 RANK_SCRIPT

where each rank registers the reduced flagship of
``tests/torch_parallel_worker.py`` and calls the CLI's ``run`` (what
``python -m stmask_torch.train`` calls) for two steps of one clip a
process over a synthetic set of two videos x three JPEG frames at 96x128.
Rank 0 alone writes the one checkpoint and the log; the ranks end with
identical parameters; each rank's shard of the epoch is the JAX package's
``shard_indices`` of the same index.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from stmask_tpu.data.loader import shard_indices as j_shard_indices
from stmask_tpu.data.ytvis import YTVISDataset as JYTVISDataset

from stmask_torch.data.synthetic import write_ytvis_set

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
NAME = 'STMask_plus_resnet50_dp96'

RANK_SCRIPT = r'''
import json, os, sys
sys.path[:0] = [%(tests)r, %(root)r]
import torch
torch.set_num_threads(2)
import torch_parallel_worker as W
from stmask_torch import config
config.REGISTRY[%(name)r] = W.reduce(
    config.get_config('STMask_plus_resnet50')).replace(name=%(name)r)
from stmask_torch.data.loader import shard_indices
from stmask_torch.parallel import rank, world_size
from stmask_torch.train import __main__ as cli

out = cli.run(sys.argv[1:])
loader = out['loader']
flat = torch.cat([p.detach().reshape(-1)
                  for p in out['state'].model.parameters()])
ref = flat.clone()
torch.distributed.broadcast(ref, src=0)
shard = shard_indices(loader.index, 0 + loader.seed, loader.num_shards,
                      loader.shard_id)
with open(os.path.join(%(work)r, f'rank{rank()}.json'), 'w') as f:
    json.dump({'world': world_size(), 'shards': loader.num_shards,
               'shard_id': loader.shard_id, 'shard': shard,
               'index': loader.index, 'step': out['state'].step,
               'param_diff': float((flat - ref).abs().max()),
               'param_sum': float(flat.double().sum())}, f)
torch.distributed.destroy_process_group()
'''


def test_train_cli_two_processes(tmp_path):
    ann, prefix = write_ytvis_set(str(tmp_path / 'set'), 2, 3, 96, 128,
                                  seed=3, ext='.jpg')
    script = tmp_path / 'rank.py'
    script.write_text(RANK_SCRIPT % dict(tests=TESTS, root=ROOT, name=NAME,
                                         work=str(tmp_path)))
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node=2', str(script),
           '--config', NAME, '--ann_file', ann, '--img_prefix', prefix,
           '--batch_size', '1', '--num_workers', '1', '--max_iter', '2',
           '--save_folder', str(tmp_path / 'w'),
           '--log_folder', str(tmp_path / 'logs'), '--device', 'cpu']
    env = dict(os.environ, OMP_NUM_THREADS='2')
    res = subprocess.run(cmd, cwd=str(tmp_path), env=env, timeout=600,
                         capture_output=True, text=True)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    assert res.stdout.count('backend gloo') == 2, res.stdout[-3000:]

    import json
    ranks = [json.loads((tmp_path / f'rank{r}.json').read_text())
             for r in range(2)]
    assert os.listdir(tmp_path / 'w') == [f'{NAME}_1_2.pth']
    assert os.listdir(tmp_path / 'logs') == [f'{NAME}.log']
    saved = torch.load(tmp_path / 'w' / f'{NAME}_1_2.pth',
                       weights_only=False)
    assert saved is not None
    j_index = JYTVISDataset(ann, prefix).train_index()
    for r, rk in enumerate(ranks):
        assert (rk['world'], rk['shards'], rk['shard_id']) == (2, 2, r)
        assert rk['step'] == 2
        assert rk['param_diff'] == 0.0
        assert [tuple(x) for x in rk['index']] == [tuple(x)
                                                    for x in j_index]
        assert [tuple(x) for x in rk['shard']] == [
            tuple(x) for x in j_shard_indices(j_index, 0, 2, r)]
    assert ranks[0]['param_sum'] == ranks[1]['param_sum']
    # the shards split the epoch's clips
    both = sorted(tuple(x) for rk in ranks for x in rk['shard'])
    assert both == sorted(tuple(x) for x in j_index)
    assert np.isfinite(ranks[0]['param_sum'])
