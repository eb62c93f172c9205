"""The port's serving artifact (``stmask_torch.export``) on the CPU: the
counterparts of ``tests/test_export.py``'s two cases, on the reduced
flagship of ``tests/torch_eval_common.py`` with the weights of
``flax_params(seed=1)`` carried over by ``state_dict_from_flax``.

The single-stream artifact is written by the CLI (``python -m
stmask_torch.export`` with ``--trained_model`` a reference-keyed ``.pth``
named after the reduced preset and no ``--config``)
and held over three frames to the live ``build_video_step`` on the same
weights, in this process and in a fresh one that imports no model code
(``tests/test_torch_export_batched.py`` holds the batched artifact).  On
the CPU both run the same plain versions in the same order, so the
outputs are equal.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from stmask_torch import config as t_config
from stmask_torch import export as E
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.inference.pipeline import build_video_step

from test_torch_eval_batched import _video
from torch_eval_common import TCFG, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401

NAME = 'STMask_plus_resnet50_export96'
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = _video(4, 3)


@pytest.fixture(scope='module')
def single(tmp_path_factory):
    """(artifact path, live model): the CLI's export of the reduced preset
    with the converted weights, its config taken from the checkpoint's
    name."""
    d = tmp_path_factory.mktemp('export')
    _, params = flax_params(seed=1)
    ckpt = str(d / f'{NAME}_1_10.pth')
    torch.save(state_dict_from_flax(params), ckpt)
    path = str(d / 'single.stmask')
    mp = pytest.MonkeyPatch()
    mp.setitem(t_config.REGISTRY, NAME, TCFG.replace(name=NAME))
    try:
        assert E.main(['--trained_model', ckpt, '--device', 'cpu',
                       '--out', path]) == 0
    finally:
        mp.undo()
    return path, port_model(params)


def _live(model, n=3):
    step, make_state = build_video_step(TCFG, model, uint8_input=True,
                                        device='cpu')
    state, outs = make_state(), []
    for k in range(n):
        state, out = step(state, FRAMES[k], torch.tensor(k == 0))
        outs.append(out)
    return outs


def _run(step, n=3):
    state, outs = step.init_state(), []
    for k in range(n):
        state, out = step(state, FRAMES[k], k == 0)
        outs.append(out)
    return outs


def _equal(got, want):
    n_kept = 0
    for g, w in zip(got, want):
        for field in w._fields:
            assert torch.equal(getattr(g, field), getattr(w, field)), field
        n_kept += int(w.keep.sum())
    assert n_kept > 0


def test_export_single_stream_roundtrip(single):
    path, model = single
    want = _live(model)            # moves the model to the channels-last layout
    step, meta = E.load_exported(path, 'cpu')
    assert meta['config'] == NAME and meta['platforms'] == ['cpu']
    assert meta['frame_shape'] == [TCFG.img_h, TCFG.img_w, 3]
    assert meta['frame_dtype'] == 'uint8' and meta['param_dtype'] == 'float32'
    assert meta['track_capacity'] == TCFG.track_capacity
    # the program's weights: the model's, in its layout, on the device
    weights = dict(step._fn.named_parameters())
    weights.update(dict(step._fn.named_buffers()))
    own = dict(model.named_parameters())
    own.update(dict(model.named_buffers()))
    assert {f'model.{k}' for k in own} <= set(weights)
    for k, v in own.items():
        w = weights[f'model.{k}']
        assert w.device.type == 'cpu' and w.stride() == v.stride(), k
        assert torch.equal(w, v), k
    _equal(_run(step), want)


LOADER = r'''
import sys
sys.path.insert(0, %(root)r)
import torch
torch.set_num_threads(2)
from stmask_torch.export import load_exported
step, meta = load_exported(%(path)r, 'cpu')
frames = torch.load(%(frames)r)
state, outs = step.init_state(), []
for k, f in enumerate(frames):
    state, out = step(state, f, k == 0)
    outs.append(tuple(out))
torch.save(outs, %(out)r)
print(sorted(m for m in sys.modules if m.startswith('stmask_torch.')))
'''


def test_artifact_loads_without_the_model_code(single, tmp_path):
    """A fresh process loads and runs the artifact with ``stmask_torch``'s
    export module alone: no module of ``stmask_torch.models`` (nor the
    pipeline or the config registry's presets' code) is imported."""
    path, model = single
    torch.save([torch.from_numpy(f) for f in FRAMES], tmp_path / 'f.pt')
    code = LOADER % dict(root=ROOT, path=path, frames=str(tmp_path / 'f.pt'),
                         out=str(tmp_path / 'o.pt'))
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert res.returncode == 0, res.stderr[-3000:]
    mods = json.loads(res.stdout.strip().splitlines()[-1].replace("'", '"'))
    assert 'stmask_torch.export' in mods
    assert not [m for m in mods if m.startswith(('stmask_torch.models',
                                                 'stmask_torch.inference.'
                                                 'pipeline'))], mods
    got = torch.load(tmp_path / 'o.pt')
    want = _live(model)
    _equal([type(w)(*g) for g, w in zip(got, want)], want)


def test_load_refusals_and_bench(single, monkeypatch):
    path, _ = single
    with pytest.raises(ValueError, match='exported for cpu'):
        E.load_exported(path, 'cuda')
    rec = E.bench_artifact(path, 1, target_frames=2, device='cpu')
    assert rec['value'] > 0 and rec['batched'] == 0
    monkeypatch.setattr(E, '__version__', '2')
    with pytest.raises(ValueError, match='format'):
        E.load_exported(path, 'cpu')


def test_checkpoint_lacking_a_tensor_is_refused(single, tmp_path,
                                                monkeypatch):
    """A checkpoint without one of the model's tensors raises before the
    export: no artifact comes out with seeded weights in its place."""
    _, model = single
    sd = dict(model.state_dict())
    del sd[next(iter(sd))]
    ckpt = str(tmp_path / f'{NAME}_1_10.pth')
    torch.save(sd, ckpt)
    monkeypatch.setitem(t_config.REGISTRY, NAME, TCFG.replace(name=NAME))
    out = tmp_path / 'never.stmask'
    with pytest.raises(KeyError, match='lacks 1 of the model'):
        E.main(['--trained_model', ckpt, '--device', 'cpu',
                '--out', str(out)])
    assert not out.exists()
