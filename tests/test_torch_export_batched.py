"""The port's batched serving artifact (``stmask_torch.export``,
``batched=2, chunk_size=3``: the counterpart of ``tests/test_export.py::
test_export_batched``) against the live ``build_video_step_batched`` on
the CPU, on the reduced flagship and weights of
``tests/test_torch_export.py``: the outputs are equal."""

import numpy as np

from stmask_torch import export as E
from stmask_torch.inference.pipeline import build_video_step_batched

from test_torch_eval_batched import _video
from test_torch_export import FRAMES, _equal
from torch_eval_common import TCFG, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401


def test_export_batched(tmp_path):
    model = port_model(flax_params(seed=1)[1])
    b, k = 2, 3
    exported, meta = E.export_video_step(TCFG, model, batched=b,
                                         chunk_size=k, device='cpu')
    path = str(tmp_path / 'batched.stmask')
    E.save_exported(exported, meta, path)
    step, meta2 = E.load_exported(path)
    assert meta2['batched'] == b and meta2['chunk_size'] == k
    assert meta2['frame_shape'] == [k, b, TCFG.img_h, TCFG.img_w, 3]
    frames = np.stack([np.stack([FRAMES[i], _video(5 + i, 1)[0]])
                       for i in range(k)])
    is_first = np.zeros((k, b), bool)
    is_first[0] = True
    chunk, make_states = build_video_step_batched(
        TCFG, model, n_videos=b, chunk_size=k, uint8_input=True,
        device='cpu')
    _, live = chunk(make_states(), frames, is_first)
    states, out = step(step.init_state(), frames, is_first)
    assert all(f.shape[0] == b for f in states)
    assert [list(f.shape[1:]) for f in states] == [
        shape for shape, _ in meta2['state'].values()]
    _equal([out], [live])
