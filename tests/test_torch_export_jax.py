"""The port's serving artifact against the JAX package's
(``stmask_tpu.export``) on the same converted weights: the reduced
flagship of ``tests/torch_eval_common.py`` with ``flax_params(seed=1)``,
three frames through each loaded artifact, at the eval tolerances of
``tests/test_torch_eval_batched.py`` (ids, kept slots and classes equal;
box and score atol 1e-4, mask atol 1e-3)."""

import numpy as np
import torch

import jax.numpy as jnp

from stmask_tpu.export import export_video_step as j_export
from stmask_tpu.export import load_exported as j_load
from stmask_tpu.export import save_exported as j_save

from stmask_torch import export as E

from test_torch_eval_batched import _video
from torch_eval_common import JCFG, TCFG, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401


def test_artifact_matches_jax_artifact(tmp_path):
    jmodel, params = flax_params(seed=1)
    exported, meta = j_export(JCFG, jmodel, params, uint8_input=True)
    j_save(exported, meta, str(tmp_path / 'jax.stmask'))
    j_step, j_meta = j_load(str(tmp_path / 'jax.stmask'))

    t_exported, t_meta = E.export_video_step(TCFG, port_model(params),
                                             device='cpu')
    E.save_exported(t_exported, t_meta, str(tmp_path / 'port.stmask'))
    t_step, t_meta = E.load_exported(str(tmp_path / 'port.stmask'))
    for key in ('format_version', 'batched', 'chunk_size', 'uint8_input',
                'frame_shape', 'frame_dtype', 'param_dtype', 'img_shape',
                'pad_shape', 'track_capacity'):
        assert t_meta[key] == j_meta[key], key
    assert set(t_meta['state']) == set(j_meta['state'])

    frames = _video(4, 3)
    js, ts = j_step.init_state(), t_step.init_state()
    n_kept = 0
    for k, frame in enumerate(frames):
        js, ref = j_step(js, jnp.asarray(frame), jnp.asarray(k == 0))
        ts, out = t_step(ts, torch.from_numpy(frame), k == 0)
        for field in ('obj_id', 'keep', 'cls'):
            np.testing.assert_array_equal(getattr(out, field).numpy(),
                                          np.asarray(getattr(ref, field)),
                                          err_msg=f'{k} {field}')
        for field, atol in (('box', 1e-4), ('score', 1e-4), ('mask', 1e-3)):
            np.testing.assert_allclose(getattr(out, field).numpy(),
                                       np.asarray(getattr(ref, field)),
                                       atol=atol, err_msg=f'{k} {field}')
        n_kept += int(out.keep.sum())
    assert n_kept > 0
