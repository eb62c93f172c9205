"""The port's ``build_video_scan`` (one stream, K frames a call, ``is_first``
per frame) against its own ``build_video_step`` and against the JAX
package's ``build_video_scan``, and the lane axis's launches: one
correlation and one greedy-NMS call a step however many lanes.

Videos A (4 frames) and B (2 frames) of ``tests/test_torch_eval_batched.py``
stream through chunks of 3 frames: the second chunk holds A's last frame
and B's two, so it spans the boundary (``is_first`` at its second frame).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stmask_tpu.inference import build_video_scan as j_scan

from stmask_torch.inference import build_video_scan
from stmask_torch.inference import tracker as TT
from stmask_torch.inference.pipeline import (build_video_step,
                                             build_video_step_batched,
                                             normalize_pad)
from stmask_torch.ops import nms as TN

from test_torch_eval_batched import VIDEOS
from torch_eval_common import JCFG, TCFG, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401

K = 3
STREAM = [('A', f) for f in range(4)] + [('B', f) for f in range(2)]


@pytest.fixture(scope='module')
def models():
    jmodel, params = flax_params(seed=1)
    return jmodel, params, port_model(params)


def _chunks(float_frames=False):
    """(frames [K, ...], is_first [K]) of each chunk of STREAM: uint8
    frames, or normalized padded float32 ones (what the JAX package's scan
    takes)."""
    for c in range(0, len(STREAM), K):
        part = STREAM[c:c + K]
        frames = np.stack([VIDEOS[v][f] for v, f in part])
        if float_frames:
            frames = normalize_pad(TCFG, torch.from_numpy(frames)).numpy()
        yield frames, np.array([f == 0 for _, f in part])


def _scan_outs(model, float_frames=False):
    chunk, make_state = build_video_scan(TCFG, model, chunk_size=K,
                                         uint8_input=not float_frames,
                                         device='cpu')
    state, outs = make_state(), []
    for frames, first in _chunks(float_frames):
        state, out = chunk(state, frames, first)
        assert out.box.shape == (K, TCFG.track_capacity, 4)
        outs.extend(type(out)(*(x[k] for x in out)) for k in range(K))
    return outs


def test_scan_matches_step(models):
    """Bit for bit: the scan runs the same step."""
    outs = _scan_outs(models[2])
    assert [f for _, f in STREAM[K:K + 2]] == [3, 0]   # spans A and B
    step, make_state = build_video_step(TCFG, models[2], uint8_input=True,
                                        device='cpu')
    kept = 0
    for (v, f), got in zip(STREAM, outs):
        state = make_state() if f == 0 else state
        state, want = step(state, VIDEOS[v][f], f == 0)
        for name, g, w in zip(want._fields, got, want):
            assert torch.equal(g, w), (v, f, name)
        kept += int(want.keep.sum())
    assert kept > 0


def test_scan_matches_jax(models):
    jmodel, params, tmodel = models
    outs = _scan_outs(tmodel, float_frames=True)
    chunk, make_state = j_scan(JCFG, jmodel, chunk_size=K)
    state, k = make_state(), 0
    for frames, first in _chunks(float_frames=True):
        state, ref = chunk(params, state, jnp.asarray(frames),
                           jnp.asarray(first))
        got = type(outs[0])(*(torch.stack(x) for x in zip(*outs[k:k + K])))
        k += K
        for field in ('obj_id', 'keep', 'cls'):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(ref, field)),
                                          err_msg=field)
        for field, atol in (('box', 1e-4), ('score', 1e-4), ('mask', 1e-3)):
            np.testing.assert_allclose(getattr(got, field).numpy(),
                                       np.asarray(getattr(ref, field)),
                                       atol=atol, err_msg=field)
    assert int(np.asarray(state.next_id)) > 0


@pytest.mark.parametrize('method', ['cc', 'greedy'])
def test_one_call_a_step(models, monkeypatch, method):
    """A 3-lane, 2-frame chunk: the correlation (and, under greedy NMS,
    B5's boxes entry) is called once a step, on every lane at once."""
    cfg = TCFG.replace(eval_nms_method=method)
    calls = {'correlate': [], 'greedy': []}
    corr, greedy = TT.correlate, TN.greedy_nms_plus_one_keep

    def counted_corr(x1, x2, *a, **kw):
        calls['correlate'].append(x1.shape[0])
        return corr(x1, x2, *a, **kw)

    def counted_greedy(boxes, idx, *a, **kw):
        calls['greedy'].append((boxes.shape[0], idx.shape[0]))
        return greedy(boxes, idx, *a, **kw)

    monkeypatch.setattr(TT, 'correlate', counted_corr)
    monkeypatch.setattr(TN, 'greedy_nms_plus_one_keep', counted_greedy)
    lanes, steps = 3, 2
    chunk, make_states = build_video_step_batched(
        cfg, models[2], lanes, steps, uint8_input=True, device='cpu')
    frames = np.stack([np.stack([VIDEOS[v][f] for v in 'ABC'])
                       for f in range(steps)])
    first = np.array([[True] * lanes, [False, False, True]])
    states, out = chunk(make_states(), frames, first)
    assert states.next_id.shape == (lanes,)
    assert out.keep.shape == (steps, lanes, cfg.track_capacity)
    assert calls['correlate'] == [lanes] * steps
    want = [(lanes * cfg.num_priors, lanes * (cfg.num_classes - 1))] * steps
    assert calls['greedy'] == (want if method == 'greedy' else [])


def test_wrong_chunk_raises(models):
    chunk, make_state = build_video_scan(TCFG, models[2], chunk_size=K,
                                         uint8_input=True, device='cpu')
    frames, first = next(_chunks())
    with pytest.raises(ValueError, match='must lead with 3'):
        chunk(make_state(), frames[:2], first[:2])
    with pytest.raises(ValueError, match='must lead with 3'):
        chunk(make_state(), frames, first[:2])
