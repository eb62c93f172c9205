"""Lockstep streams: the port's ``build_video_step_batched`` against its own
sequential step and against the JAX package's batched step, in fp32, and
the kept-output fetch against the JAX package's ``eval.py``.

Three lanes over two chunks of two frames: lane 0 runs video A (4
frames), lane 1 video B (2 frames) and then video C from the second
chunk's first step (``is_first`` mid-stream), lane 2 has no video and
steps on zero frames.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stmask_tpu.inference import build_video_step_batched as j_batched

from stmask_torch.inference.fetch import KeptFetch, compact_frame, fetch_kept
from stmask_torch.inference.pipeline import (build_video_step,
                                             build_video_step_batched)

from torch_eval_common import JCFG, TCFG, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401

B, K = 3, 2


def _video(seed, n):
    rng = np.random.RandomState(seed)
    h, w = TCFG.img_h, TCFG.img_w
    coarse = rng.rand(h // 16 + 2, w // 16 + 2, 3)
    base = np.kron(coarse, np.ones((16, 16, 1)))[:h, :w]
    frame = np.clip(base * 200 + rng.rand(h, w, 3) * 55, 0, 255)
    return [np.roll(frame, (2 * i, 3 * i), axis=(0, 1)).astype(np.uint8)
            for i in range(n)]


VIDEOS = {'A': _video(1, 4), 'B': _video(2, 2), 'C': _video(3, 2)}
# per chunk, per step, per lane: (video, frame) or None
SCHEDULE = [[[('A', 0), ('B', 0), None], [('A', 1), ('B', 1), None]],
            [[('A', 2), ('C', 0), None], [('A', 3), ('C', 1), None]]]


def _chunks():
    for plan in SCHEDULE:
        frames = np.zeros((K, B, TCFG.img_h, TCFG.img_w, 3), np.uint8)
        first = np.zeros((K, B), bool)
        for k, step in enumerate(plan):
            for b, slot in enumerate(step):
                if slot is not None:
                    frames[k, b] = VIDEOS[slot[0]][slot[1]]
                    first[k, b] = slot[1] == 0
        yield plan, frames, first


@pytest.fixture(scope='module')
def models():
    jmodel, params = flax_params(seed=1)
    return jmodel, params, port_model(params)


def _port_runs(tmodel):
    chunk, make_states = build_video_step_batched(
        TCFG, tmodel, B, K, uint8_input=True, device='cpu')
    states, outs = make_states(), []
    for _, frames, first in _chunks():
        states, out = chunk(states, frames, first)
        outs.append(out)
    return outs


def test_batched_matches_sequential(models):
    _, _, tmodel = models
    outs = _port_runs(tmodel)
    step, make_state = build_video_step(TCFG, tmodel, uint8_input=True,
                                        device='cpu')
    seq = {}
    for name, frames in VIDEOS.items():
        state = make_state()
        for f, frame in enumerate(frames):
            state, seq[name, f] = step(state, frame, f == 0)
    n_kept = 0
    for out, (plan, _, _) in zip(outs, _chunks()):
        assert out.box.shape == (K, B, TCFG.track_capacity, 4)
        for k, row in enumerate(plan):
            for b, slot in enumerate(row):
                if slot is None:
                    continue
                want = seq[slot]
                for field in ('obj_id', 'keep', 'cls'):
                    torch.testing.assert_close(
                        getattr(out, field)[k, b], getattr(want, field),
                        rtol=0, atol=0, msg=f'{slot} {field}')
                for field in ('box', 'score', 'mask'):
                    torch.testing.assert_close(
                        getattr(out, field)[k, b], getattr(want, field),
                        rtol=0, atol=1e-5, msg=f'{slot} {field}')
                n_kept += int(want.keep.sum())
    assert n_kept > 0


def test_batched_matches_jax(models):
    jmodel, params, tmodel = models
    outs = _port_runs(tmodel)
    chunk, make_states = j_batched(JCFG, jmodel, B, K, uint8_input=True)
    states = make_states()
    for out, (_, frames, first) in zip(outs, _chunks()):
        states, ref = chunk(params, states, jnp.asarray(frames),
                            jnp.asarray(first))
        for field in ('obj_id', 'keep', 'cls'):
            np.testing.assert_array_equal(getattr(out, field).numpy(),
                                          np.asarray(getattr(ref, field)),
                                          err_msg=field)
        for field, atol in (('box', 1e-4), ('score', 1e-4), ('mask', 1e-3)):
            np.testing.assert_allclose(getattr(out, field).numpy(),
                                       np.asarray(getattr(ref, field)),
                                       atol=atol, err_msg=field)


def test_fetch_matches_jax_eval_script(models):
    """``fetch_kept`` / ``compact_frame`` against ``eval.py``'s
    ``_fetch_kept`` / ``_compact_frame`` on the same outputs (one chunk),
    for every (step, lane) and for a single frame."""
    import eval as j_eval       # the JAX package's eval.py, at the root
    _, _, tmodel = models
    out = _port_runs(tmodel)[1]
    j_small, j_idx, j_kept = j_eval._fetch_kept(
        type(out)(*(f.numpy() for f in out)))
    small, idx, kept = KeptFetch(out).result()
    assert set(small) == set(j_small)
    for f in small:
        np.testing.assert_array_equal(small[f], j_small[f])
    for a, b in zip(idx, j_idx):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(kept, j_kept)
    assert kept.shape[0] > 0
    for k in range(K):
        for b in range(B):
            got = compact_frame(small, idx, kept, lead=(k, b))
            want = j_eval._compact_frame(j_small, j_idx, j_kept, lead=(k, b))
            for field, g, w in zip(got._fields, got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=field)
    one = type(out)(*(f[0, 0] for f in out))
    got = compact_frame(*fetch_kept(one))
    assert bool(got.keep.all()) and len(got.keep) == int(one.keep.sum())
    np.testing.assert_array_equal(got.mask.numpy(),
                                  one.mask[one.keep].numpy())
