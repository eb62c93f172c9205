"""``stmask_torch.scripts.dcn_clip_rate`` against the JAX script's capture
(``scripts/dcn_clip_rate.py``: flax ``intermediates`` of a training
forward, under ``jax.jit``), on the reduced flagship at 96x128 with the
same weights (``state_dict_from_flax``) and the same frames: one batch of
2 clips of the synthetic overfit set through the port's ``ClipLoader``
(byte for byte the JAX loader's).  The JAX side's statistics are the
script's own loop, copied here."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_torch.scripts import dcn_clip_rate as CR
from torch_eval_common import JCFG, TCFG, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401


def jax_script_stats(cfg, inters):
    """The JAX script's per-site statistics over captured intermediates."""
    stats = {}
    for inter in inters:
        for path, leaf in jax.tree_util.tree_leaves_with_path(inter):
            names = [str(getattr(k, 'key', k)) for k in path]
            if 'dcn_offsets' in names:
                site = '/'.join(n for n in names
                                if n.startswith('layer') or n == 'conv2')
                r_site = cfg.backbone.dcn_window_radius
            elif 'fcb_offsets' in names:
                site = '/'.join(n for n in names if '_align_' in n)
                r_site = cfg.fcb_window_radius
            else:
                continue
            off = np.abs(np.asarray(leaf, np.float32))
            s = stats.setdefault(site, {'n': 0, 'clipped': 0, 'max': 0.0,
                                        'vals': [], 'radius': r_site})
            s['n'] += off.size
            s['clipped'] += int((off > r_site).sum())
            s['max'] = max(s['max'], float(off.max()))
            s['vals'].append(np.percentile(off, 99))
    return stats


@pytest.fixture(scope='module')
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('overfit'))
    return list(CR.loader_batches(TCFG, root, 1))


def test_clip_rates_match_the_jax_capture(frames):
    j_model, params = flax_params(0)
    capture = jax.jit(lambda p, x: j_model.apply(
        p, x, train=True, mutable=['intermediates'])[1])
    want = jax_script_stats(JCFG, [capture(params, jnp.asarray(f))
                                   for f in frames])

    rows = CR.run(TCFG, port_model(params), frames, 'cpu', 'flax_params')
    assert [r['site'] for r in rows] == sorted(want)
    assert len(rows) == 5                       # the reduced R50's sites
    assert any(r['clipped'] for r in rows)      # offsets past the radius
    for r in rows:
        w = want[r['site']]
        assert r['n'] == w['n'] and r['radius'] == w['radius']
        assert abs(r['clipped'] - w['clipped']) <= 1, (r, w['clipped'])
        assert abs(r['max_abs'] - w['max']) <= 1e-5
        assert abs(r['p99'] - float(np.mean(w['vals']))) <= 1e-5


def test_seeded_flax_init_clips_nothing(frames):
    """Without ``--ckpt`` or ``--mirror`` the offsets start at 0 (the
    flax-like init): every share is 0."""
    model, source = CR.load_model(TCFG, 'cpu')
    rows = CR.run(TCFG, model, frames, 'cpu', source)
    assert rows and all(r['clip_pct'] == 0.0 and r['max_abs'] == 0.0
                        for r in rows)
