"""``stmask_torch.scripts.compute_masks`` against the JAX package's
``scripts/compute_masks.py``: ``fit_protos`` bit for bit on the same
arrays, and the reduced flagship's prototypes (the port's, and flax's
under ``jax.jit`` with the same weights) fitted to the same gt masks."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_torch.data.image_io import load_image_rgb
from stmask_torch.data.synthetic import write_ytvis_set
from stmask_torch.data.transforms import preprocess_frame
from stmask_torch.data.ytvis import YTVISDataset
from stmask_torch.scripts import compute_masks as CM
from torch_eval_common import TCFG, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        'jax_compute_masks', ROOT / 'scripts' / 'compute_masks.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('k,n', [(32, 3), (8, 1), (4, 6)])
def test_fit_protos_bit_for_bit(k, n):
    rng = np.random.RandomState(k + n)
    proto = rng.randn(24, 32, k).astype(np.float32)
    gt = (rng.rand(n, 24, 32) > 0.6).astype(np.uint8)
    want = _jax_script().fit_protos(proto, gt)
    got = CM.fit_protos(proto, gt)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_prototype_fits_match_jax(tmp_path):
    ann, prefix = write_ytvis_set(str(tmp_path), 1, 3, 48, 64)
    ds = YTVISDataset(ann, prefix)
    j_model, params = flax_params(0)
    proto_of = jax.jit(lambda p, x: j_model.apply(p, x[None],
                                                  train=False)['proto'][0])
    want = []
    for f in range(2):
        pre = preprocess_frame(TCFG, load_image_rgb(ds.frame_path(1, f)),
                               ds.frame_annots(1, f))
        proto = np.asarray(proto_of(params, jnp.asarray(pre['image'])))
        want.extend(_jax_script().fit_protos(proto, pre['masks_proto'])[1])
    got = CM.run(TCFG, port_model(params), ds, 'cpu', frames=2,
                 out_dir=str(tmp_path / 'fits'))
    assert len(got) == len(want) > 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert len(list((tmp_path / 'fits').glob('*.png'))) == 2
