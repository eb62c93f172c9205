"""B5's boxes entry (``stmask::greedy_nms_plus_one_keep``, the op that
``greedy_nms_per_class`` calls) on the CPU against the JAX package.

The op's CPU kernel is the plain version, ``greedy_nms_mask_reference`` over
``plus_one_iou(boxes[idx] * scale)``; JAX's is ``greedy_nms_mask(boxes,
valid, thr, iou=_plus_one_iou(boxes))``.  Keep flags must be equal, bit for
bit: on seeded fractional boxes at 640 scale, on degenerate boxes (zero
width and area, points, identical, nested, negative area) and on boxes
built so that many pairs' IoU lies within a few ulps of 0.5 (where another
order of operations, or a contracted FMA, flips verdicts).  The kernel is
held to the same inputs on the card in ``tests/test_torch_kernels_cuda.py``.

JAX runs here op by op, as ``_plus_one_iou`` is written.  Under ``jax.jit``
XLA:CPU contracts ``area[None, :]``'s product into ``area[:, None] +
area[None, :]`` (an FMA), which moves ~3% of these IoUs by an ulp and flips
verdicts at the threshold (ROADMAP C.13): the port follows the function as
written.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stmask_tpu.ops import nms as JN

from chip_smoke import _degenerate_boxes, _near_threshold_boxes
from stmask_torch.kernels import greedy_nms as KG
from stmask_torch.ops import nms as TN
from torch_eval_common import few_torch_threads  # noqa: F401


def _j_keep(boxes, valid):
    return jnp.stack([JN.greedy_nms_mask(b, v, 0.5, iou=JN._plus_one_iou(b))
                      for b, v in zip(boxes, valid)])


def _op_keep(boxes, valid, scale=1.0):
    """The op on [G, K, 4] boxes: each group's rows of the flat boxes."""
    g, k, _ = boxes.shape
    idx = torch.arange(g * k).reshape(g, k)
    return KG.greedy_nms_plus_one_keep(
        torch.from_numpy(boxes.reshape(-1, 4)), idx, torch.from_numpy(valid),
        scale, 0.5).numpy()


def _jax_keep(boxes, valid, scale=1.0):
    bx = jnp.asarray(boxes) * scale
    return np.asarray(_j_keep(bx, jnp.asarray(valid)))


@pytest.mark.parametrize('g,k', [(3, 1), (4, 63), (2, 64), (3, 65),
                                 (2, 200)])
def test_op_matches_jax_on_fractional_boxes(g, k):
    """Seeded normalized boxes scaled by 640 in the op (boxes[idx] * 640)
    and in JAX, some invalid slots; the op is the plain version."""
    rng = np.random.RandomState(k)
    lo = rng.uniform(0, 0.7, (g, k, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.02, 0.3, (g, k, 2))],
                           -1).astype(np.float32)
    valid = rng.rand(g, k) < 0.85
    got = _op_keep(boxes, valid, 640.0)
    np.testing.assert_array_equal(got, _jax_keep(boxes, valid, 640.0))
    bx = torch.from_numpy(boxes.reshape(-1, 4))
    idx = torch.arange(g * k).reshape(g, k)
    plain = KG.greedy_nms_plus_one_reference(bx, idx,
                                             torch.from_numpy(valid), 640.0,
                                             0.5).numpy()
    np.testing.assert_array_equal(got, plain)
    assert got.sum() < valid.sum() or k == 1


@pytest.mark.parametrize('seed', [0, 1])
def test_op_matches_jax_on_degenerate_boxes(seed):
    boxes, valid = _degenerate_boxes(3, 130, seed)
    np.testing.assert_array_equal(_op_keep(boxes, valid),
                                  _jax_keep(boxes, valid))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_op_matches_jax_near_the_threshold(seed):
    """Many pairs within 8 ulps of 0.5 (~300 of the 4 groups' pairs, ~115
    within 2), on both sides and at 0.5 itself: the verdicts there depend
    on every rounding."""
    boxes, valid = _near_threshold_boxes(4, 200, seed)
    iou = KG.plus_one_iou(torch.from_numpy(boxes)).numpy()
    upper = np.triu(np.ones((200, 200), bool), 1)
    ulps = (iou - np.float32(0.5)) / np.spacing(np.float32(0.5))
    near = upper & (np.abs(ulps) <= 8)
    assert near.sum() >= 250 and (upper & (ulps == 0)).sum() >= 5
    assert (near & (ulps > 0)).sum() > 100 and (near & (ulps < 0)).sum() > 100
    np.testing.assert_array_equal(_op_keep(boxes, valid),
                                  _jax_keep(boxes, valid))


def test_op_plus_one_iou_is_jaxs():
    """The plain +1-pixel IoU (now in kernels/greedy_nms.py, the name
    ``_plus_one_iou`` kept in ops/nms.py) is JAX's, bit for bit, near the
    threshold and on degenerate boxes."""
    assert TN._plus_one_iou is KG.plus_one_iou
    for boxes in (_near_threshold_boxes(1, 120, 3)[0][0],
                  _degenerate_boxes(1, 120, 3)[0][0]):
        np.testing.assert_array_equal(
            KG.plus_one_iou(torch.from_numpy(boxes)).numpy(),
            np.asarray(JN._plus_one_iou(jnp.asarray(boxes))))


@pytest.mark.parametrize('top_k', [1, 63, 64, 65, 200])
def test_greedy_nms_per_class_matches_jax(top_k):
    """The per-class greedy NMS through the op, against JAX's, at K 1, 63,
    64, 65 and 200 (one class all invalid)."""
    rng = np.random.RandomState(top_k)
    n = 700
    centers = rng.uniform(0.1, 0.8, (6, 2))
    lo = centers[rng.randint(0, 6, n)] + rng.normal(0, 0.03, (n, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.2, (n, 2))],
                           -1).astype(np.float32)
    scores = np.round(rng.rand(5, n), 3).astype(np.float32)
    scores[3] = 0.0
    port = TN.greedy_nms_per_class(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), 0.5, 0.05,
                                   top_k=top_k, max_dets=100, scale=640.0)
    ref = JN.greedy_nms_per_class(jnp.asarray(boxes), jnp.asarray(scores),
                                  0.5, 0.05, top_k=top_k, max_dets=100,
                                  scale=640.0)
    for name, p, r in zip(ref._fields, port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)
    assert port.valid.any()


def test_op_traces_through_export():
    """``torch.export`` of greedy_nms_per_class records the boxes op as one
    node, and no IoU matrix; the exported program equals the eager call."""
    class M(torch.nn.Module):
        def forward(self, boxes, scores):
            return TN.greedy_nms_per_class(boxes, scores, top_k=16,
                                           max_dets=8)

    rng = np.random.RandomState(0)
    lo = rng.uniform(0, 0.7, (50, 2))
    boxes = torch.from_numpy(np.concatenate(
        [lo, lo + rng.uniform(0.05, 0.3, (50, 2))], -1).astype(np.float32))
    scores = torch.from_numpy(rng.rand(4, 50).astype(np.float32))
    ep = torch.export.export(M(), (boxes, scores), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == 'call_function']
    assert targets.count('stmask.greedy_nms_plus_one_keep.default') == 1
    assert 'stmask.greedy_nms_keep.default' not in targets
    for got, want in zip(ep.module()(boxes, scores), M()(boxes, scores)):
        assert torch.equal(got, want)
