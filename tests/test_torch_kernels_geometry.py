"""K4's tile geometry on the CPU: every input pixel that the plain col2im
scatters into, or reads for its dot products, from the output sites of one
tile lies inside the footprint that the wrapper computes for that tile; and
the wrapper's shared memory fits the card at the training sites."""

import numpy as np
import pytest
import torch

from stmask_torch.kernels.deform_col2im import (SMEM_LIMIT, col2im_plan,
                                                deform_col2im_reference,
                                                footprint, footprint_origin)

RADIUS = 2
H, W = 13, 21                # no multiple of any tile: ragged last tiles
# offsets in [-r, r]: the integers (3 x 3 corner pairs) and the ends
VALUES = [-2.0, -1.5, -1.0, -0.3, 0.0, 0.7, 1.0, 1.5, 2.0]
# the 7 DCN sites of the flagship's training step: (H, W, Cin), stride
TRAIN_SITES = [((96, 160, 128), 2), ((48, 80, 128), 1), ((48, 80, 256), 2),
               ((24, 40, 256), 1), ((24, 40, 256), 1), ((24, 40, 512), 2),
               ((12, 20, 512), 1)]


def _tiles(ho, wo, ty, tx):
    """(oy0, ox0) of every tile: interior, each edge and the ragged last."""
    return [(oy0, ox0) for oy0 in range(0, ho, ty)
            for ox0 in range(0, wo, tx)]


def check_footprint(kh, kw, stride, dilation, fast=False, hw=(H, W)):
    """Every corner the plain col2im touches from a tile of the plan's lies
    in the tile's footprint (the general plan, or with ``fast`` the bf16
    fast route's), on an ``hw`` image of one channel."""
    h, w = hw
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    k = kh * kw
    plan = col2im_plan(1, ho, wo, 1, kh, kw, stride, dilation, RADIUS, fast)
    assert (plan.fh, plan.fw) == footprint(plan.ty, plan.tx, kh, kw, stride,
                                           dilation, RADIUS)
    rng = np.random.RandomState(kh * 10 + kw + stride + dilation)
    offsets = [rng.choice(VALUES, (1, ho, wo, 2 * k))] + [
        np.full((1, ho, wo, 2 * k), v) for v in (-2.0, 2.0, 0.0)]
    offsets.append(np.stack([np.full((1, ho, wo, k), -2.0),
                             np.full((1, ho, wo, k), 2.0)], -1).reshape(
                                 1, ho, wo, 2 * k))
    mask = torch.ones(1, ho, wo, k, dtype=torch.float64)
    tiles = _tiles(ho, wo, plan.ty, plan.tx)
    assert len(tiles) > 4
    scattered = 0                # (tile, offsets) cases with an in-image dx
    for oy0, ox0 in tiles:
        y0, x0 = footprint_origin(oy0, ox0, kh, kw, stride, dilation,
                                  RADIUS)
        inside = torch.zeros(1, h, w, 1, dtype=torch.bool)
        inside[0, max(y0, 0):max(y0 + plan.fh, 0),
               max(x0, 0):max(x0 + plan.fw, 0)] = True
        site = torch.zeros(1, ho, wo, 1, dtype=torch.float64)
        site[0, oy0:oy0 + plan.ty, ox0:ox0 + plan.tx] = 1.0
        dcols = site.expand(1, ho, wo, k).reshape(ho * wo, k)
        x_out = torch.from_numpy(rng.uniform(1.0, 2.0, (1, h, w, 1)))
        x_out = x_out * ~inside
        for off in offsets:
            off = torch.from_numpy(off)
            # scatter: dcols of the tile's sites only, all positive
            dx, _, _ = deform_col2im_reference(
                dcols, torch.zeros(1, h, w, 1, dtype=torch.float64), off,
                mask, kh, kw, stride, dilation, RADIUS)
            assert float(dx[~inside].abs().sum()) == 0.0, (oy0, ox0)
            scattered += float(dx.sum()) > 0.0
            # reads: x zero inside the footprint, positive outside
            _, d_off, d_mask = deform_col2im_reference(
                dcols, x_out, off, mask, kh, kw, stride, dilation, RADIUS)
            sl = (0, slice(oy0, oy0 + plan.ty), slice(ox0, ox0 + plan.tx))
            assert float(d_off[sl].abs().max()) == 0.0, (oy0, ox0)
            assert float(d_mask[sl].abs().max()) == 0.0, (oy0, ox0)
    assert scattered > len(tiles)
    return plan


@pytest.mark.parametrize('kh,kw,stride,dilation', [
    (3, 3, 1, 1), (3, 3, 2, 1), (3, 5, 1, 1), (5, 3, 1, 1), (3, 3, 1, 2)])
def test_footprint_holds_every_corner(kh, kw, stride, dilation):
    check_footprint(kh, kw, stride, dilation)


@pytest.mark.parametrize('shape,stride', TRAIN_SITES)
def test_plan_fits_the_card_at_the_training_sites(shape, stride):
    h, w, cin = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    plan = col2im_plan(8, ho, wo, cin, 3, 3, stride, 1, RADIUS)
    fh, fw = footprint(plan.ty, plan.tx, 3, 3, stride, 1, RADIUS)
    items = plan.ty * plan.tx * 9
    assert plan.smem == 4 * ((fh * fw + items) * 34 + items * 24
                             + 2 * fh * fw + 2)
    assert plan.smem <= SMEM_LIMIT == 227 * 1024
    # a block for each of the 132 SMs, no split without a chunk
    assert plan.blocks >= 132
    chunks = -(-cin // 32)
    per = -(-chunks // plan.n_split)
    assert per * (plan.n_split - 1) < chunks


# FCB's 15 sites at 384x640: P3..P7, Cin 256, stride 1, v1, each level
# under 3x3, 3x5 and 5x3 taps (P7's 3x5 under 5x3 taps: every footprint
# past both edges; P6's 6x10 off every tile); a training step's 8 frames
FCB_LEVELS = [(48, 80), (24, 40), (12, 20), (6, 10), (3, 5)]


@pytest.mark.parametrize('kh,kw', [(3, 3), (3, 5), (5, 3)])
@pytest.mark.parametrize('hw', FCB_LEVELS)
def test_plan_fits_the_card_at_the_fcb_sites(hw, kh, kw):
    ho, wo = hw
    plan = col2im_plan(8, ho, wo, 256, kh, kw, 1, 1, RADIUS)
    fh, fw = footprint(plan.ty, plan.tx, kh, kw, 1, 1, RADIUS)
    assert (plan.fh, plan.fw) == (fh, fw)
    items = plan.ty * plan.tx * kh * kw
    assert plan.smem == 4 * ((fh * fw + items) * 34 + items * 24
                             + 2 * fh * fw + 2)
    assert plan.smem <= SMEM_LIMIT
    # the grid fills the 132 SMs where the tiles' chunks allow it, and no
    # split is without a chunk
    tiles = 8 * -(-ho // plan.ty) * -(-wo // plan.tx)
    assert plan.blocks == tiles * plan.n_split
    assert plan.blocks >= min(132, tiles * 8)
    per = -(-8 // plan.n_split)
    assert per * (plan.n_split - 1) < 8


def test_plan_refuses_a_footprint_over_shared_memory():
    with pytest.raises(ValueError, match='shared memory'):
        col2im_plan(1, 8, 8, 64, 3, 3, 1, 1, radius=20)
