"""Shared set-up of the eval-slice tests (tests/test_torch_eval_*.py).

A reduced flagship: ``STMask_plus_resnet50`` at 96x128 with
``layers=(1, 3, 3, 1)`` (five DCN sites, three of them stride 2) and 16
track slots; and a reduced ``YOLACT_legacy_resnet50`` (one bottleneck a
stage), the preset without TF.  Flax parameters are drawn with numpy
from a seed in the shapes ``jax.eval_shape`` gives (flax's own init of
the model costs about a minute on the CPU): LeCun-normal kernels as flax
draws them, random BatchNorm statistics, DCN offset predictors that move
the samples off the grid, and a sharper class head so that the untrained
model detects and tracks objects.  ``state_dict_from_flax`` carries them
to the port.

Two fp32 runs of the same frames agree to ~1e-7 but not bit for bit: the
CPU's convolutions sum in an order that depends on the framework, the
batch and the host's kernels.  A mask pixel whose value lies that close to
the 0.5 threshold can then land on either side of it.  ``same_tracks``
with ``near`` (``port_mask_values``) lets a mask differ only in such
pixels: within MASK_MARGIN of the threshold in the run that wrote
``got``.  On an AMD EPYC host (AVX512, torch 2.13.0+cpu, oneDNN v3.12.0)
one pixel of 81 kept masks flipped, at 0 and 2.4e-7 from 0.5 in the two
runs, whose masks differed by at most 6.0e-7 before the threshold.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.models import STMask as JSTMask

from stmask_torch.config import get_config as t_get_config
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.inference import postprocess as PP
from stmask_torch.models import STMask as TSTMask
from stmask_torch.utils import rle

KW = dict(img_w=128, img_h=96, track_capacity=16)
TORCH_THREADS = 2
# a mask pixel may differ where the port's value before the 0.5 threshold
# lies this close to it: 3.3x the largest difference measured between two
# runs' masks (6.0e-7)
MASK_MARGIN = 2e-6


@pytest.fixture(autouse=True, scope='module')
def few_torch_threads():
    """Two intra-op threads while a module of these tests runs: the suite
    runs in several worker processes at once, and a torch that spreads
    every op over all the cores of a shared host spends most of its time
    waiting for its own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


def _reduced(cfg):
    return cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                    layers=(1, 3, 3, 1)),
                       **KW)


JCFG = _reduced(j_get_config('STMask_plus_resnet50'))
TCFG = _reduced(t_get_config('STMask_plus_resnet50'))


def _reduced_legacy(cfg):
    """The legacy YOLACT preset (R50 without DCN, no TF) at 96x128 with one
    bottleneck a stage."""
    return cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                    layers=(1, 1, 1, 1)),
                       **KW)


JLEG = _reduced_legacy(j_get_config('YOLACT_legacy_resnet50'))
TLEG = _reduced_legacy(t_get_config('YOLACT_legacy_resnet50'))


def flax_params(seed: int = 0, cfg=None):
    """(flax STMask, {'params': numpy tree}) of the reduced flagship, or of
    the JAX config ``cfg``."""
    cfg = cfg or JCFG
    model = JSTMask(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.pad_h, cfg.pad_w, 3)),
        train=False))['params']
    rng = np.random.RandomState(seed)

    def fill(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, path + (k,))
                continue
            parent, shape = path[-1], v.shape
            if k in ('scale', 'mean', 'var') or (
                    k == 'bias' and (parent.startswith('bn')
                                     or parent == 'downsample_bn')):
                a = {'scale': rng.rand(*shape) + 0.5,
                     'bias': rng.randn(*shape) * 0.1,
                     'mean': rng.randn(*shape) * 0.1,
                     'var': rng.rand(*shape) + 0.5}[k]
            elif parent == 'conv_offset_mask':
                a = rng.randn(*shape) * (0.01 if k == 'kernel' else 0.5)
            elif k == 'kernel':
                a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
                if parent.startswith('conf_layer'):
                    a = a * 8.0
            else:
                a = rng.randn(*shape) * 0.05
            out[k] = np.asarray(a, np.float32)
        return out

    return model, {'params': fill(shapes)}


def port_model(params, cfg=None):
    """The port's model (the reduced flagship, or the port's config
    ``cfg``) with the same weights, eval mode, on the CPU."""
    model = TSTMask(cfg or TCFG)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model.eval()


@pytest.fixture
def port_mask_values(monkeypatch):
    """The masks of the port's runs in this test before the 0.5 threshold:
    {(video_id, frame_id, RLE counts): [img_h, img_w] fp32}, recorded from
    ``postprocess_frame``."""
    values = {}
    orig = PP.postprocess_frame

    def record(cfg, frame_out, img_meta, score_threshold=0.0):
        res = orig(cfg, frame_out, img_meta, score_threshold)
        idx = torch.nonzero(frame_out.keep).flatten()
        up = PP.upsampled_masks(frame_out.mask[idx], img_meta['img_shape'],
                                img_meta.get('pad_shape',
                                             (cfg.pad_h, cfg.pad_w)))
        for oid, m in zip(frame_out.obj_id[idx].tolist(), up.cpu().numpy()):
            if oid in res:
                values[(res['video_id'], res['frame_id'],
                        res[oid]['segm']['counts'])] = m
        return res

    monkeypatch.setattr(PP, 'postprocess_frame', record)
    return values


def same_tracks(got, want, score_atol, near=None):
    """The same tracks in the same order (so the same track ids) over the
    same frames, scores within ``score_atol``, and identical RLE in every
    frame; or, with ``near`` (``port_mask_values`` of the runs that wrote
    ``got``), masks that differ only in pixels whose value in ``got``'s run
    lies within MASK_MARGIN of the 0.5 threshold."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g['video_id'] == w['video_id']
        assert g['category_id'] == w['category_id']
        assert abs(g['score'] - w['score']) <= score_atol
        if near is None:
            assert g['segmentations'] == w['segmentations']
            continue
        assert len(g['segmentations']) == len(w['segmentations'])
        for f, (a, b) in enumerate(zip(g['segmentations'],
                                       w['segmentations'])):
            if a == b:
                continue
            assert a is not None and b is not None, (g['video_id'], f)
            key = (g['video_id'], f, a['counts'])
            assert key in near, key
            flip = rle.decode(a) != rle.decode(b)
            margin = float(np.abs(near[key][flip] - 0.5).max())
            assert margin <= MASK_MARGIN, (key[:2], int(flip.sum()), margin)


def corrupted(tracks):
    """Two copies of ``tracks`` that ``same_tracks`` must refuse against
    the original: the first mask with pixels moved down one row, and the
    first two tracks swapped."""
    moved = [dict(t, segmentations=list(t['segmentations'])) for t in tracks]
    done = False
    for t in moved:
        for f, s in enumerate(t['segmentations']):
            if done or s is None or not rle.decode(s).any():
                continue
            m = rle.decode(s)
            t['segmentations'][f] = rle.encode(np.roll(m, 1, axis=0))
            done = True
    assert done and len(tracks) > 1
    return [moved, [tracks[1], tracks[0]] + list(tracks[2:])]


def refuses_corrupted(got, want, score_atol, near):
    """``same_tracks`` fails against each of ``corrupted(want)``."""
    for bad in corrupted(want):
        with pytest.raises(AssertionError):
            same_tracks(got, bad, score_atol, near)
