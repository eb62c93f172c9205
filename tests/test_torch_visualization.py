"""The port's overlays (``stmask_torch/utils/visualization.py``) against the
JAX package's ``stmask_tpu/utils/visualization.py``: every host function
bit for bit on the same arrays; ``save_train_output`` on the same weights
and batch (the same panes, at least 99.5% of pixels equal: boxes are cut
to int and scores printed to 2 decimals, so an fp32 ulp can move an edge),
leaving the model's state as it was; and the training CLI's
``--vis_every``, whose checkpoint equals a run without it."""

import os

import numpy as np
import pytest
import torch

import jax

from stmask_tpu.train import losses as j_losses
from stmask_tpu.utils import visualization as jv

from stmask_torch import config as t_config
from stmask_torch.data.synthetic import write_ytvis_set
from stmask_torch.models.layers import set_bn_affine_trainable
from stmask_torch.train import __main__ as train_cli
from stmask_torch.utils import visualization as tv

from torch_eval_common import JCFG, TCFG, flax_params, port_model
from torch_eval_common import few_torch_threads  # noqa: F401

cv2 = pytest.importorskip('cv2')

PIXEL_SHARE = 0.995
H, W = 48, 64


def _image(rng):
    """A normalized frame as the model takes it."""
    return ((rng.randint(0, 256, (H, W, 3)) - np.asarray(tv.MEANS))
            / np.asarray(tv.STD)).astype(np.float32)


def _dets(rng, n=4):
    x1, y1 = rng.uniform(0, W - 20, n), rng.uniform(0, H - 16, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(4, 20, n),
                      y1 + rng.uniform(4, 16, n)], 1).astype(np.float32)
    return (boxes, rng.randint(1, 41, n), rng.rand(n).astype(np.float32),
            rng.rand(n, H, W) > 0.6, rng.randint(1, 30, n))


def _case(name, rng):
    """(args, kwargs) of the host function ``name`` on seeded arrays."""
    if name == 'undo_image_transformation':
        return (_image(rng), H - 5, W - 7), {}
    if name == 'draw_detections':
        img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        boxes, cls, scores, masks, ids = _dets(rng)
        return (img, boxes, cls, scores, masks, ids, TCFG.classes), {}
    if name == 'draw_detections_gt':       # no scores, no ids, no names
        img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        boxes, cls, _, masks, _ = _dets(rng)
        return (img, boxes, cls, None, masks), {'mask_alpha': 0.3}
    if name == 'proto_grid':
        p = rng.rand(12, 16, 11).astype(np.float32)
        p[..., 3] = 0.5                     # a flat prototype
        return (p,), {'cols': 4}
    if name == 'correlation_patch_map':
        return (rng.randn(10, 12, 121).astype(np.float32), 3, 7), {}
    if name == 'draw_box_shift':
        img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        return (img, _dets(rng)[0], _dets(rng, 3)[0]), {}
    if name == 'display_lincomb':
        return (np.maximum(rng.randn(12, 16, 32), 0).astype(np.float32),
                np.tanh(rng.randn(32)).astype(np.float32)), {}
    if name == '_upsample_masks':
        return (rng.rand(3, 12, 16).astype(np.float32), H, W), {}
    if name == '_upsample_masks_empty':
        return (np.zeros((0, 12, 16), np.float32), H, W), {}
    if name == 'display_fpn_outs':
        return ([rng.randn(12 >> i, 16 >> i, 20).astype(np.float32)
                 for i in range(5)],), {}
    if name == 'render_train_output':
        n_p, k = 60, 8
        priors = np.concatenate([rng.uniform(0.2, 0.8, (n_p, 2)),
                                 rng.uniform(0.1, 0.3, (n_p, 2))],
                                1).astype(np.float32)
        preds = {'loc': rng.randn(n_p, 4).astype(np.float32) * 0.2,
                 'conf': rng.randn(n_p, 41).astype(np.float32),
                 'mask_coeff': rng.randn(n_p, k).astype(np.float32),
                 'proto': rng.rand(H // 4, W // 4, k).astype(np.float32)}
        conf_t = rng.randint(-1, 3, n_p) * (rng.rand(n_p) > 0.5)
        boxes = _dets(rng, 3)[0] / [W, H, W, H]
        gt = {'boxes': boxes.astype(np.float32),
              'labels': np.array([3, 7, 1]), 'valid': np.array([1, 1, 0],
                                                               bool),
              'masks_proto': (rng.rand(3, H // 4, W // 4) > 0.5
                              ).astype(np.uint8),
              'ids': np.array([4, 5, 6])}
        return (TCFG, _image(rng), priors, preds, conf_t, gt), {}
    raise KeyError(name)


HOST_FUNCTIONS = ['undo_image_transformation', 'draw_detections',
                  'draw_detections_gt', 'proto_grid', 'correlation_patch_map',
                  'draw_box_shift', 'display_lincomb', '_upsample_masks',
                  '_upsample_masks_empty', 'display_fpn_outs',
                  'render_train_output']


def _same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('name', HOST_FUNCTIONS)
def test_host_function_bit_identical_to_jax(name):
    args, kw = _case(name, np.random.RandomState(
        HOST_FUNCTIONS.index(name)))
    fn = name.replace('_gt', '').replace('_empty', '')
    jargs = tuple(JCFG if a is TCFG else a for a in args)
    _same(getattr(tv, fn)(*args, **kw), getattr(jv, fn)(*jargs, **kw))


def test_palette_is_jax():
    assert tv.COLORS == jv.COLORS


def _train_batch(cfg, seed, clips=2, g=3):
    """A train step's batch (normalized frames, normalized xyxy boxes,
    prototype-size masks) from a seed, as numpy arrays."""
    rng = np.random.RandomState(seed)
    hp, wp = cfg.pad_h // 4, cfg.pad_w // 4
    img = (rng.randint(0, 256, (clips, 2, cfg.pad_h, cfg.pad_w, 3))
           - np.asarray(tv.MEANS)) / np.asarray(tv.STD)
    xy = rng.uniform(0.05, 0.55, (clips, 2, g, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.15, 0.4, (clips, 2, g,
                                                              2))], -1)
    masks = np.zeros((clips, 2, g, hp, wp), np.uint8)
    for idx in np.ndindex(clips, 2, g):
        x1, y1, x2, y2 = boxes[idx] * [wp, hp, wp, hp]
        masks[idx][int(y1):int(y2), int(x1):int(x2)] = 1
    valid = np.ones((clips, 2, g), bool)
    valid[:, :, -1] = False
    return {'images': img.astype(np.float32),
            'boxes': boxes.astype(np.float32),
            'labels': rng.randint(1, 41, (clips, 2, g)).astype(np.int32),
            'ids': np.tile(np.arange(1, g + 1, dtype=np.int32),
                           (clips, 2, 1)),
            'valid': valid, 'masks_proto': masks}


class _JittedApply:
    """The flax model's train-mode ``apply`` under ``jax.jit`` (the JAX
    package's hook calls ``model.apply(params, images, train=True)``)."""

    def __init__(self, model):
        self._fn = jax.jit(lambda p, x: model.apply(p, x, train=True))

    def apply(self, params, x, train):
        assert train
        return self._fn(params, x)


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_save_train_output_matches_jax(tmp_path, monkeypatch):
    """The same files as JAX's hook on the same weights and batch, 99.5% of
    their pixels equal; the model's parameters, buffers, flags and the RNG
    are what they were."""
    jmodel, params = flax_params(seed=4)
    batch = _train_batch(TCFG, seed=5)
    monkeypatch.setattr(j_losses, 'match_batch', jax.jit(
        j_losses.match_batch, static_argnums=0))
    j_dir, t_dir = tmp_path / 'jax', tmp_path / 'port'
    jv.save_train_output(JCFG, _JittedApply(jmodel), params, batch,
                         str(j_dir), 3, 7, max_images=2)

    model = port_model(params).train()
    before = _state(model)
    rng = torch.get_rng_state()
    tv.save_train_output(TCFG, model, {k: torch.from_numpy(v)
                                       for k, v in batch.items()},
                         str(t_dir), 3, 7, max_images=2)
    after = model.state_dict()
    assert list(after) == list(before)
    for k, v in before.items():
        assert after[k].dtype == v.dtype and torch.equal(after[k], v), k
    assert all(m.training for m in model.modules())
    assert all(p.grad is None for p in model.parameters())
    assert torch.equal(torch.get_rng_state(), rng)

    files = sorted(os.listdir(t_dir))
    assert files == sorted(os.listdir(j_dir)) == sorted(
        f'3_7_{i}_{pane}.png' for i in (0, 1)
        for pane in ('train', 'gt', 'gt_ref'))
    for f in files:
        a, b = cv2.imread(str(t_dir / f)), cv2.imread(str(j_dir / f))
        assert a.shape == b.shape == (TCFG.pad_h, TCFG.pad_w, 3)
        assert float((a == b).all(-1).mean()) >= PIXEL_SHARE, f


@pytest.mark.parametrize('trainable_bn', [False, True])
def test_save_train_output_leaves_eval_model_alone(tmp_path, trainable_bn):
    """An eval-mode model stays in eval mode, and nothing else moves, also
    where the BN scale and bias are parameters (``freeze_bn=False``): the
    running statistics are never updated."""
    model = port_model(flax_params(seed=4)[1])
    set_bn_affine_trainable(model, trainable_bn)
    before = _state(model)
    batch = {k: torch.from_numpy(v)
             for k, v in _train_batch(TCFG, seed=6, clips=1).items()}
    tv.save_train_output(TCFG, model, batch, str(tmp_path), 0, 1)
    assert not any(m.training for m in model.modules())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert sorted(os.listdir(tmp_path)) == [
        '0_1_0_gt.png', '0_1_0_gt_ref.png', '0_1_0_train.png']


def test_train_cli_vis_every(tmp_path, monkeypatch):
    """``--vis_every 1`` on a 2-step run writes the overlays of both steps
    and saves the checkpoint of the same run without the flag."""
    name = 'STMask_plus_resnet50_vis96'
    monkeypatch.setitem(t_config.REGISTRY, name, TCFG.replace(name=name))
    ann, prefix = write_ytvis_set(str(tmp_path / 'set'), 1, 2, 96, 128,
                                  seed=2, ext='.jpg')

    def run(tag, *extra):
        out = tmp_path / tag
        train_cli.run(['--config', name, '--ann_file', ann, '--img_prefix',
                       prefix, '--batch_size', '2', '--num_workers', '2',
                       '--save_folder', str(out / 'w'), '--log_folder',
                       str(out / 'logs'), '--device', 'cpu', '--max_iter',
                       '2', *extra])
        return torch.load(out / 'w' / f'{name}_2_2.pth', weights_only=True)

    plain = run('plain')
    vis = run('vis', '--vis_every', '1', '--vis_dir',
              str(tmp_path / 'overlays'))
    assert sorted(os.listdir(tmp_path / 'overlays')) == sorted(
        f'{e}_{e + 1}_0_{pane}.png' for e in (0, 1)
        for pane in ('train', 'gt', 'gt_ref'))
    assert plain.keys() == vis.keys()
    for k in plain:
        if isinstance(plain[k], dict):
            for n, t in plain[k].items():
                assert torch.equal(t, vis[k][n]), (k, n)
        elif isinstance(plain[k], list):
            assert all(torch.equal(a, b) for a, b in zip(plain[k], vis[k]))
        elif isinstance(plain[k], torch.Tensor):
            assert torch.equal(plain[k], vis[k]), k
        else:
            assert plain[k] == vis[k], k
