"""The port's checkpoints and training loop on the CPU: the JAX package's
name codec, a save / restore round trip, a restored run continuing
bit-identically, and the loop on a small synthetic batch iterator in
``ClipLoader``'s format."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from stmask_tpu.train.checkpoint import ckpt_name as j_ckpt_name
from stmask_tpu.train.checkpoint import parse_ckpt_name as j_parse_ckpt_name

from stmask_torch.config import get_config
from stmask_torch.data.transforms import (pad_gt, prepare_batch,
                                          unpack_masks_device)
from stmask_torch.models import STMask
from stmask_torch.models.stmask import init_random
from stmask_torch.train.checkpoint import (CheckpointManager, ckpt_name,
                                           parse_ckpt_name)
from stmask_torch.train.loop import train
from stmask_torch.train.schedule import learning_rate
from stmask_torch.train.train_step import build_train_step

from torch_eval_common import few_torch_threads  # noqa: F401

C0 = get_config('STMask_plus_resnet50')
CFG = C0.replace(backbone=dataclasses.replace(C0.backbone,
                                              layers=(1, 1, 1, 1)),
                 img_w=96, img_h=60, max_gt_per_frame=4, masks_to_train=8)


def _model(seed=0):
    return init_random(STMask(CFG), torch.Generator().manual_seed(seed))


def _clip_batch(cfg, seed, b=1):
    """A batch as ``ClipLoader(image_u8=True)`` yields it: uint8 frames,
    2 boxes a frame (a persisting and a vanishing / new id), bit-packed
    masks, one empty crowd region."""
    rng = np.random.RandomState(seed)
    hp, wp = cfg.pad_h // 4, cfg.pad_w // 4
    clips = []
    for c in range(b):
        frames = []
        for f, ids in enumerate(((1, 2), (1, 3))):
            boxes = np.array([[0.1 + 0.03 * f, 0.1, 0.5 + 0.03 * f, 0.6],
                              [0.55, 0.4, 0.9, 0.95]], np.float32)
            masks = np.zeros((2, hp, wp), np.uint8)
            for j, (x1, y1, x2, y2) in enumerate(boxes):
                masks[j, int(y1 * cfg.img_h / 4):int(y2 * cfg.img_h / 4),
                      int(x1 * cfg.img_w / 4):int(x2 * cfg.img_w / 4)] = 1
            frames.append(pad_gt(cfg, {
                'image': rng.randint(0, 256, (cfg.img_h, cfg.img_w, 3),
                                     dtype=np.uint8),
                'boxes': boxes, 'labels': np.array([3, 5], np.int32),
                'ids': np.array(ids, np.int32), 'masks_proto': masks,
                'crowd_boxes': np.zeros((1, 4), np.float32)}))
        clips.append({k: np.stack([fr[k] for fr in frames])
                      for k in frames[0]})
    batch = {k: np.stack([c[k] for c in clips]) for k in clips[0]}
    batch['images'] = batch.pop('image')
    batch['masks_proto'] = np.packbits(batch['masks_proto'], axis=-1)
    return batch


def test_name_codec_matches_jax():
    names = [('STMask_plus_resnet50', 3, 12000, False),
             ('STMask_plus_resnet50', 0, 7, True),
             ('STMask_plus_base_ada', 12, 250000, False), ('a_b_c', 1, 2,
                                                           True)]
    for args in names:
        assert ckpt_name(*args) == j_ckpt_name(*args)
        name = ckpt_name(*args)
        for path in (name, f'/x/{name}/', f'/x/{name}.pth'):
            assert parse_ckpt_name(path) == j_parse_ckpt_name(
                path.replace('.pth', '')) == args
    for bad in ('weights', 'STMask_1', 'x_1_y'):
        assert parse_ckpt_name(bad) is None is j_parse_ckpt_name(bad)


def test_unpack_masks_is_msb_first():
    bits = np.random.RandomState(0).randint(0, 2, (3, 5, 24)).astype(
        np.uint8)
    got = unpack_masks_device(torch.from_numpy(np.packbits(bits, axis=-1)))
    np.testing.assert_array_equal(got.numpy(), bits)


def test_save_restore_round_trip(tmp_path):
    step, init = build_train_step(CFG, _model(), device='cpu')
    state, _ = step(init(), prepare_batch(CFG, _clip_batch(CFG, 0), 'cpu'))
    mgr = CheckpointManager(str(tmp_path), CFG.name)
    path = mgr.save(state, 0, 1)
    assert os.path.basename(path) == f'{CFG.name}_0_1.pth'
    assert mgr.get_latest() == path and mgr.get_interrupt() is None

    _, init2 = build_train_step(CFG, _model(seed=1), device='cpu')
    restored = mgr.restore(path, init2())
    assert restored.step == 1 and int(restored.count) == 1
    for (k, a), b in zip(state.model.state_dict().items(),
                         restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(state.momentum, restored.momentum):
        assert torch.equal(a, b)


def test_restored_run_continues_bit_identically(tmp_path):
    batches = [prepare_batch(CFG, _clip_batch(CFG, s), 'cpu')
               for s in range(3)]
    step, init = build_train_step(CFG, _model(), device='cpu')
    state = init()
    for bt in batches:
        state, m3 = step(state, bt)
    straight = {k: v.clone() for k, v in state.model.state_dict().items()}

    step, init = build_train_step(CFG, _model(), device='cpu')
    state = init()
    for bt in batches[:2]:
        state, _ = step(state, bt)
    path = CheckpointManager(str(tmp_path), CFG.name).save(state, 0, 2)
    step, init = build_train_step(CFG, _model(seed=5), device='cpu')
    state = CheckpointManager(str(tmp_path), CFG.name).restore(path, init())
    state, m = step(state, batches[2])
    assert state.step == 3 and int(state.count) == 3
    assert float(m['total']) == float(m3['total'])
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, straight[k]), k


def test_loop_checkpoints_logs_and_resumes(tmp_path):
    """Epochs of 2 batches: names and log entries carry the epoch, the final
    save is named after the epoch count (``train.py:277``), and a resumed
    run skips the epochs it has done."""
    cfg = CFG.replace(max_iter=3,
                      delayed_settings=((2, (('lr', 5e-4),)),))
    save, logs = str(tmp_path / 'w'), str(tmp_path / 'logs')

    def epochs(e):
        return (_clip_batch(cfg, 10 * e + s, b=2) for s in range(2))
    state = train(cfg, _model(), epochs, 2, save, logs, save_interval=2,
                  keep_latest=1, device='cpu')
    assert state.step == 3
    files = sorted(os.listdir(save))
    assert files == [f'{cfg.name}_2_3.pth'], files     # 0_2 pruned
    entries = [json.loads(ln) for ln in open(os.path.join(
        logs, f'{cfg.name}.log'))]
    train_entries = [e for e in entries if e['type'] == 'train']
    assert [e['data']['iter'] for e in train_entries] == [1, 2, 3]
    assert [e['data']['epoch'] for e in train_entries] == [0, 0, 1]
    assert all(np.isfinite(e['data']['total']) for e in train_entries)
    assert train_entries[2]['data']['lr'] == pytest.approx(
        learning_rate(cfg.replace(lr=5e-4), 2))

    seen = []

    def more(e):
        seen.append(e)
        return (_clip_batch(cfg, 100 + 10 * e + s, b=2) for s in range(2))
    state = train(cfg.replace(max_iter=4), _model(seed=3), more, 2, save,
                  logs, resume='latest', device='cpu')
    assert state.step == 4 and int(state.count) == 4
    assert seen == [1]
    last = [json.loads(ln) for ln in open(os.path.join(
        logs, f'{cfg.name}.log'))][-1]
    assert last['data']['epoch'] == 1 and last['data']['iter'] == 4
