"""The COCO image dataset (``stmask_torch/data/coco.py``) against the JAX
package's ``stmask_tpu/data/coco.py``, accessor by accessor, and the eval
CLI's ``--coco`` mode against the JAX ``eval.py``'s batched ``--coco`` run
on the same weights (images as one-frame videos, so every lane starts a
new video at every step)."""

import json
import os

import numpy as np
import pytest
import torch

import eval as j_eval       # the JAX package's eval.py, at the root
from stmask_tpu.data.coco import COCOAsVideos as JCOCOAsVideos
from stmask_tpu.data.coco import COCODataset as JCOCODataset
from stmask_tpu.utils import rle as j_rle
from stmask_tpu.utils.ytvis_eval import evaluate_ytvis as j_evaluate_ytvis

from stmask_torch import config as t_config
from stmask_torch import eval as t_eval
from stmask_torch.convert import state_dict_from_flax
from stmask_torch.data import COCOAsVideos, COCODataset
from stmask_torch.data.synthetic import write_coco_set

from torch_eval_common import JCFG, TCFG, flax_params, same_tracks
from torch_eval_common import few_torch_threads  # noqa: F401

cv2 = pytest.importorskip('cv2')

NAME = 'STMask_plus_resnet50_cocotest'


@pytest.fixture(scope='module')
def coco_json(tmp_path_factory):
    """Three images (as ``tests/test_coco.py``'s fixture, plus a polygon, a
    crowd region, a second sparse category and an image without
    annotations)."""
    root = tmp_path_factory.mktemp('coco')
    img_dir = root / 'imgs'
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    h, w = 60, 80
    images, annotations = [], []
    for img_id in (1, 2, 3):
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        cv2.imwrite(str(img_dir / f'{img_id}.jpg'), img)
        images.append({'id': img_id, 'file_name': f'{img_id}.jpg',
                       'height': h, 'width': w})
    for aid, (img_id, cat, crowd) in enumerate(
            [(1, 7, 0), (1, 20, 0), (2, 7, 0), (2, 20, 1)], start=1):
        m = np.zeros((h, w), np.uint8)
        y0, x0 = 5 + 7 * aid, 4 + 9 * aid
        m[y0:y0 + 20, x0:x0 + 30] = 1
        segm = {'size': [h, w], 'counts': j_rle.encode(m)['counts']}
        if aid == 2:            # a polygon (a triangle and a quad)
            segm = [[10.0, 40.0, 30.0, 40.0, 20.0, 55.0],
                    [50.0, 5.0, 70.0, 5.0, 70.0, 25.0, 50.0, 25.0]]
        annotations.append({'id': aid, 'image_id': img_id,
                            'category_id': cat, 'iscrowd': crowd,
                            'bbox': [x0, y0, 30, 20], 'segmentation': segm})
    ann_file = root / 'instances.json'
    with open(ann_file, 'w') as f:
        json.dump({'images': images, 'annotations': annotations,
                   'categories': [{'id': 20, 'name': 'dog'},
                                  {'id': 7, 'name': 'cat'}]}, f)
    return str(ann_file), str(img_dir)


def _same_annots(got, want):
    for field in ('boxes', 'labels', 'ids', 'masks', 'crowd_boxes'):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize('has_annotations', [True, False])
def test_coco_dataset_matches_jax(coco_json, has_annotations):
    ann_file, img_dir = coco_json
    got = COCODataset(ann_file, img_dir, has_annotations=has_annotations)
    want = JCOCODataset(ann_file, img_dir, has_annotations=has_annotations)
    assert got.categories == want.categories == [7, 20]
    assert got.cat_to_label == want.cat_to_label == {7: 1, 20: 2}
    assert got.image_ids() == want.image_ids() == [1, 2, 3]
    assert got.train_index() == want.train_index()
    for img_id in got.image_ids():
        assert got.image_path(img_id) == want.image_path(img_id)
        assert got.image_size(img_id) == want.image_size(img_id)
        for crowd in (False, True):
            _same_annots(got.image_annots(img_id, include_crowd=crowd),
                         want.image_annots(img_id, include_crowd=crowd))
    if has_annotations:
        ann = got.image_annots(2)
        assert ann.labels.tolist() == [1] and len(ann.crowd_boxes) == 1
        assert got.image_annots(1).masks[1].sum() > 0    # the polygon
        assert got.train_index() == [1, 2]


def test_coco_as_videos_matches_jax(coco_json):
    ann_file, img_dir = coco_json
    got = COCOAsVideos(COCODataset(ann_file, img_dir))
    want = JCOCOAsVideos(JCOCODataset(ann_file, img_dir))
    assert got.video_ids() == want.video_ids()
    for vid in got.video_ids():
        assert got.num_frames(vid) == want.num_frames(vid) == 1
        assert got.frame_path(vid, 0) == want.frame_path(vid, 0)
        assert os.path.exists(got.frame_path(vid, 0))
        assert got.frame_size(vid) == want.frame_size(vid)
        _same_annots(got.frame_annots(vid, 0), want.frame_annots(vid, 0))
    gt = got.to_ytvis_gt()
    assert gt == want.to_ytvis_gt()
    assert len(gt['annotations']) == 3 and len(gt['categories']) == 2


def test_coco_eval_matches_jax_eval_script(tmp_path, monkeypatch):
    """``--coco --fp32 --eval_metrics`` (2 lanes x 2-frame chunks over 5
    one-frame videos) against JAX's ``evaluate_dataset_batched`` with
    ``--coco``: the same tracks, scores within 1e-4, the same metrics."""
    monkeypatch.setitem(t_config.REGISTRY, NAME, TCFG.replace(name=NAME))
    ann, prefix = write_coco_set(str(tmp_path), 5, 2 * TCFG.img_h,
                                 2 * TCFG.img_w, seed=3,
                                 gt_hw=(TCFG.img_h, TCFG.img_w))
    jmodel, params = flax_params(seed=2)
    weights = str(tmp_path / 'weights.pth')
    torch.save(state_dict_from_flax(params), weights)
    flags = ['--ann_file', ann, '--img_prefix', prefix, '--coco',
             '--eval_metrics', '--fp32', '--batch_videos', '2',
             '--chunk_frames', '2']
    j_out, t_out = tmp_path / 'jax.json', tmp_path / 'port.json'
    j_stats = j_eval.evaluate_dataset_batched(
        j_eval.parse_args(flags + ['--mask_det_file', str(j_out)]), JCFG,
        jmodel, params)
    t_stats = t_eval.evaluate(flags + ['--config', NAME, '--trained_model',
                                       weights, '--device', 'cpu',
                                       '--mask_det_file', str(t_out)])
    tracks = json.loads(t_out.read_text())
    same_tracks(tracks, json.loads(j_out.read_text()), 1e-4)
    assert {t['video_id'] for t in tracks} <= {1, 2, 3, 4, 5}
    assert all(len(t['segmentations']) == 1 for t in tracks)
    assert t_stats['n_frames'] == 5 and t_stats['n_chunks'] == 2
    for k in ('mAP', 'AP50', 'AP75', 'AR'):
        assert abs(t_stats[k] - j_stats[k]) <= 1e-6, k
    gt = JCOCOAsVideos(JCOCODataset(ann, prefix)).to_ytvis_gt()
    assert j_evaluate_ytvis(gt, str(t_out)) == {
        k: t_stats[k] for k in ('mAP', 'AP50', 'AP75', 'AR')}
