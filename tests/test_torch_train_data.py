"""The port's training data path against the JAX package's on the CPU:
the YouTube-VIS training accessors, ``preprocess_frame``, every
augmentation, ``shard_indices``, one seeded epoch of ``ClipLoader``, and
the ``Prefetcher``'s error path.

A tiny synthetic set: 2 videos x 4 JPEG frames at 96x128 with RLE gt
(``write_ytvis_set``), to which the test adds a polygon track, a crowd
track and a track without ``bboxes`` (its boxes come from the masks), and
leaves one frame of a track empty.  Everything here is host numpy and cv2
on both sides, so the results must be equal bit for bit.
"""

import json

import numpy as np
import pytest

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.data import augment as j_aug
from stmask_tpu.data.loader import ClipLoader as JClipLoader
from stmask_tpu.data.loader import shard_indices as j_shard_indices
from stmask_tpu.data.transforms import preprocess_frame as j_preprocess
from stmask_tpu.data.ytvis import YTVISDataset as JDataset

from stmask_torch.config import get_config as t_get_config
from stmask_torch.data import augment as t_aug
from stmask_torch.data.loader import ClipLoader as TClipLoader
from stmask_torch.data.loader import Prefetcher
from stmask_torch.data.loader import shard_indices as t_shard_indices
from stmask_torch.data.synthetic import write_ytvis_set
from stmask_torch.data.transforms import preprocess_frame as t_preprocess
from stmask_torch.data.ytvis import YTVISDataset as TDataset

KW = dict(img_w=128, img_h=96, max_gt_per_frame=6)
JCFG = j_get_config('STMask_plus_resnet50').replace(**KW)
TCFG = t_get_config('STMask_plus_resnet50').replace(**KW)


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp('ytvis')
    ann_file, prefix = write_ytvis_set(str(root), 2, 4, 96, 128, seed=3,
                                       ext='.jpg')
    with open(ann_file) as fh:
        ann = json.load(fh)
    anns = ann['annotations']
    for a in anns:
        if a['video_id'] == 1:
            a['segmentations'][2] = None        # an empty frame of a track
            a['bboxes'][2] = None
            break
    poly = [[10.0, 20.0, 60.0, 18.0, 70.0, 60.0, 30.0, 75.0, 12.0, 50.0]]
    n = len(anns)
    anns.append({'id': n + 1, 'video_id': 1, 'category_id': 7,
                 'iscrowd': 0, 'segmentations': [poly] * 4,
                 'bboxes': [[10.0, 18.0, 60.0, 57.0]] * 4})
    anns.append({'id': n + 2, 'video_id': 2, 'category_id': 3,
                 'iscrowd': 1, 'segmentations': [poly] * 4,
                 'bboxes': [[10.0, 18.0, 60.0, 57.0]] * 4})
    nobox = next(a for a in anns if a['video_id'] == 2 and not a.get(
        'iscrowd'))
    del nobox['bboxes']
    with open(ann_file, 'w') as fh:
        json.dump(ann, fh)
    return ann_file, prefix


def _equal(got, want, msg=''):
    if isinstance(want, dict):
        assert set(got) == set(want), msg
        for k in want:
            _equal(got[k], want[k], f'{msg}.{k}')
    elif isinstance(want, (tuple, list)) and not isinstance(want, str):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f'{msg}[{i}]')
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (msg, g.dtype,
                                                           w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=msg)


def test_annotation_accessors_match_jax(dataset):
    jd, td = JDataset(*dataset), TDataset(*dataset)
    assert td.train_index() == jd.train_index()
    assert len(td.train_index()) == 8
    kinds = set()
    for vid in td.video_ids():
        for f in range(td.num_frames(vid)):
            got, want = td.frame_annots(vid, f), jd.frame_annots(vid, f)
            for field in ('boxes', 'labels', 'ids', 'masks', 'crowd_boxes'):
                _equal(getattr(got, field), getattr(want, field),
                       f'{vid}/{f}/{field}')
            kinds.add((len(got.boxes), len(got.crowd_boxes)))
            for seed in range(3):
                assert td.sample_ref_frame(
                    vid, f, np.random.RandomState(seed)) == \
                    jd.sample_ref_frame(vid, f, np.random.RandomState(seed))
    assert any(c for _, c in kinds)          # a crowd region was read


@pytest.mark.parametrize('image_u8', [False, True])
@pytest.mark.parametrize('flip', [False, True])
def test_preprocess_frame_matches_jax(dataset, image_u8, flip):
    from stmask_torch.data.image_io import load_image_rgb
    td, jd = TDataset(*dataset), JDataset(*dataset)
    for vid, f in td.train_index():
        img = load_image_rgb(td.frame_path(vid, f))
        got = t_preprocess(TCFG, img, td.frame_annots(vid, f), flip=flip,
                           image_u8=image_u8)
        want = j_preprocess(JCFG, img, jd.frame_annots(vid, f), flip=flip,
                            image_u8=image_u8)
        _equal(got, want, f'{vid}/{f}')


def _frame(dataset, vid=1, f=0):
    from stmask_torch.data.image_io import load_image_rgb
    td = TDataset(*dataset)
    a = td.frame_annots(vid, f)
    return (load_image_rgb(td.frame_path(vid, f)), a.boxes, a.labels,
            a.masks, a.ids)


AUGMENTS = [('PhotoMetricDistortion', {}), ('Expand', {}),
            ('Expand', {'keep_size': False}), ('RandomCrop', {}),
            ('RandomSampleCrop', None), ('RandomMirror', None),
            ('RandomFlip', None), ('SSDAugmentation', {}),
            ('SSDAugmentation', {'flip': True}),
            ('ExtraAugmentation', {'photo_metric_distortion': {},
                                   'expand': {}, 'random_crop': {}})]


@pytest.mark.parametrize('name,kw', AUGMENTS,
                         ids=[f'{n}-{i}' for i, (n, _) in
                              enumerate(AUGMENTS)])
def test_augmentation_matches_jax(dataset, name, kw):
    for seed in range(6):
        args = _frame(dataset, vid=1 + seed % 2, f=seed % 4)
        t = getattr(t_aug, name)(**(kw or {}))
        j = getattr(j_aug, name)(**(kw or {}))
        got = t(*[np.copy(a) for a in args], rng=np.random.RandomState(seed))
        want = j(*[np.copy(a) for a in args],
                 rng=np.random.RandomState(seed))
        _equal(got, want, f'{name} seed {seed}')


@pytest.mark.parametrize('shards', [1, 3])
def test_shard_indices_match_jax(shards):
    index = [(v, f) for v in range(3) for f in range(7)]
    for epoch in range(3):
        for shard in range(shards):
            assert t_shard_indices(index, epoch, shards, shard) == \
                j_shard_indices(index, epoch, shards, shard)


@pytest.mark.parametrize('augment', ['none', 'extra'])
@pytest.mark.parametrize('image_u8', [False, True])
def test_clip_loader_epoch_matches_jax(dataset, image_u8, augment):
    tl = TClipLoader(TCFG.replace(train_augment=augment), TDataset(*dataset),
                     3, seed=5, num_workers=2, image_u8=image_u8)
    jl = JClipLoader(JCFG.replace(train_augment=augment), JDataset(*dataset),
                     3, seed=5, num_workers=2, image_u8=image_u8)
    for epoch in (0, 1):
        got, want = list(tl.epoch(epoch)), list(jl.epoch(epoch))
        assert len(got) == len(want) == 2
        _equal(got, want, f'epoch {epoch}')
    assert tl.timing['batches'] == 4


def test_prefetcher_carries_a_worker_exception():
    def items():
        yield 1
        yield 2
        raise OSError('decode failed')

    got = []
    with pytest.raises(OSError, match='decode failed'):
        for x in Prefetcher(items(), put_fn=lambda v: v * 10):
            got.append(x)
    assert got == [10, 20]
    bad = Prefetcher(iter([1, 2]), put_fn=lambda v: 1 // (v - 2))
    with pytest.raises(ZeroDivisionError):
        list(bad)
    bad.t.join(timeout=10)
    assert not bad.t.is_alive()

    endless = Prefetcher(iter(range(10 ** 9)))
    assert next(iter(endless)) == 0
    endless.close()
    assert not endless.t.is_alive()
