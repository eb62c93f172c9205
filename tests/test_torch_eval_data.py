"""The eval slice's data side against the JAX package (and cv2): the PNG
reader, the frame resize, the YTVIS annotation accessors, RLE and the mAP
evaluator."""

import json
import sys

import cv2
import numpy as np
import pytest
import torch

from stmask_tpu.config import get_config as j_get_config
from stmask_tpu.data.loader import load_image_rgb as j_load_image_rgb
from stmask_tpu.data.transforms import preprocess_frame_u8 as j_preprocess
from stmask_tpu.data.ytvis import YTVISDataset as JYTVISDataset
from stmask_tpu.utils import rle as j_rle
from stmask_tpu.utils.ytvis_eval import evaluate_ytvis as j_evaluate_ytvis

from stmask_torch.config import get_config as t_get_config
from stmask_torch.data.image_io import load_image_rgb, read_png, write_png
from stmask_torch.data.synthetic import write_ytvis_set
from stmask_torch.data.transforms import preprocess_frame_u8
from stmask_torch.data.ytvis import YTVISDataset
from stmask_torch.utils import rle
from stmask_torch.utils.ytvis_eval import evaluate_ytvis
from torch_eval_common import few_torch_threads  # noqa: F401

FILTERS = {'none': cv2.IMWRITE_PNG_FILTER_NONE,
           'sub': cv2.IMWRITE_PNG_FILTER_SUB,
           'up': cv2.IMWRITE_PNG_FILTER_UP,
           'average': cv2.IMWRITE_PNG_FILTER_AVG,
           'paeth': cv2.IMWRITE_PNG_FILTER_PAETH,
           'all': cv2.IMWRITE_PNG_ALL_FILTERS}


def _image(h, w, ch, seed):
    rng = np.random.RandomState(seed)
    smooth = np.kron(rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, ch)),
                     np.ones((8, 8, 1)))[:h, :w]
    img = (smooth + rng.randint(-20, 21, (h, w, ch))).clip(0, 255)
    return img.astype(np.uint8)


@pytest.mark.parametrize('filt', sorted(FILTERS))
@pytest.mark.parametrize('ch', [1, 3, 4])
def test_png_reader_matches_cv2(tmp_path, filt, ch):
    """PNGs that cv2 wrote with each row filter (and its adaptive choice),
    grey, BGR and BGRA: read bit for bit as cv2 reads them."""
    img = _image(37, 53, ch, seed=ch)
    path = str(tmp_path / 'x.png')
    assert cv2.imwrite(path, img[..., 0] if ch == 1 else img,
                       [cv2.IMWRITE_PNG_FILTER, FILTERS[filt]])
    raw = read_png(path)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    order = {1: [0], 3: [2, 1, 0], 4: [2, 1, 0, 3]}[ch]   # cv2 keeps BGR(A)
    np.testing.assert_array_equal(raw[..., order].reshape(want.shape), want)
    np.testing.assert_array_equal(load_image_rgb(path),
                                  j_load_image_rgb(path))


@pytest.mark.parametrize('ch', [1, 2, 3, 4])
def test_write_png_round_trip(tmp_path, ch):
    img = _image(20, 31, ch, seed=10 + ch)
    path = str(tmp_path / 'y.png')
    write_png(path, img[..., 0] if ch == 1 else img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(load_image_rgb(path),
                                  j_load_image_rgb(path))


def test_jpeg_goes_through_cv2_or_pil(tmp_path, monkeypatch):
    img = _image(24, 40, 3, seed=3)
    path = str(tmp_path / 'z.jpg')
    assert cv2.imwrite(path, img)
    np.testing.assert_array_equal(load_image_rgb(path),
                                  j_load_image_rgb(path))
    monkeypatch.setitem(sys.modules, 'cv2', None)
    monkeypatch.setitem(sys.modules, 'PIL', None)
    with pytest.raises(ImportError, match='cv2 or PIL'):
        load_image_rgb(path)
    with pytest.raises(FileNotFoundError):
        load_image_rgb(str(tmp_path / 'missing.png'))


@pytest.mark.parametrize('src_hw,dst_hw', [
    ((720, 1280), (360, 640)), ((481, 853), (360, 640)),
    ((100, 77), (360, 640)), ((240, 320), (360, 640)),
    ((480, 640), (360, 640)), ((500, 500), (360, 640)),
    ((720, 960), (360, 640)), ((1080, 1440), (360, 640)),
    ((1080, 1920), (360, 640)), ((1080, 1920), (720, 1280)),
    ((360, 640), (384, 640))])
def test_preprocess_frame_u8_matches_cv2_resize(src_hw, dst_hw):
    """The port resizes with cv2's own 11-bit fixed-point arithmetic in
    integer tensors: bit for bit cv2 ``INTER_LINEAR``, downscales and
    upscales alike."""
    (h, w), (dh, dw) = src_hw, dst_hw
    jcfg = j_get_config('STMask_plus_resnet50').replace(img_h=dh, img_w=dw)
    tcfg = t_get_config('STMask_plus_resnet50').replace(img_h=dh, img_w=dw)
    img = _image(h, w, 3, seed=h)
    want = j_preprocess(jcfg, img)
    got = preprocess_frame_u8(tcfg, torch.from_numpy(img), device='cpu')
    assert got['img_shape'] == want['img_shape']
    assert got['pad_shape'] == want['pad_shape']
    assert got['image'].dtype == torch.uint8
    diff = np.abs(got['image'].numpy().astype(int)
                  - want['image'].astype(int))
    assert diff.max() == 0, f'{(diff > 0).mean():.4%} of values differ'


def test_ytvis_dataset_accessors(tmp_path):
    ann, prefix = write_ytvis_set(str(tmp_path), 3, 4, 24, 32, seed=1)
    for has in (True, False):
        j, t = JYTVISDataset(ann, prefix, has), YTVISDataset(ann, prefix, has)
        assert t.video_ids() == j.video_ids() == [1, 2, 3]
        assert t.categories == j.categories
        assert t.annots_by_vid == j.annots_by_vid
        for vid in j.video_ids():
            assert t.num_frames(vid) == j.num_frames(vid) == 4
            assert t.frame_size(vid) == j.frame_size(vid) == (24, 32)
            for f in range(4):
                assert t.frame_path(vid, f) == j.frame_path(vid, f)
                np.testing.assert_array_equal(
                    load_image_rgb(t.frame_path(vid, f)),
                    j_load_image_rgb(j.frame_path(vid, f)))


def test_rle_decode_and_area_match_jax():
    rng = np.random.RandomState(4)
    for h, w in ((7, 9), (1, 5), (12, 3)):
        m = (rng.rand(h, w) > 0.6).astype(np.uint8)
        enc = rle.encode(m)
        assert enc == j_rle.encode(m)
        counts = list(rle.mask_to_counts(m))
        for r in (enc, {'size': [h, w], 'counts': counts},
                  {'size': [h, w], 'counts': enc['counts'].encode()}):
            np.testing.assert_array_equal(rle.decode(r), m)
            assert rle.area(r) == int(m.sum())
        np.testing.assert_array_equal(rle.decode(enc), j_rle.decode(enc))
        assert rle.area(enc) == j_rle.area(enc)


@pytest.mark.parametrize('kind', ['noise', 'blobs', 'empty', 'full',
                                  'stripes'])
def test_rle_encode_matches_jax(kind):
    """The vectorised varint encoder against the JAX package's on masks
    with few and many runs, long runs (large and negative differences) and
    no runs at all."""
    rng = np.random.RandomState(len(kind))
    h, w = 181, 263
    yy, xx = np.mgrid[:h, :w]
    m = {'noise': rng.rand(h, w) > 0.3,
         'blobs': ((yy - 90) / 70.0) ** 2 + ((xx - 120) / 100.0) ** 2 <= 1,
         'empty': np.zeros((h, w), bool), 'full': np.ones((h, w), bool),
         'stripes': (xx // rng.randint(1, 9, w)[xx] + yy) % 5 == 0}[kind]
    m = m.astype(np.uint8)
    enc = rle.encode(m)
    assert enc == j_rle.encode(m)
    np.testing.assert_array_equal(rle.decode(enc), m)
    assert rle.counts_to_string(np.zeros(0, np.int64)) == ''


def _tracks(rng, n, length, h, w, empty_frames=()):
    out = []
    for _ in range(n):
        segs = []
        for f in range(length):
            if f in empty_frames or rng.rand() < 0.15:
                segs.append(None)
                continue
            m = np.zeros((h, w), np.uint8)
            y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
            m[y:y + rng.randint(2, 8), x:x + rng.randint(2, 8)] = 1
            segs.append(rle.encode(m))
        out.append(segs)
    return out


def test_evaluate_ytvis_matches_jax():
    """Synthetic gt (a crowd track, an empty frame) and detections that
    partly overlap it: every metric equal to 1e-12."""
    rng = np.random.RandomState(7)
    h, w, length = 16, 20, 5
    videos, anns, dets = [], [], []
    ann_id = 1
    for vid in (1, 2, 3):
        videos.append({'id': vid, 'height': h, 'width': w, 'length': length,
                       'file_names': [f'{vid}/{f}.png'
                                      for f in range(length)]})
        gt = _tracks(rng, 3, length, h, w, empty_frames=(2,))
        for i, segs in enumerate(gt):
            anns.append({'id': ann_id, 'video_id': vid,
                         'category_id': 1 + (i + vid) % 3,
                         'iscrowd': int(vid == 2 and i == 0),
                         'segmentations': segs,
                         'areas': [None if s is None else rle.area(s)
                                   for s in segs]})
            ann_id += 1
            for _ in range(2):       # a near copy and a random track
                near = [s if s is None or rng.rand() < 0.7 else None
                        for s in segs]
                dets.append({'video_id': vid, 'score': float(rng.rand()),
                             'category_id': 1 + (i + vid) % 3,
                             'segmentations': near})
        for segs in _tracks(rng, 2, length, h, w):
            dets.append({'video_id': vid, 'score': float(rng.rand()),
                         'category_id': int(rng.randint(1, 4)),
                         'segmentations': segs})
    gt_json = {'videos': videos, 'annotations': anns,
               'categories': [{'id': i, 'name': str(i)} for i in (1, 2, 3)]}
    gt_json = json.loads(json.dumps(gt_json))
    want = j_evaluate_ytvis(gt_json, dets)
    got = evaluate_ytvis(gt_json, dets)
    assert set(got) == set(want)
    assert 0.0 < want['mAP'] < 1.0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    for max_dets in (1, 10):
        a = evaluate_ytvis(gt_json, dets, max_dets=max_dets)
        b = j_evaluate_ytvis(gt_json, dets, max_dets=max_dets)
        assert all(abs(a[k] - b[k]) <= 1e-12 for k in b)
    empty = evaluate_ytvis(gt_json, [])
    assert empty == j_evaluate_ytvis(gt_json, [])
