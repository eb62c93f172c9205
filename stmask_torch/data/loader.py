"""Training clip loader: threaded decode, padded collate, prefetch (port of
``stmask_tpu/data/loader.py``).

Per-host index sharding with epoch-seeded determinism (reference
``DistributedGroupSampler``), a thread pool for JPEG decode, resize and
mask rasterisation (cv2 releases the GIL), static-shape padded batches,
and a background prefetch so that the host's data path overlaps the
device's steps.  A seed gives the JAX package's batches byte for byte.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..config import STMaskConfig
from .image_io import load_image_rgb
from .transforms import pad_gt, preprocess_frame
from .ytvis import YTVISDataset

ID_STRIDE = 100000      # ids of clip c in a batch: c * ID_STRIDE + id + 1


def shard_indices(index: Sequence, epoch: int, num_shards: int = 1,
                  shard_id: int = 0, shuffle: bool = True) -> List:
    """Epoch-seeded deterministic shuffle, then this shard's share, padded
    cyclically so that every shard sees the same count (reference
    ``sampler.py:98-132``)."""
    order = np.arange(len(index))
    if shuffle:
        np.random.RandomState(epoch).shuffle(order)
    per = (len(order) + num_shards - 1) // num_shards
    padded = np.concatenate([order, order[:per * num_shards - len(order)]])
    mine = padded[shard_id * per:(shard_id + 1) * per]
    return [index[i] for i in mine]


class ClipLoader:
    """Yields padded two-frame-clip batches for training.

    A batch: ``images`` [B, 2, pad_h, pad_w, 3] normalized float32, or with
    ``image_u8`` uint8 [B, 2, img_h, img_w, 3] (normalized and padded on
    the device); ``boxes``, ``labels``, ``ids``, ``valid``, ``masks_proto``
    (``np.packbits`` along the width under ``image_u8``), ``crowd_boxes``
    and ``crowd_valid`` at ``pad_gt``'s static capacities.  ``timing``
    sums the workers' seconds in decode and preprocess and the collate's,
    over ``timing['batches']`` batches."""

    def __init__(self, cfg: STMaskConfig, dataset: YTVISDataset,
                 batch_size: int, seed: int = 0, num_workers: int = 8,
                 num_shards: int = 1, shard_id: int = 0,
                 image_u8: bool = False):
        self.cfg = cfg
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = num_workers
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.image_u8 = image_u8
        self.index = dataset.train_index()
        self.timing = dict.fromkeys(('decode', 'preprocess', 'collate',
                                     'batches'), 0.0)
        self._lock = threading.Lock()
        if cfg.train_augment == 'extra':
            from .augment import ExtraAugmentation
            self.augment = ExtraAugmentation(photo_metric_distortion={},
                                             expand={}, random_crop={})
        elif cfg.train_augment == 'ssd':
            from .augment import SSDAugmentation
            self.augment = SSDAugmentation()
        else:
            self.augment = None

    def _add_time(self, key: str, seconds: float) -> None:
        with self._lock:
            self.timing[key] += seconds

    def _load_clip(self, vid: int, key_frame: int,
                   rng: np.random.RandomState) -> Dict:
        ref_frame = self.ds.sample_ref_frame(vid, key_frame, rng, 1)
        flip = rng.rand() < 0.5
        frames = []
        for f in (key_frame, ref_frame):
            t0 = time.perf_counter()
            img = load_image_rgb(self.ds.frame_path(vid, f))
            t1 = time.perf_counter()
            annots = self.ds.frame_annots(vid, f)
            if self.augment is not None and len(annots.boxes):
                # at the original resolution; crowd regions are dropped,
                # as the reference's extra_aug path does not augment them
                img, boxes, labels, masks, ids = self.augment(
                    img, annots.boxes, annots.labels, annots.masks,
                    annots.ids, rng=rng)
                annots = type(annots)(
                    boxes.astype(np.float32), labels, ids,
                    masks.astype(np.uint8),
                    crowd_boxes=np.zeros((0, 4), np.float32))
            frames.append(pad_gt(self.cfg, preprocess_frame(
                self.cfg, img, annots, flip=flip, image_u8=self.image_u8)))
            self._add_time('decode', t1 - t0)
            self._add_time('preprocess', time.perf_counter() - t1)
        return {k: np.stack([fr[k] for fr in frames]) for k in frames[0]}

    def epoch(self, epoch: int) -> Iterator[Dict]:
        """The batches of one epoch (a partial last batch is dropped)."""
        idx = shard_indices(self.index, epoch + self.seed,
                            self.num_shards, self.shard_id)
        rng = np.random.RandomState(epoch * 7919 + self.seed)
        bs = self.batch_size
        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(idx) - bs + 1, bs):
                chunk = idx[start:start + bs]
                seeds = [np.random.RandomState(rng.randint(2 ** 31))
                         for _ in chunk]
                clips = list(pool.map(
                    lambda a: self._load_clip(a[0][0], a[0][1], a[1]),
                    zip(chunk, seeds)))
                t0 = time.perf_counter()
                batch = {k: np.stack([c[k] for c in clips])
                         for k in clips[0]}
                batch['images'] = batch.pop('image')
                # ids unique within the batch, so that the cross-clip
                # contrastive loss never pairs two videos' instances
                ids = batch['ids']
                offset = (np.arange(ids.shape[0], dtype=np.int32)
                          * ID_STRIDE)[:, None, None]
                batch['ids'] = np.where(ids > 0, ids % ID_STRIDE + offset + 1,
                                        0).astype(np.int32)
                if self.image_u8:
                    batch['masks_proto'] = np.packbits(
                        batch['masks_proto'], axis=-1)
                self._add_time('collate', time.perf_counter() - t0)
                self._add_time('batches', 1)
                yield batch


class Prefetcher:
    """Runs ``it`` (and ``put_fn`` on each item) in a background thread,
    ``depth`` items ahead of the consumer.  An exception in the thread is
    raised in the consumer, so a failed decode or upload fails the
    training loop instead of ending the epoch early.  ``close`` stops the
    thread when the consumer leaves before the end."""

    def __init__(self, it: Iterator, put_fn: Optional[Callable] = None,
                 depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.put_fn = put_fn or (lambda x: x)
        self._done = object()
        self._stop = threading.Event()

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        break
                    self.q.put(self.put_fn(item))
            except BaseException as e:  # noqa: B036 — raised in consumer
                if not (isinstance(e, RuntimeError) and sys.is_finalizing()):
                    self.q.put(_PrefetchError(e))
            finally:
                if hasattr(it, 'close'):
                    it.close()          # a generator's pool shuts down
                self.q.put(self._done)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._done:
                return
            if isinstance(item, _PrefetchError):
                raise item.exc
            yield item

    def close(self) -> None:
        self._stop.set()
        while self.t.is_alive():
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass
        self.t.join()


class _PrefetchError:
    """A prefetch worker's exception on its way to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc
