"""COCO-style run-length encoding in NumPy (the port's copy of the pure
path of ``stmask_tpu/utils/rle.py``): Fortran-order binary runs starting
with zeros, compressed with pycocotools' 5-bit varint + difference coding —
the on-disk format the YTVIS evaluation servers expect."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """Binary [h, w] mask -> uncompressed RLE counts (Fortran order,
    starting with the zero-run)."""
    flat = np.asarray(mask).flatten(order='F').astype(np.uint8)
    if flat.size == 0:
        return np.zeros(0, dtype=np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    if flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return runs.astype(np.int64)


def counts_to_string(cnts: np.ndarray) -> str:
    """pycocotools rleToString: 5-bit varint with difference coding.

    Vectorised over the runs: step k emits the k-th 5-bit group of every
    value that still has one (bit 5 marks that another group follows), and
    the groups are read out value by value.  A Python loop over the runs,
    which holds the GIL, cost the eval CLI's postprocess threads more
    than the rest of a frame."""
    x = np.array(cnts, dtype=np.int64)
    if x.size > 3:
        x[3:] -= np.asarray(cnts, dtype=np.int64)[1:-2]
    groups, emitted = [], []
    active = np.ones(x.shape, bool)
    while active.any():
        cc = x & 0x1F
        x >>= 5                               # arithmetic: keeps the sign
        more = np.where(cc & 0x10, x != -1, x != 0)
        groups.append(cc | (more.astype(np.int64) << 5))
        emitted.append(active)
        active = active & more
    if not groups:
        return ''
    chars = np.stack(groups, axis=1)[np.stack(emitted, axis=1)] + 48
    return chars.astype(np.uint8).tobytes().decode('ascii')


def string_to_counts(s: str) -> np.ndarray:
    """pycocotools rleFrString."""
    cnts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return np.asarray(cnts, dtype=np.int64)


def encode(mask: np.ndarray) -> Dict:
    """Binary [h, w] mask -> {'size': [h, w], 'counts': str}."""
    h, w = mask.shape
    return {'size': [int(h), int(w)],
            'counts': counts_to_string(mask_to_counts(mask))}


def _counts(rle: Dict) -> np.ndarray:
    """Uncompressed counts of an RLE whose ``counts`` is a compressed
    string (or bytes) or already a list of run lengths."""
    counts = rle['counts']
    if isinstance(counts, bytes):
        counts = counts.decode()
    if isinstance(counts, str):
        return string_to_counts(counts)
    return np.asarray(counts, dtype=np.int64)


def decode(rle: Dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str|list} -> binary [h, w] uint8 mask."""
    h, w = rle['size']
    cnts = _counts(rle)
    vals = np.repeat((np.arange(len(cnts)) % 2).astype(np.uint8), cnts)
    return vals.reshape((w, h)).T  # Fortran order


def area(rle: Dict) -> int:
    """Number of ones of an RLE mask."""
    return int(_counts(rle)[1::2].sum())
