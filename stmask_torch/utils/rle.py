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
    """pycocotools rleToString: 5-bit varint with difference coding."""
    out = []
    for i, c in enumerate(cnts):
        x = int(c)
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            cc = x & 0x1F
            x >>= 5
            more = (x != -1) if (cc & 0x10) else (x != 0)
            if more:
                cc |= 0x20
            out.append(chr(cc + 48))
    return ''.join(out)


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


def decode(rle: Dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str} -> binary [h, w] uint8 mask."""
    h, w = rle['size']
    cnts = string_to_counts(rle['counts'])
    vals = np.zeros(int(cnts.sum()), dtype=np.uint8)
    pos = 0
    for i, c in enumerate(cnts):
        if i % 2:
            vals[pos:pos + c] = 1
        pos += int(c)
    return vals.reshape((w, h)).T  # Fortran order
