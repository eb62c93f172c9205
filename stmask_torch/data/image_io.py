"""Frame decoding for the eval CLI and the training loader (the
counterpart of ``stmask_tpu/data/loader.py::load_image_rgb``).

Where cv2 imports, every frame, PNG included, is read as the JAX loader
reads it: ``cv2.imread(path, IMREAD_COLOR)`` then BGR -> RGB (palette,
16-bit and interlaced PNGs alike).  Without cv2, PNG goes through a reader
of its own (stdlib ``zlib`` and numpy: 8-bit grey, grey + alpha, RGB and
RGBA, non-interlaced, all five row filters) and other formats through
PIL.  ``write_png`` writes the synthetic sets of the tests and of
``chip_smoke.py``.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # PNG colour type -> samples/pixel


def _paeth_row(raw: bytes, prior: bytearray, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(raw: bytes, prior: bytearray, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec, section 9) -> uint8 [h, stride].
    None, Sub and Up are vectorised; Average and Paeth walk the row."""
    if len(data) < h * (stride + 1):
        raise ValueError('PNG image data is truncated')
    rows = np.frombuffer(data, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    if not rows[:, 0].any():           # every row filter 0 (write_png's)
        return rows[:, 1:].copy()
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, raw = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = raw
        elif kind == 1:
            cur = (np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint64)
                   % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = raw + prior          # uint8 arithmetic wraps mod 256
        elif kind == 3:
            cur = np.frombuffer(_average_row(raw.tobytes(),
                                             bytearray(prior), bpp), np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_paeth_row(raw.tobytes(), bytearray(prior),
                                           bpp), np.uint8)
        else:
            raise ValueError(f'PNG row filter {kind} is not 0-4')
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit non-interlaced PNG -> uint8 [H, W, C], C the file's
    samples per pixel (1 grey, 2 grey + alpha, 3 RGB, 4 RGBA)."""
    with open(path, 'rb') as f:
        buf = f.read()
    if not buf.startswith(_SIGNATURE):
        raise ValueError(f'{path}: not a PNG file')
    pos, header, idat = len(_SIGNATURE), None, []
    while pos + 8 <= len(buf):
        length, ctype = struct.unpack('>I4s', buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif ctype == b'IDAT':
            idat.append(body)
        elif ctype == b'IEND':
            break
    if header is None:
        raise ValueError(f'{path}: PNG without IHDR')
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f'{path}: PNG bit depth {depth}, colour type {color}, interlace '
            f'{interlace}; the reader takes 8-bit grey/RGB/RGBA, '
            'non-interlaced (cv2, where it imports, reads them all)')
    ch = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b''.join(idat)), h, w * ch, ch)
    return pixels.reshape(h, w, ch)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + ctype + body
            + struct.pack('>I', zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """uint8 [H, W] grey or [H, W, 3|4] RGB(A) -> an 8-bit PNG, every row
    with filter 0 (None)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * ch)], axis=1)
    data = (_SIGNATURE
            + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color, 0, 0, 0))
            + _chunk(b'IDAT', zlib.compress(rows.tobytes(), level))
            + _chunk(b'IEND', b''))
    with open(path, 'wb') as f:
        f.write(data)


def load_image_rgb(path: str) -> np.ndarray:
    """A frame file -> uint8 [H, W, 3] RGB: ``cv2.imread(path,
    IMREAD_COLOR)`` then BGR -> RGB where cv2 imports; else the PNG reader
    above (grey replicated, alpha dropped) or PIL."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f'{path}: cv2 could not decode it')
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if path.lower().endswith('.png'):
        img = read_png(path)
        if img.shape[2] <= 2:
            return np.repeat(img[..., :1], 3, axis=2)
        return np.ascontiguousarray(img[..., :3])
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f'{path}: decoding a non-PNG frame needs cv2 or '
                          'PIL, and neither imports') from None
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'), np.uint8)
