"""Frame decoding: ``stmask_torch.data.image_io.load_image_rgb`` against
the JAX loader's ``load_image_rgb`` (cv2's ``IMREAD_COLOR`` then BGR ->
RGB) on PNGs of every kind the JAX loader reads (palette, 16-bit grey and
RGB, Adam7-interlaced, RGBA) and a JPEG; and the port's own PNG reader
when cv2 does not import."""

import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from stmask_tpu.data.loader import load_image_rgb as j_load_image_rgb

from stmask_torch.data.image_io import load_image_rgb, write_png

H, W = 29, 43
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))    # x0, y0, dx, dy


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + ctype + body
            + struct.pack('>I', zlib.crc32(ctype + body) & 0xFFFFFFFF))


def _png(path, samples: np.ndarray, color: int, interlace: int = 0,
         plte: bytes = b'') -> None:
    """An 8-bit PNG of ``samples`` (uint8 [H, W, C]) written by hand, every
    row with filter 0; Adam7 passes when ``interlace`` is 1."""
    h, w, ch = samples.shape
    if interlace:
        passes = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7]
    else:
        passes = [samples]
    raw = b''.join(
        np.concatenate([np.zeros((p.shape[0], 1), np.uint8),
                        p.reshape(p.shape[0], -1)], axis=1).tobytes()
        for p in passes if p.size)
    data = (b'\x89PNG\r\n\x1a\n'
            + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color, 0, 0,
                                          interlace))
            + (_chunk(b'PLTE', plte) if plte else b'')
            + _chunk(b'IDAT', zlib.compress(raw, 6))
            + _chunk(b'IEND', b''))
    with open(path, 'wb') as f:
        f.write(data)


def _rgb(seed: int, ch: int = 3, dtype=np.uint8) -> np.ndarray:
    rng = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    return rng.randint(0, top + 1, (H, W, ch)).astype(dtype)


def _write(kind: str, tmp_path) -> str:
    """The file of one case, made from numpy with a seed."""
    if kind == 'palette':
        path = str(tmp_path / 'palette.png')
        rng = np.random.RandomState(1)
        plte = rng.randint(0, 256, (37, 3)).astype(np.uint8)
        idx = rng.randint(0, 37, (H, W, 1)).astype(np.uint8)
        _png(path, idx, color=3, plte=plte.tobytes())
    elif kind == 'grey16':
        path = str(tmp_path / 'grey16.png')
        assert cv2.imwrite(path, _rgb(2, 1, np.uint16)[..., 0])
    elif kind == 'rgb16':
        path = str(tmp_path / 'rgb16.png')
        assert cv2.imwrite(path, _rgb(3, 3, np.uint16))
    elif kind == 'interlaced':
        path = str(tmp_path / 'adam7.png')
        _png(path, _rgb(4), color=2, interlace=1)
    elif kind == 'rgba':
        path = str(tmp_path / 'rgba.png')
        write_png(path, _rgb(5, 4))
    else:
        path = str(tmp_path / 'frame.jpg')
        assert cv2.imwrite(path, _rgb(6))
    return path


@pytest.mark.parametrize('kind', ['palette', 'grey16', 'rgb16',
                                  'interlaced', 'rgba', 'jpeg'])
def test_load_image_rgb_matches_jax_loader(tmp_path, kind):
    """Each frame reads bit for bit as cv2.imread(IMREAD_COLOR) then
    BGR -> RGB gives it, which is what the JAX loader returns."""
    path = _write(kind, tmp_path)
    want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)
    got = load_image_rgb(path)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, j_load_image_rgb(path))


def test_interlaced_png_holds_the_pixels(tmp_path):
    """The hand-written Adam7 file decodes to the pixels it was made from
    (so the case above compares real content)."""
    path = _write('interlaced', tmp_path)
    np.testing.assert_array_equal(load_image_rgb(path), _rgb(4))


def test_without_cv2_png_takes_the_own_reader(tmp_path, monkeypatch):
    """With cv2 hidden an 8-bit RGB PNG still reads, the same as cv2 reads
    it; a 16-bit one raises NotImplementedError naming cv2."""
    rgb = str(tmp_path / 'rgb.png')
    write_png(rgb, _rgb(7))
    want = load_image_rgb(rgb)
    deep = _write('rgb16', tmp_path)
    monkeypatch.setitem(sys.modules, 'cv2', None)
    np.testing.assert_array_equal(load_image_rgb(rgb), want)
    with pytest.raises(NotImplementedError, match='cv2'):
        load_image_rgb(deep)
