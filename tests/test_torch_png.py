"""The port's stdlib PNG decoder (langsplat4d_torch/data/png.py): against
PIL on images PIL saves (RGB, RGBA, grey, grey + alpha, with and without
optimize=True), on PNGs that `png_bytes` writes with each of the five
scanline filters on every row and with mixed filters (read back by PIL too),
`png_bytes` round trips, and the formats it refuses. Every comparison is
byte-exact."""
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from langsplat4d_torch.data.png import (decode_png, png_bytes, png_chunk,
                                        read_png, SIGNATURE)

MODES = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}


def _image(rng, h, w, c):
    """Smooth gradients plus noise: content on which PIL's adaptive filter
    choice varies row by row."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (3 * xx + 5 * yy)[..., None] + 40 * np.arange(c)
    img = base + rng.integers(0, 12, size=(h, w, c))
    return (img % 256).astype(np.uint8)


def _with_header(img, depth=8, interlace=0, color_type=None):
    """`png_bytes(img)` with its header's bit depth, interlace method or
    colour type replaced: files the decoder refuses."""
    h, w, c = img.shape
    if color_type is None:
        color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                          color_type, 0, 0, interlace))
    return SIGNATURE + ihdr + png_bytes(img)[len(SIGNATURE) + len(ihdr):]


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_decoder_matches_pil(mode, optimize, tmp_path):
    rng = np.random.default_rng(len(mode) + 7 * optimize)
    img = _image(rng, 37, 53, MODES[mode])
    path = str(tmp_path / "a.png")
    Image.fromarray(img if MODES[mode] > 1 else img[..., 0], mode).save(
        path, optimize=optimize)
    want = np.asarray(Image.open(path)).reshape(img.shape)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)


def test_pil_writes_every_filter_that_the_decoder_sees(tmp_path):
    """PIL's adaptive filtering picks Sub and Paeth on such content (Paeth
    on most rows), so the PIL comparisons above reach the byte-walking
    filters; Average is held by the filtered PNGs below."""
    rng = np.random.default_rng(3)
    img = _image(rng, 64, 96, 3)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    data = buf.getvalue()
    body = b"".join(data[i + 8:i + 8 + struct.unpack(">I", data[i:i + 4])[0]]
                    for i in range(8, len(data))
                    if data[i + 4:i + 8] == b"IDAT")
    raw = np.frombuffer(zlib.decompress(body), np.uint8).reshape(64, -1)
    assert {1, 4} <= set(raw[:, 0].tolist())
    np.testing.assert_array_equal(decode_png(data), img)


def _pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_each_filter_on_every_row(ft, c):
    """`png_bytes` with one filter on every row: PIL and the decoder both
    read back the image."""
    rng = np.random.default_rng(10 * ft + c)
    img = rng.integers(0, 256, size=(9, 13, c), dtype=np.uint8)
    data = png_bytes(img, ft)
    assert set(np.frombuffer(zlib.decompress(data[41:-16]), np.uint8)
               .reshape(9, -1)[:, 0].tolist()) == {ft}
    np.testing.assert_array_equal(_pil_decode(data).reshape(img.shape), img)
    np.testing.assert_array_equal(decode_png(data), img)


def test_mixed_filters():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(25, 31, 3), dtype=np.uint8)
    data = png_bytes(img, rng.integers(0, 5, size=25))
    np.testing.assert_array_equal(_pil_decode(data), img)
    np.testing.assert_array_equal(decode_png(data), img)


@pytest.mark.parametrize("shape", [(7, 11, 3), (5, 9)])
def test_png_bytes_round_trip(shape):
    img = np.random.default_rng(2).integers(0, 256, size=shape,
                                            dtype=np.uint8)
    got = decode_png(png_bytes(img))
    np.testing.assert_array_equal(got.reshape(shape), img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(png_bytes(img)))), img)


def test_interlaced_and_16_bit_raise(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    path = tmp_path / "i.png"
    path.write_bytes(_with_header(img, interlace=1))
    with pytest.raises(NotImplementedError, match="i.png.*interlaced"):
        read_png(str(path))
    with pytest.raises(NotImplementedError, match="16-bit"):
        decode_png(_with_header(img, depth=16), "deep.png")
    with pytest.raises(NotImplementedError, match="colour type 3"):
        decode_png(_with_header(img[..., :1], color_type=3), "pal.png")
