"""PNG encode and decode with the standard library (zlib) and numpy.

The JAX package decodes images with its native codec (libpng) or PIL
(langsplat4d/data/readers.py:60-81); the port depends on neither. The
decoder reads 8-bit grey, grey + alpha, RGB and RGBA images, not
interlaced, with any of the five scanline filters per row: `inflate_png`
parses the chunks and inflates the image data, `unfilter_rows` undoes the
filters. The readers undo them in the port's codec (data/codec.py,
csrc/imgcodec.cpp); `unfilter_rows` is its plain twin, which the tests hold
it to: None and Up are numpy over the whole row, Sub a cumulative sum
modulo 256 per channel, and Average and Paeth, which depend on the decoded
left neighbour, walk the row byte by byte. Interlaced (Adam7), 16-bit and
palette images raise NotImplementedError.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 grey, 2 RGB, 4 grey + alpha, 6 RGBA)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def png_chunk(tag: bytes, data: bytes) -> bytes:
    """One chunk: length, tag, data and the CRC of tag and data."""
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _filtered_rows(img: np.ndarray):
    """The image's rows [H, W * C] (int32) under each of the five forward
    filters of the PNG specification, taken on the image's own bytes:
    [5, H, W * C], each entry modulo 256."""
    h, w = img.shape[:2]
    bpp = img.shape[2] if img.ndim == 3 else 1
    line = img.reshape(h, w * bpp).astype(np.int32)
    prev = np.pad(line, ((1, 0), (0, 0)))[:-1]
    left = np.pad(line, ((0, 0), (bpp, 0)))[:, :-bpp]
    upleft = np.pad(prev, ((0, 0), (bpp, 0)))[:, :-bpp]
    p = left + prev - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, prev, upleft))
    return np.stack([line, line - left, line - prev,
                     line - ((left + prev) >> 1), line - paeth]) % 256


def adaptive_filters(img: np.ndarray) -> np.ndarray:
    """The filter of each row as libpng's adaptive choice picks it (and
    PIL, cv2 and ffmpeg write through it): the one whose filtered bytes,
    read as signed, have the least sum of absolute values, the lower filter
    on a tie. [H] uint8, for `png_bytes(img, adaptive_filters(img))`."""
    cand = _filtered_rows(img)
    return np.minimum(cand, 256 - cand).sum(2).argmin(0).astype(np.uint8)


def png_bytes(img: np.ndarray, filters=0) -> bytes:
    """Encode an [H, W] or [H, W, C] uint8 image (C = 1 to 4) as PNG with
    scanline filter `filters` on every row, or `filters[y]` on row y: 0
    None, 1 Sub, 2 Up, 3 Average, 4 Paeth (the PNG specification's forward
    filters, taken on the image's own bytes)."""
    h, w = img.shape[:2]
    bpp = img.shape[2] if img.ndim == 3 else 1
    ft = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
    if ft.any():
        line = np.take_along_axis(_filtered_rows(img),
                                  ft[None, :, None].astype(np.int64),
                                  0)[0]
    else:
        line = img.reshape(h, w * bpp)
    raw = np.concatenate([ft[:, None], line.astype(np.uint8)], 1)
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]
    return (SIGNATURE
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                             0, 0, 0))
            + png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + png_chunk(b"IEND", b""))


def _average_row(line: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(len(line))
    for i in range(bpp):
        out[i] = (line[i] + (prev[i] >> 1)) & 255
    for i in range(bpp, len(line)):
        out[i] = (line[i] + ((out[i - bpp] + prev[i]) >> 1)) & 255
    return out


def _paeth_row(line: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(len(line))
    for i in range(bpp):                 # a = c = 0: the predictor is b
        out[i] = (line[i] + prev[i]) & 255
    for i in range(bpp, len(line)):
        a, b, c = out[i - bpp], prev[i], prev[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (line[i] + pred) & 255
    return out


def inflate_png(data: bytes, name: str = "<bytes>"):
    """PNG bytes -> (the inflated rows [H, 1 + W * C] uint8, each a filter
    byte and the row's filtered bytes; W; C). `name` labels the errors."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if interlace:
        raise NotImplementedError(f"{name}: Adam7-interlaced PNG")
    if depth != 8:
        raise NotImplementedError(f"{name}: {depth}-bit PNG")
    if color_type not in CHANNELS:
        raise NotImplementedError(f"{name}: PNG colour type {color_type}")
    bpp = CHANNELS[color_type]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{name}: {raw.size} bytes of image data for "
                         f"{w}x{h}x{bpp}")
    return raw.reshape(h, w * bpp + 1), w, bpp


def unfilter_rows(rows: np.ndarray, w: int, bpp: int,
                  name: str = "<bytes>") -> np.ndarray:
    """Undo the scanline filters of `inflate_png`'s rows -> [H, W, C]
    uint8 (the plain twin of the codec's ls4d_png_unfilter)."""
    h, stride = rows.shape[0], w * bpp
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            cur = line
        elif ft == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif ft == 2:
            cur = line + prev
        elif ft == 3:
            cur = np.frombuffer(_average_row(line.tobytes(), prev.tobytes(),
                                             bpp), np.uint8)
        elif ft == 4:
            cur = np.frombuffer(_paeth_row(line.tobytes(), prev.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError(f"{name}: unknown filter {ft} on row {y}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, bpp)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> [H, W, C] uint8 (C = 1, 2, 3 or 4) through the plain
    twin. `name` labels the errors."""
    rows, w, bpp = inflate_png(data, name)
    return unfilter_rows(rows, w, bpp, name)


def read_png(path: str) -> np.ndarray:
    """The PNG file at `path` -> [H, W, C] uint8."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)
