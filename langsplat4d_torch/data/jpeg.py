"""Baseline JPEG encoding with numpy and the standard library.

The JAX package writes JPEG through cv2 (the eval's ground-truth masks,
langsplat4d/eval/evaluate.py:85-93) and PIL (the training snapshots,
langsplat4d/utils/scene_vis.py); the port depends on neither. This is a
baseline sequential encoder (ITU T.81): 8x8 blocks, a floating-point DCT,
the example quantization tables of Annex K.1 scaled by quality as libjpeg
scales them (`jpeg_quality_scaling`), and the example Huffman tables of
Annex K.3. Grey images are one component; RGB images are YCbCr (JFIF) at
full resolution in all three components (4:4:4: cv2 and PIL subsample the
chroma 2x2, which a decoder reads just the same), optionally with a restart
marker every `restart` MCUs. The entropy coder is numpy over the whole
image: the symbols of every block are formed at once, put in scan order by
one stable sort, and packed into bits together.

`decode_jpeg` is the plain twin of the port's codec (csrc/imgcodec.cpp,
data/codec.py), which the tests hold it to byte for byte: baseline
sequential Huffman JPEG, 8-bit, 1 or 3 components at 4:4:4, 4:2:2 or
4:2:0, with restart intervals, through libjpeg's integer inverse DCT
(jidctint.c, islow), fancy upsampling (jdsample.c) and fixed-point YCbCr
to RGB (jdcolor.c), so that it gives libjpeg's bytes. The Huffman decode
is a Python loop; the rest is numpy over every block or row at once.
Progressive, arithmetic-coded, lossless, 12-bit and 4-component files
raise NotImplementedError naming the file.
"""
from __future__ import annotations

import struct

import numpy as np

# Annex K.1, in natural (row-major) order
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64).reshape(8, 8)
CHROMA_Q = np.full((8, 8), 99, np.int64)
CHROMA_Q[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                    [47, 66, 99, 99]]

# Annex K.3: code counts by length 1-16, then the symbols in code order
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])

# ZIGZAG[k] is the natural index of the k-th coefficient in zigzag order
ZIGZAG = np.array(sorted(
    range(64), key=lambda i: (i // 8 + i % 8,
                              (i % 8) if (i // 8 + i % 8) % 2 == 0
                              else (i // 8))), np.int64)
# the orthonormal 8-point DCT-II: F = D f D^T is T.81's FDCT; on a block
# flattened row-major, F = kron(D, D) f, one product for all blocks
_U = np.arange(8)
DCT = (np.sqrt(np.where(_U == 0, 1.0, 2.0) / 8.0)[:, None]
       * np.cos((2 * _U[None, :] + 1) * _U[:, None] * np.pi / 16))
DCT2 = np.kron(DCT, DCT)
# JFIF's RGB -> YCbCr (Cb and Cr then offset by 128)
RGB_TO_YCC = np.array([[0.299, 0.587, 0.114],
                       [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]])


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling and jpeg_add_quant_table with
    force_baseline: 5000 / q below 50, 200 - 2 q from 50; each entry
    (base * scale + 50) // 100, clamped to 1-255."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def huffman_codes(spec):
    """Annex C: (code [256], length [256]) of each symbol from the counts
    by length and the symbols in code order."""
    counts, symbols = spec
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n_bits, count in enumerate(counts, start=1):
        for _ in range(count):
            code[symbols[k]], length[symbols[k]] = c, n_bits
            c += 1
            k += 1
        c <<= 1
    return code, length


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(body) + 2) + body


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] -> [H8 / 8 * W8 / 8, 64] blocks in raster order, each
    flattened row-major, the image padded to a multiple of 8 by repeating
    its last row and column (as libjpeg pads)."""
    h, w = plane.shape
    plane = np.pad(plane, ((0, -h % 8), (0, -w % 8)), mode="edge")
    hb, wb = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3).reshape(-1, 64)


def _size(v: np.ndarray) -> np.ndarray:
    """The magnitude category of each value: bits of |v| (0 for 0)."""
    a = np.abs(v)
    s = np.zeros(a.shape, np.int64)
    nz = a > 0
    s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return s


def _extra(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The appended bits of value v of category s (F.1.2.1: negative values
    as v - 1 in s bits)."""
    return np.where(v >= 0, v, v + (1 << s) - 1)


def _entropy_code(coefs: np.ndarray, comp: np.ndarray, tables) -> bytes:
    """Huffman-coded scan data of the quantized blocks `coefs` [B, 64]
    (zigzag order) in scan order; comp[b] picks block b's tables and DC
    predictor. `tables[c]` = (dc code, dc length, ac code, ac length).
    Every symbol is (code, code length, extra bits, extra length); the
    symbols of all blocks are built at once and stably sorted by (block,
    position) into scan order, then packed into bits and byte-stuffed."""
    nb = coefs.shape[0]
    dc = coefs[:, 0]
    diff = np.empty(nb, np.int64)
    for c in np.unique(comp):          # one predictor per component
        idx = np.nonzero(comp == c)[0]
        diff[idx] = np.diff(dc[idx], prepend=0)
    sym_key, sym_comp, sym_ac, sym_val, sym_bits, sym_blen = (
        [], [], [], [], [], [])

    def add(key, c, is_ac, symbol, bits, blen):
        sym_key.append(key)
        sym_comp.append(c)
        sym_ac.append(np.broadcast_to(is_ac, key.shape))
        sym_val.append(symbol)
        sym_bits.append(bits)
        sym_blen.append(blen)

    blocks = np.arange(nb)
    s = _size(diff)
    add(blocks * 256, comp, False, s, _extra(diff, s), s)
    b, k = np.nonzero(coefs[:, 1:])
    k = k + 1
    v = coefs[b, k]
    first = np.ones(b.shape, bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.roll(k, 1))
    run = k - prev - 1
    s = _size(v)
    add(b * 256 + 2 * k, comp[b], True, (run % 16) * 16 + s, _extra(v, s), s)
    n_zrl = run // 16                  # 16 zeros each, before the symbol
    zb = np.repeat(b, n_zrl)
    zk = np.repeat(k, n_zrl)
    zero = np.zeros(zb.shape, np.int64)
    add(zb * 256 + 2 * zk - 1, comp[zb], True, zero + 0xF0, zero, zero)
    last = np.zeros(nb, np.int64)      # position of each block's last AC
    last[b] = k
    eb = np.nonzero(last < 63)[0]
    zero = np.zeros(eb.shape, np.int64)
    add(eb * 256 + 200, comp[eb], True, zero, zero, zero)   # EOB

    key = np.concatenate(sym_key)
    order = np.argsort(key, kind="stable")
    # one lookup in every table at once: table (component, DC or AC) t
    # holds symbol v at 256 t + v
    slot = (np.concatenate(sym_comp) * 512 + np.concatenate(sym_ac) * 256
            + np.concatenate(sym_val))[order]
    bits = np.concatenate(sym_bits)[order]
    blen = np.concatenate(sym_blen)[order]
    code = np.concatenate([t[i] for t in tables for i in (0, 2)])[slot]
    clen = np.concatenate([t[i] for t in tables for i in (1, 3)])[slot]
    if (clen == 0).any():
        raise ValueError("a symbol outside the Huffman table")
    value = (code << blen) | bits
    total = clen + blen                # at most 16 + 11 bits
    start = np.cumsum(total) - total
    n_bits = int(total.sum())
    # each symbol left-aligned in a 40-bit word at its first byte; the
    # symbols' bits are disjoint, so the bytes' sum is their OR
    word = value << (40 - (start % 8) - total)
    n_bytes = (n_bits + 7) // 8
    data = np.zeros(n_bytes + 5, np.int64)
    for i in range(5):
        data += np.bincount(start // 8 + i, minlength=n_bytes + 5,
                            weights=(word >> (32 - 8 * i)) & 0xFF
                            ).astype(np.int64)
    data = data[:n_bytes]
    if n_bits % 8:                     # pad the last byte with 1 bits
        data[-1] |= (1 << (-n_bits % 8)) - 1
    data = data.astype(np.uint8)
    ff = np.nonzero(data == 0xFF)[0]   # a 0xFF byte is followed by 0x00
    return np.insert(data, ff + 1, 0).tobytes()


def jpeg_bytes(img: np.ndarray, quality: int = 75, restart: int = 0
               ) -> bytes:
    """Encode an [H, W] (or [H, W, 1]) grey or [H, W, 3] RGB uint8 image as
    a baseline JFIF JPEG at `quality` (1-100, libjpeg's scale: cv2's
    default is 95, PIL's 75), with a restart marker after every `restart`
    MCUs (0: none)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"jpeg_bytes takes uint8, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"jpeg_bytes takes [H, W] or [H, W, 3], not "
                         f"{img.shape}")
    h, w = img.shape[:2]
    x = img.astype(np.float32)
    if img.ndim == 2:
        planes = [x]
    else:               # per channel: a [N, 3] x [3, 3] product is slower
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = [sum(np.float32(c) * ch for c, ch in zip(row, (r, g, b)))
                  + np.float32(off) for row, off in zip(RGB_TO_YCC,
                                                        (0.0, 128.0, 128.0))]
    qts = [quant_table(LUMA_Q, quality), quant_table(CHROMA_Q, quality)]
    coefs = []
    for c, p in enumerate(planes):
        # the transform in zigzag order, each row over its quantizer
        m = (DCT2[ZIGZAG] / qts[min(c, 1)].reshape(-1)[ZIGZAG, None]).T
        coefs.append(np.rint(_blocks(p - np.float32(128.0))
                             @ m.astype(np.float32)).astype(np.int64))
    nc, nb = len(planes), coefs[0].shape[0]
    # interleaved scan: the components' blocks alternate, one of each a MCU
    coefs = np.stack(coefs, 1).reshape(nb * nc, 64)
    comp = np.tile(np.arange(nc), nb)
    specs = [(DC_LUMA, AC_LUMA), (DC_CHROMA, AC_CHROMA)]
    tables = [huffman_codes(specs[min(c, 1)][0])
              + huffman_codes(specs[min(c, 1)][1]) for c in range(nc)]
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, qt in enumerate(qts[:min(nc, 2)]):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            qt.reshape(-1)[ZIGZAG].astype(np.uint8))))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([c + 1, 0x11, min(c, 1)]) for c in range(nc))))
    for t in range(min(nc, 2)):
        for cls, (counts, symbols) in enumerate(specs[t]):
            out.append(_segment(0xC4, bytes([cls << 4 | t]) + bytes(counts)
                                + bytes(symbols)))
    if restart:
        out.append(_segment(0xDD, struct.pack(">H", restart)))
    out.append(_segment(0xDA, bytes([nc]) + b"".join(
        bytes([c + 1, min(c, 1) << 4 | min(c, 1)]) for c in range(nc))
        + b"\x00\x3f\x00"))
    # each interval of `restart` MCUs coded on its own (its DC predictors
    # start from 0), then the marker RST0-RST7 in turn
    step = (restart or nb) * nc
    for i, lo in enumerate(range(0, nb * nc, step)):
        if i:
            out.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
        out.append(_entropy_code(coefs[lo:lo + step], comp[lo:lo + step],
                                 tables))
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path: str, img: np.ndarray, quality: int = 75) -> None:
    with open(path, "wb") as f:
        f.write(jpeg_bytes(img, quality))


# --------------------------------------------------------------------------
# decoding: the plain twin of csrc/imgcodec.cpp's JPEG decoder

# what the decoders refuse, by the C codec's codes (csrc/imgcodec.cpp
# JpegError)
UNSUPPORTED = {2: "progressive JPEG", 3: "arithmetic-coded JPEG",
               4: "JPEG of a precision other than 8 bits",
               5: "JPEG of other than 1 or 3 components (CMYK?)",
               6: "JPEG chroma sampling other than 4:4:4, 4:2:2 or 4:2:0",
               7: "lossless or hierarchical JPEG"}
_SOF_REFUSED = {0xC2: 2, 0xC6: 2, 0xCA: 2, 0xCE: 2, 0xC3: 7, 0xC7: 7,
                0xCB: 7, 0xCF: 7, 0xC5: 7, 0xC9: 3, 0xCC: 3, 0xCD: 3}
# zigzag position -> natural index, and 16 more entries of 63 (libjpeg's
# jpeg_natural_order: a corrupt run length cannot index past the block)
NATURAL = np.concatenate([ZIGZAG, np.full(16, 63)]).tolist()
# jidctint.c's constants (CONST_BITS 13, PASS1_BITS 2)
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def unsupported(code: int, name: str) -> NotImplementedError:
    return NotImplementedError(f"{name}: {UNSUPPORTED[code]} (the port "
                               f"decodes baseline JPEG)")


def _lookup(counts, symbols):
    """A 16-bit lookahead table of a Huffman table: entry (length << 8 |
    symbol) for every 16-bit prefix that starts with a code, else 0."""
    table = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = length << 8 | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _idct_1d(x, final_shift):
    """One pass of jpeg_idct_islow over the last axis of the int64 array x
    [..., 8]: the eight outputs, each descaled by `final_shift`."""
    def descale(v):
        return (v + (1 << (final_shift - 1))) >> final_shift
    f = _F
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * f["f0541"]
    t2 = z1 + z3 * -f["f1847"]
    t3 = z1 + z2 * f["f0765"]
    t0 = (x[..., 0] + x[..., 4]) * (1 << 13)
    t1 = (x[..., 0] - x[..., 4]) * (1 << 13)
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    t0, t1, t2, t3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0, t1 = t0 * f["f0298"], t1 * f["f2053"]
    t2, t3 = t2 * f["f3072"], t3 * f["f1501"]
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3, z4 = z3 * -f["f1961"] + z5, z4 * -f["f0390"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return np.stack([descale(t10 + t3), descale(t11 + t2),
                     descale(t12 + t1), descale(t13 + t0),
                     descale(t13 - t0), descale(t12 - t1),
                     descale(t11 - t2), descale(t10 - t3)], -1)


def idct_islow(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """libjpeg's jpeg_idct_islow: quantized blocks [N, 64] (natural order)
    and their table [64] -> samples [N, 8, 8] uint8."""
    x = coefs.astype(np.int64).reshape(-1, 8, 8) * qt.reshape(8, 8)
    ws = _idct_1d(np.swapaxes(x, 1, 2), 11)          # columns
    out = _idct_1d(np.swapaxes(ws, 1, 2), 18)        # rows
    v = out & 1023                                   # the range limit
    v = np.where(v >= 512, v - 1024, v) + 128
    return np.clip(v, 0, 255).astype(np.uint8)


def _fancy_h(s: np.ndarray, width: int, h2v2: bool) -> np.ndarray:
    """jdsample.c's horizontal doubling of rows `s` [R, dw] (int64; for
    h2v2 the vertical column sums 3 near + far) -> [R, width]."""
    r, dw = s.shape
    out = np.empty((r, 2 * dw), np.int64)
    if h2v2:
        out[:, 0] = (s[:, 0] * 4 + 8) >> 4
        out[:, 2::2] = (s[:, 1:] * 3 + s[:, :-1] + 8) >> 4
        out[:, 1:-1:2] = (s[:, :-1] * 3 + s[:, 1:] + 7) >> 4
        out[:, -1] = (s[:, -1] * 4 + 7) >> 4
    else:
        out[:, 0] = s[:, 0]
        out[:, 2::2] = (s[:, 1:] * 3 + s[:, :-1] + 1) >> 2
        out[:, 1:-1:2] = (s[:, :-1] * 3 + s[:, 1:] + 2) >> 2
        out[:, -1] = s[:, -1]
    return out[:, :width]


def _upsample(plane: np.ndarray, rx: int, ry: int, height: int,
              width: int) -> np.ndarray:
    """A component's samples [dh, dw] at the image's size, as libjpeg's
    upsampler gives them (fancy, or box where dw <= 2)."""
    dh, dw = plane.shape
    p = plane.astype(np.int64)
    if rx == 1 and ry == 1:
        return p[:height, :width]
    if dw <= 2:
        return np.repeat(np.repeat(p, ry, 0), rx, 1)[:height, :width]
    if ry == 1:
        return _fancy_h(p, width, False)[:height]
    up = np.concatenate([p[:1], p[:-1]])             # the row above
    down = np.concatenate([p[1:], p[-1:]])           # the row below
    rows = np.empty((2 * dh, dw), np.int64)
    rows[0::2] = p * 3 + up
    rows[1::2] = p * 3 + down
    return _fancy_h(rows[:height], width, True)


def _ycc_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert (SCALEBITS 16, its tables)."""
    def fix(v):
        return int(v * 65536 + 0.5)
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + (1 << 15)) >> 16
    cb_b = (fix(1.77200) * x + (1 << 15)) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + (1 << 15)
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                    y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _scan_segments(data: bytes, pos: int):
    """The entropy-coded bytes of the scan at `pos`, split at its restart
    markers, each with the stuffed zero after 0xFF removed; and the
    position of the marker that ends the scan."""
    segments, start, p, n = [], pos, pos, len(data)
    while p + 1 < n:
        if data[p] == 0xFF and data[p + 1] != 0x00:
            if 0xD0 <= data[p + 1] <= 0xD7:
                segments.append(data[start:p])
                start = p = p + 2
                continue
            if data[p + 1] == 0xFF:      # a fill byte before a marker
                p += 1
                continue
            break
        p += 1
    segments.append(data[start:p])
    return [s.replace(b"\xff\x00", b"\xff") for s in segments], p


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Baseline JPEG bytes -> [H, W, C] uint8 (C = 1, or 3 in RGB), the
    bytes libjpeg gives; `name` labels the errors."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    qts, dc, ac, comps = {}, {}, {}, []
    frame, restart, jfif, adobe = None, 0, False, None
    pos, n, scanned = 2, len(data), False
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n or data[pos] == 0xD9:
            break
        m = data[pos]
        pos += 1
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos + 2:pos + length]
        pos += length
        if m in _SOF_REFUSED:
            raise unsupported(_SOF_REFUSED[m], name)
        if m in (0xC0, 0xC1):
            precision, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise unsupported(4, name)
            if nc not in (1, 3):
                raise unsupported(5, name)
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                comps.append(dict(id=cid, h=hv >> 4 if nc > 1 else 1,
                                  v=hv & 15 if nc > 1 else 1, tq=tq & 3))
            frame = (h, w)
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            for c in comps:
                if (hmax % c["h"] or vmax % c["v"]
                        or (hmax // c["h"], vmax // c["v"])
                        not in ((1, 1), (2, 1), (2, 2))):
                    raise unsupported(6, name)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                c["dw"] = -(-w * c["h"] // hmax)
                c["dh"] = -(-h * c["v"] // vmax)
                c["coef"] = np.zeros((mcuy * c["v"], mcux * c["h"], 64),
                                     np.int16)
        elif m == 0xC4:
            p = 0
            while p < len(seg):
                cls, th = seg[p] >> 4, seg[p] & 3
                counts = list(seg[p + 1:p + 17])
                symbols = list(seg[p + 17:p + 17 + sum(counts)])
                (ac if cls else dc)[th] = _lookup(counts, symbols)
                p += 17 + sum(counts)
        elif m == 0xDB:
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 3
                size = 2 if pq else 1
                vals = np.frombuffer(seg[p + 1:p + 1 + 64 * size],
                                     ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals
                qts[tq] = q
                p += 1 + 64 * size
        elif m == 0xDD:
            restart = struct.unpack(">H", seg[:2])[0]
        elif m == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: a scan before the frame header")
            ns = seg[0]
            sc = []
            for i in range(ns):
                cid, t = seg[1 + 2 * i:3 + 2 * i]
                k = next(j for j, c in enumerate(comps) if c["id"] == cid)
                sc.append((comps[k], dc[t >> 4 & 3], ac[t & 3]))
            segments, pos = _scan_segments(data, pos)
            _decode_scan(sc, segments, restart, frame, ns == 1)
            scanned = True
    if not scanned:
        raise ValueError(f"{name}: no scan")
    h, w = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = []
    for c in comps:
        bh, bw, _ = c["coef"].shape
        blocks = idct_islow(c["coef"].reshape(-1, 64), qts[c["tq"]])
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8)[:c["dh"], :c["dw"]]
        planes.append(_upsample(plane, hmax // c["h"], vmax // c["v"], h, w))
    if len(comps) == 1:
        return planes[0].astype(np.uint8)[..., None]
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = [c["id"] for c in comps] == [82, 71, 66]
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_rgb(*planes)


def _decode_scan(sc, segments, restart, frame, single):
    """Huffman-decode one scan's blocks into its components' `coef`
    (T.81 F.2.2, libjpeg's decode_mcu: DC predictors per component, reset
    at each restart; past the data, zero bits)."""
    h, w = frame
    if single:
        c = sc[0][0]
        ux, uy = -(-c["dw"] // 8), -(-c["dh"] // 8)
    else:
        hmax = max(c["h"] for c, _, _ in sc)
        vmax = max(c["v"] for c, _, _ in sc)
        ux, uy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    layout = [(c, dct, act, 1 if single else c["h"], 1 if single else c["v"])
              for c, dct, act in sc]
    per = restart or ux * uy
    for first in range(0, ux * uy, per):
        seg = segments[first // per] if first // per < len(segments) else b""
        d = seg + bytes(8)
        limit = 8 * len(seg)
        bitpos = 0
        pred = [0] * len(sc)

        def bits(k):
            nonlocal bitpos
            if k == 0:
                return 0
            b = bitpos >> 3
            v = int.from_bytes(d[b:b + 4], "big") if b + 4 <= len(d) else 0
            v = (v >> (32 - (bitpos & 7) - k)) & ((1 << k) - 1) \
                if bitpos < limit else 0
            bitpos += k
            return v

        def symbol(table):
            nonlocal bitpos
            b = bitpos >> 3
            v = (int.from_bytes(d[b:b + 3], "big") >> (8 - (bitpos & 7))
                 ) & 0xFFFF if bitpos < limit else 0
            e = table[v]
            if not e:
                raise ValueError("corrupt JPEG data: no Huffman code")
            bitpos += e >> 8
            return e & 0xFF

        for u in range(first, min(first + per, ux * uy)):
            mx, my = u % ux, u // ux
            for i, (c, dct, act, hh, vv) in enumerate(layout):
                coef = c["coef"]
                for by in range(vv):
                    for bx in range(hh):
                        blk = [0] * 64
                        t = symbol(dct)
                        diff = bits(t)
                        if t and diff < (1 << (t - 1)):
                            diff -= (1 << t) - 1
                        pred[i] += diff
                        blk[0] = pred[i]
                        k = 1
                        while k < 64:
                            rs = symbol(act)
                            r, s = rs >> 4, rs & 15
                            if s:
                                k += r
                                v = bits(s)
                                if v < (1 << (s - 1)):
                                    v -= (1 << s) - 1
                                blk[NATURAL[k]] = v
                            elif r != 15:
                                break
                            else:
                                k += 15
                            k += 1
                        coef[my * vv + by, mx * hh + bx] = np.array(
                            blk, np.int64).astype(np.int16)
