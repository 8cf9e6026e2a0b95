"""PIL's antialiased resize in numpy: the plain twin of the port's codec
(csrc/imgcodec.cpp ls4d_resample), which the tests hold it to byte for byte.

The JAX package resizes on load with its native codec, whose arithmetic is
Pillow's Resample.c (native/imgcodec.cpp), or with PIL itself; the GPU
machine has neither. The algorithm, as Pillow's: for each output index a
window of source indices around its centre, the filter's support scaled by
the downscale factor; the taps in float64, normalised to sum 1, rounded to
int32 with 22 fraction bits; a horizontal then a vertical pass on uint8,
each skipped where its size does not change, each accumulating from half a
unit and clipping to 0-255. Grey + alpha and RGBA are resized premultiplied
by alpha (Image.resize's "La" and "RGBa"), with Pillow's rounding in and
truncating division out. The filters' float64 arithmetic keeps the C
expressions' order, and the sine is Python's (the C library's), so the taps
round as Pillow's do.
"""
from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2
FILTERS = ("box", "bilinear", "bicubic", "lanczos")
_SUPPORT = {"box": 0.5, "bilinear": 1.0, "bicubic": 2.0, "lanczos": 3.0}
_ROWS = 64          # rows a pass gathers at once (bounds its memory)


def _sinc(x: np.ndarray) -> np.ndarray:
    pix = x * np.pi
    s = np.array([math.sin(v) for v in pix.reshape(-1)]).reshape(x.shape)
    return np.where(x == 0.0, 1.0, s / np.where(x == 0.0, 1.0, pix))


def _filter(name: str, x: np.ndarray) -> np.ndarray:
    if name == "box":
        return ((x > -0.5) & (x <= 0.5)).astype(np.float64)
    if name == "bilinear":
        x = np.abs(x)
        return np.where(x < 1.0, 1.0 - x, 0.0)
    if name == "bicubic":
        a = -0.5
        x = np.abs(x)
        return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                        np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a,
                                 0.0))
    if name == "lanczos":
        return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3),
                        0.0)
    raise ValueError(f"unknown filter {name!r}; expected one of {FILTERS}")


def coefficients(in_size: int, out_size: int, filt: str):
    """Pillow's precompute_coeffs and normalize_coeffs_8bpc for one axis:
    (first source index [out], taps [out], int64 taps [out, ksize], zero
    past each row's count)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT[filt] * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64)
    n = xmax - xmin
    x = np.arange(ksize)
    inside = x[None, :] < n[:, None]
    arg = ((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) \
        * (1.0 / filterscale)
    w = np.where(inside, _filter(filt, arg), 0.0)
    ww = np.zeros(out_size)
    for i in range(ksize):               # the C loop's order of additions
        ww = ww + w[:, i]
    k = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    one = float(1 << PRECISION_BITS)
    kk = np.where(k < 0, np.trunc(-0.5 + k * one), np.trunc(0.5 + k * one))
    return xmin, n, np.where(inside, kk, 0).astype(np.int64)


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.where(acc >= (1 << PRECISION_BITS << 8), 255,
                    np.where(acc <= 0, 0, acc >> PRECISION_BITS)
                    ).astype(np.uint8)


def _pass(img: np.ndarray, out_size: int, filt: str, axis: int
          ) -> np.ndarray:
    """One pass of [H, W, C] uint8 along `axis` (1 horizontal, 0
    vertical)."""
    xmin, _, kk = coefficients(img.shape[axis], out_size, filt)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1]),
                     img.shape[axis] - 1)
    src = np.moveaxis(img, axis, 0)      # [in, other, C]
    out = np.empty((out_size,) + src.shape[1:], np.uint8)
    for lo in range(0, src.shape[1], _ROWS):
        part = src[:, lo:lo + _ROWS].astype(np.int64)
        acc = np.full((out_size,) + part.shape[1:], 1 << (PRECISION_BITS - 1),
                      np.int64)
        for t in range(kk.shape[1]):
            acc += part[idx[:, t]] * kk[:, t, None, None]
        out[:, lo:lo + _ROWS] = _clip8(acc)
    return np.moveaxis(out, 0, axis)


def resample(img: np.ndarray, size, filt: str = "bicubic") -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8 for `size` (w, h), as
    Image.resize(size, filt) gives it; the same size is a copy."""
    if filt not in FILTERS:
        raise ValueError(f"unknown filter {filt!r}; expected one of "
                         f"{FILTERS}")
    ow, oh = int(size[0]), int(size[1])
    h, w, c = img.shape
    if (ow, oh) == (w, h):
        return img.copy()
    alpha = c in (2, 4)
    cur = img
    if alpha:                            # Convert.c rgbA2rgba: MULDIV255
        a = img[..., -1:].astype(np.uint32)
        t = img[..., :-1].astype(np.uint32) * a + 128
        cur = np.concatenate([(((t >> 8) + t) >> 8).astype(np.uint8),
                              img[..., -1:]], -1)
    if ow != w:
        cur = _pass(cur, ow, filt, 1)
    if oh != h:
        cur = _pass(cur, oh, filt, 0)
    if alpha:                            # rgba2rgbA: truncating division
        a = cur[..., -1:].astype(np.uint32)
        keep = (a == 255) | (a == 0)
        un = np.minimum(255, 255 * cur[..., :-1].astype(np.uint32)
                        // np.where(keep, 1, a))
        cur = np.concatenate([np.where(keep, cur[..., :-1], un)
                              .astype(np.uint8), cur[..., -1:]], -1)
    return np.ascontiguousarray(cur)
