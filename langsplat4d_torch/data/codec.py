"""The port's image codec: csrc/imgcodec.cpp (host C++) bound with ctypes.

The counterpart of the JAX package's native codec (native/imgcodec.cpp with
`langsplat4d.native.load_image_chw`), for a host without libpng, libjpeg or
PIL: PNG (the chunks and the inflate here, with zlib; the scanline filters
in C++), baseline JPEG, PIL's resample and the float conversion. Every
foreign call releases the interpreter lock (ctypes does so for a CDLL), and
so does zlib's inflate, so the loop's threads decode in parallel.

The library is built at first use with the host C++ compiler (`c++`, else
`g++`; `CXX` names another) into langsplat4d_torch/_build/, keyed by a hash
of the source, the flags and the compiler, by utils/build.py, which is
safe between the loop's threads and between processes. Without a compiler
the codec raises, naming the compilers it looked for: the readers have no
other decoder (the numpy twins, data/png.py unfilter_rows,
data/resample.py and data/jpeg.py decode_jpeg, are for the tests).
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
from pathlib import Path

import numpy as np

from langsplat4d_torch.data import jpeg, png
from langsplat4d_torch.utils import build

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "imgcodec.cpp"
BUILD_DIR = _PKG / "_build"
# no contraction of a * b + c: the resample's float64 taps round as
# Pillow's (and the numpy twin's) do
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off")
COMPILERS = ("c++", "g++")
FILTERS = {"box": 0, "bilinear": 1, "bicubic": 2, "lanczos": 3}
JPEG_SIGNATURE = b"\xff\xd8"

_U8 = ctypes.POINTER(ctypes.c_uint8)
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_L = ctypes.c_int64
_ENTRY_POINTS = {
    "ls4d_png_unfilter": ((_U8, _I, _I, _I, _U8), _I),
    "ls4d_jpeg_info": ((_U8, _L, _IP, _IP, _IP), _I),
    "ls4d_jpeg_decode": ((_U8, _L, _U8), _I),
    "ls4d_resample": ((_U8, _I, _I, _I, _I, _I, _I, _U8), _I),
    "ls4d_chw_f32": ((_U8, _L, _I, ctypes.POINTER(ctypes.c_float)), None),
}


def compiler() -> str:
    """The host C++ compiler: `CXX`, else the first of COMPILERS on PATH."""
    found = os.environ.get("CXX") or next(
        (c for c in map(shutil.which, COMPILERS) if c), None)
    if not found:
        raise RuntimeError(
            f"no C++ compiler to build the image codec ({SOURCE.name}): "
            f"looked for {' and '.join(COMPILERS)} on PATH (or set CXX)")
    return found


def library_path() -> Path:
    return build.keyed_path(BUILD_DIR, "imgcodec", SOURCE.read_bytes(),
                            " ".join((compiler(),) + CXX_FLAGS).encode())


def build_library() -> Path:
    """Compile the codec (once per source, flags and compiler; safe between
    threads and processes, utils/build.py)."""
    lib = library_path()
    build.build({lib: lambda out: [compiler(), *CXX_FLAGS, "-o", out,
                                   SOURCE]})
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    for name, (args, res) in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = res
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> [H, W, C] uint8: the inflate in zlib, the filters in the
    codec."""
    rows, w, bpp = png.inflate_png(data, name)
    rows = np.ascontiguousarray(rows)
    out = np.empty((rows.shape[0], w, bpp), np.uint8)
    bad = load_library().ls4d_png_unfilter(_u8(rows), w, rows.shape[0], bpp,
                                           _u8(out))
    if bad:
        raise ValueError(f"{name}: unknown filter {rows[bad - 1, 0]} on row "
                         f"{bad - 1}")
    return out


def _jpeg_check(rc: int, name: str) -> None:
    """Raise for the C codec's code `rc`: the twin's error for what is not
    implemented (jpeg.UNSUPPORTED, the same codes), ValueError for corrupt
    data."""
    if rc in jpeg.UNSUPPORTED:
        raise jpeg.unsupported(rc, name)
    if rc:
        raise ValueError(f"{name}: corrupt or truncated JPEG data")


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Baseline JPEG bytes -> [H, W, C] uint8 (C = 1, or 3 in RGB), the
    bytes libjpeg gives."""
    lib = load_library()
    buf = np.frombuffer(data, np.uint8)
    w, h, c = _I(), _I(), _I()
    _jpeg_check(lib.ls4d_jpeg_info(_u8(buf), buf.size, ctypes.byref(w),
                                   ctypes.byref(h), ctypes.byref(c)), name)
    out = np.empty((h.value, w.value, c.value), np.uint8)
    _jpeg_check(lib.ls4d_jpeg_decode(_u8(buf), buf.size, _u8(out)), name)
    return out


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG or JPEG bytes, told apart by their signature -> [H, W, C]
    uint8."""
    if data[:8] == png.SIGNATURE:
        return decode_png(data, name)
    if data[:2] == JPEG_SIGNATURE:
        return decode_jpeg(data, name)
    raise NotImplementedError(f"{name}: neither PNG nor JPEG (the port's "
                              f"codec reads those two)")


def read_image(path: str) -> np.ndarray:
    """The PNG or JPEG file at `path` -> [H, W, C] uint8."""
    with open(path, "rb") as f:
        return decode(f.read(), path)


def resample(img: np.ndarray, size, filt: str = "bicubic") -> np.ndarray:
    """PIL's Image.resize(size, filt) of [H, W, C] uint8 (C = 1 to 4;
    `size` is (width, height)) -> [h, w, C] uint8."""
    if filt not in FILTERS:
        raise ValueError(f"unknown filter {filt!r}; expected one of "
                         f"{tuple(FILTERS)}")
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    ow, oh = int(size[0]), int(size[1])
    out = np.empty((oh, ow, c), np.uint8)
    if load_library().ls4d_resample(_u8(img), w, h, c, ow, oh, FILTERS[filt],
                                    _u8(out)):
        raise ValueError(f"cannot resample {w}x{h}x{c} to {ow}x{oh}")
    return out


def to_chw_f32(img: np.ndarray) -> np.ndarray:
    """[H, W, C] uint8 -> [C, H, W] float32, k / 255 in float32."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((c, h, w), np.float32)
    load_library().ls4d_chw_f32(_u8(img), h * w, c, out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)))
    return out


def load_chw(path: str, resize=None, filt: str = "bicubic") -> np.ndarray:
    """Decode the file at `path`, resize it to `resize` (width, height)
    with PIL's `filt` where given, and return [C, H, W] float32 k / 255:
    the JAX package's `native.load_image_chw`."""
    img = read_image(path)
    if resize is not None and tuple(resize) != (img.shape[1], img.shape[0]):
        img = resample(img, resize, filt)
    return to_chw_f32(img)
