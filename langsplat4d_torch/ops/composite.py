"""Stream compositing: each tile blends its segment of the (tile, depth)
sorted stream front to back (port of the `composite_stream_pallas` /
`_stream_kernel` TPU kernel in langsplat4d/ops/tile_composite.py).

`composite_stream` launches the hand-written CUDA kernel
(csrc/composite_stream.cu) for CUDA tensors and runs the plain PyTorch
version, `composite_stream_plain`, for CPU tensors only. The kernel is
compiled with nvcc at first use into `_build/` (keyed by a hash of the
source) and bound with ctypes.

Per pixel:
- power = -1/2 (c0 dx^2 + c2 dy^2) - c1 dx dy, evaluated as the TPU kernel
  does: six per-Gaussian coefficients against the tile-local basis
  [1, x, y, x^2, y^2, xy], summed as a chain of fused multiply-adds in
  basis order, with the coefficients formed by the same fused multiply-adds.
  That is how the JAX package's compiled kernel evaluates them on the CPU,
  bit for bit; at 32-px tiles the form cancels badly enough that any other
  rounding shows as ~1e-4 in the image.
- alpha = min(0.99, exp(power + ln_op)); a Gaussian is skipped when
  power > 0 or, with hard cutoffs, alpha < 1/255.
- With hard cutoffs the pixel stops before the first Gaussian that would
  take T below 1e-4 (the CUDA reference's rule).
- bg * T is added to rgb. Output channels are the feature rows (rgb, lang,
  depth, padding) then alpha.

Both versions do the same float32 operations in the same order: the kernel
uses fmaf for the chain and is built with --fmad=false so that nothing else
fuses; the plain version forms each fused multiply-add from an exact float64
product. So they agree bit for bit unless the device's expf differs from
PyTorch's.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

HDR = 8
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
MAX_ALPHA = 0.99

SUPPORTED_ROW_WIDTHS = (16, 24, 32)
SUPPORTED_TILE_SIZES = (16, 32)

_PKG = Path(__file__).resolve().parent.parent
KERNEL_SOURCE = _PKG / "csrc" / "composite_stream.cu"
BUILD_DIR = _PKG / "_build"
# --fmad=false keeps a*b+c as two roundings, as PyTorch's separate
# elementwise ops do, so the kernel's power sign tests (power > 0 kills a
# Gaussian) agree with the plain version's bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build_library() -> Path:
    """Compile the kernel source into a shared library (cached by a hash of
    the source and flags). Returns its path."""
    src = KERNEL_SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"composite_stream_{digest[:16]}.so"
    if lib.exists():
        return lib
    cmd = [_nvcc(), *NVCC_FLAGS]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd += ["-o", str(tmp), str(KERNEL_SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}"
                           f"\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.ls4d_composite_stream
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ls4d_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ls4d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_seconds() -> float:
    """Time to build (or find) and load the kernel library."""
    t0 = time.perf_counter()
    load_library()
    return time.perf_counter() - t0


def composite_stream(rows: torch.Tensor, starts: torch.Tensor,
                     bg: torch.Tensor, *, tiles_x: int, tiles_y: int,
                     tile_size: int, height: int, width: int,
                     hard_cutoffs: bool = True) -> torch.Tensor:
    """rows [M, PW] f32 (tile, depth)-sorted, starts [T+1] int32 segment
    bounds (T = tiles_x * tiles_y), bg [3] -> image [PW - 8 + 1, H, W]."""
    if rows.device.type == "cpu":
        return composite_stream_plain(
            rows, starts, bg, tiles_x=tiles_x, tiles_y=tiles_y,
            tile_size=tile_size, height=height, width=width,
            hard_cutoffs=hard_cutoffs)
    if rows.device.type != "cuda":
        raise ValueError(f"composite_stream: no kernel for {rows.device}")
    _check_cuda_args(rows, starts, bg, tiles_x * tiles_y, tile_size)
    pw = rows.shape[1]
    out = torch.empty((pw - HDR + 1, height, width), dtype=torch.float32,
                      device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        lib = load_library()
        err = lib.ls4d_composite_stream(
            rows.data_ptr(), starts.data_ptr(), bg.data_ptr(),
            out.data_ptr(), tiles_x * tiles_y, tiles_x, tile_size, height,
            width, pw, int(hard_cutoffs), stream)
    if err != 0:
        raise RuntimeError("composite_stream kernel launch failed: "
                           + lib.ls4d_cuda_error_string(err).decode())
    composite_stream.launches += 1
    return out


composite_stream.launches = 0


def _check_cuda_args(rows, starts, bg, num_tiles, tile_size):
    if rows.dtype != torch.float32 or rows.dim() != 2:
        raise ValueError(f"rows must be [M, PW] float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if rows.shape[1] not in SUPPORTED_ROW_WIDTHS:
        raise ValueError(f"row width {rows.shape[1]} not in "
                         f"{SUPPORTED_ROW_WIDTHS}")
    if tile_size not in SUPPORTED_TILE_SIZES:
        raise ValueError(f"tile size {tile_size} not in "
                         f"{SUPPORTED_TILE_SIZES}")
    if starts.dtype != torch.int32 or starts.shape != (num_tiles + 1,):
        raise ValueError(f"starts must be [{num_tiles + 1}] int32, got "
                         f"{tuple(starts.shape)} {starts.dtype}")
    if bg.dtype != torch.float32 or bg.shape != (3,):
        raise ValueError(f"bg must be [3] float32, got {tuple(bg.shape)}")
    for name, t in (("rows", rows), ("starts", starts), ("bg", bg)):
        if t.device != rows.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {rows.device}")


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding: the float64 product of two
    float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def composite_stream_plain(rows: torch.Tensor, starts: torch.Tensor,
                           bg: torch.Tensor, *, tiles_x: int, tiles_y: int,
                           tile_size: int, height: int, width: int,
                           hard_cutoffs: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the k-th Gaussian of every tile's
    segment is blended at step k, for all tiles and pixels at once."""
    dev = rows.device
    ts = tile_size
    num_tiles = tiles_x * tiles_y
    c_feat = rows.shape[1] - HDR
    starts = starts.long()
    seg_start = starts[:-1]
    seg_len = starts[1:] - seg_start
    kmax = int(seg_len.max()) if num_tiles else 0

    tile = torch.arange(num_tiles, device=dev)
    ox = ((tile % tiles_x) * ts).float()[:, None]
    oy = ((tile // tiles_x) * ts).float()[:, None]
    lx = torch.arange(ts, device=dev).repeat(ts).float()
    ly = torch.arange(ts, device=dev).repeat_interleave(ts).float()
    xx, yy, xy = lx * lx, ly * ly, lx * ly

    T = torch.ones((num_tiles, ts * ts), device=dev)
    acc = torch.zeros((c_feat, num_tiles, ts * ts), device=dev)
    asum = torch.zeros_like(T)
    done = torch.zeros_like(T, dtype=torch.bool)
    for k in range(kmax):
        valid = (k < seg_len)[:, None]
        r = rows[torch.clamp(seg_start + k, max=rows.shape[0] - 1)]
        mx = r[:, 0:1] - ox
        my = r[:, 1:2] - oy
        c0, c1, c2, ln_op = r[:, 2:3], r[:, 3:4], r[:, 4:5], r[:, 5:6]
        k0 = (-0.5 * _fma(c0 * mx, mx, c2 * my * my).double()
              - (c1 * mx * my).double()).float()
        k1 = _fma(c1, my, c0 * mx)
        k2 = _fma(c2, my, c1 * mx)
        power = k0
        for coef, basis in ((k1, lx), (k2, ly), (-0.5 * c0, xx),
                            (-0.5 * c2, yy), (-c1, xy)):
            power = _fma(coef, basis, power)
        alpha = torch.clamp(torch.exp(power + ln_op), max=MAX_ALPHA)
        skip = power > 0.0
        if hard_cutoffs:
            skip = skip | (alpha < ALPHA_MIN)
        test_T = T * (1.0 - alpha)
        live = valid & ~done & ~skip
        if hard_cutoffs:
            stop = live & (test_T < T_EPS)
            done = done | stop
            live = live & ~stop
        w = alpha * T
        acc = torch.where(live, acc + r[:, HDR:].T[:, :, None] * w, acc)
        asum = torch.where(live, asum + w, asum)
        T = torch.where(live, test_T, T)

    acc[:3] = acc[:3] + bg[:, None, None] * T
    img = torch.cat([acc, asum[None]], dim=0)           # [C+1, T, px]
    img = img.reshape(c_feat + 1, tiles_y, tiles_x, ts, ts)
    img = img.permute(0, 1, 3, 2, 4).reshape(c_feat + 1, tiles_y * ts,
                                              tiles_x * ts)
    return img[:, :height, :width].contiguous()
