"""The compositors: each tile blends its Gaussians front to back (ports of
the TPU kernels in langsplat4d/ops/tile_composite.py).

- `composite_stream` (TPU kernel `composite_stream_pallas` / `_stream_kernel`):
  the render path; each tile blends its ragged segment of the (tile, depth)
  sorted stream and the image [C+1, H, W] is written directly.
- `composite_tiles` (`composite_tiles_pallas` / `_composite_kernel`): the
  training forward; each tile blends the first counts[t] rows of its padded
  list and writes accum [T, C+1, px].
- `composite_tiles_backward` (`composite_backward_pallas` /
  `_backward_kernel`): per-(tile, slot) gradient rows of that blend.
- `composite_stream_chunks` (`composite_stream_chunks_pallas` /
  `_stream_chunk_fwd_kernel`): the training forward on the stream layout;
  each tile blends its ragged segment and writes accum [T, C+1, px]. The
  names keep the JAX functions', but the port has no chunks: the TPU kernels
  need a chunk-aligned stream with padding slots and a chunk-to-tile table
  because their grid is sequential; here a block owns a tile and the stream
  is dense, rows [B, PW] with segment bounds starts [T+1].
- `composite_stream_chunks_backward`
  (`composite_stream_chunks_backward_pallas` / `_stream_chunk_bwd_kernel`):
  one gradient row per slot of that stream.
- `composite_cells` (`composite_cells_pallas` / `_cell_kernel`): a render
  option; every tile walks the depth-ordered candidates of its cell of
  cell x cell tiles and keeps those whose tile rect (row columns 6 and 7,
  x + 256 y) covers it; no per-tile lists, no capacity.

Each wrapper launches its hand-written CUDA kernel (csrc/*.cu) for CUDA
tensors and runs the plain PyTorch version beside it (`*_plain`) for CPU
tensors only. The kernels are compiled with nvcc at first use into `_build/`
(keyed by a hash of the source, the shared header and the flags), one library
per source, and bound with ctypes.

The tile-list kernels hold their rows row-major, [T, K, PW]: a tile's rows
are one contiguous run that a block stages with coalesced loads. The TPU
kernels hold [T, PW, K] (K on lanes); callers that compare with them swap the
last two axes.

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
- With hard cutoffs the pixel stops for good before the first Gaussian that
  would take T below 1e-4 (the CUDA reference's rule).
- bg * T is added to rgb. Output channels are the feature rows (rgb, lang,
  depth, padding) then alpha.

The forward kernels and their plain versions do the same float32 operations
in the same order: the kernels use fmaf for the chain and are built with
--fmad=false so that nothing else fuses; the plain versions form each fused
multiply-add from an exact float64 product. So they agree bit for bit unless
the device's expf differs from PyTorch's. The backward kernels sum over a
tile's pixels in another order than their plain versions (warp shuffles) and
multiply by an approximate reciprocal where those divide by 1 - alpha, so
they agree to rounding only.

The pieces of the kernels' logic that the plain versions do not exercise
have plain twins here for the CPU tests: the cover tests of the forward
walk (`quadrant_cover_plain`: the stream kernel composites a 32-px tile as
four 16x16 quadrants, each blending only the rows the test keeps for it,
with `composite_stream_quadrants_plain` the whole scheme;
`tile_cover_plain`, the same test against a 16-px tile, which the
tile-list kernel applies, with `composite_tiles_plain(cull=True)` its
scheme; `composite_cells_plain(cull=True)` applies it to the cell rows and
counts the pairs that the cell kernel's bound charges), the cell rows' rect
decode (`rect_decode_plain`) and `warp_transpose_sum_plain` (the lane
schedule of the backward kernels' warp reduction).
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
from typing import Dict, Optional, Tuple

import torch

HDR = 8
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
MAX_ALPHA = 0.99

SUPPORTED_ROW_WIDTHS = (16, 24, 32)
SUPPORTED_TILE_SIZES = (16, 32)        # the render stream kernel's
LIST_TILE_SIZE = 16                    # every other kernel's
MAX_RECT_COORD = 255                   # cell rows pack a rect as x + 256 y

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
COMMON_HEADER = CSRC / "composite_common.cuh"
BUILD_DIR = _PKG / "_build"
# one library per kernel source; the C entry point is "ls4d_" + name
KERNELS = ("composite_stream", "composite_tiles", "composite_tiles_backward",
           "composite_stream_chunks", "composite_stream_chunks_backward",
           "composite_cells")
# --fmad=false keeps a*b+c as two roundings, as PyTorch's separate
# elementwise ops do, so the kernels' power sign tests (power > 0 kills a
# Gaussian) agree with the plain versions' bit for bit. -Xptxas -v prints
# each kernel's registers, shared memory and spills (kept in the build log).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
_C_ARGS = {   # pointers, then ints; the stream pointer is appended
    "composite_stream": (4, 7),
    "composite_tiles": (4, 5),
    "composite_tiles_backward": (5, 5),
    "composite_stream_chunks": (4, 4),
    "composite_stream_chunks_backward": (5, 4),
    "composite_cells": (4, 5),
}


def kernel_source(name: str) -> Path:
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; expected one of {KERNELS}")
    return CSRC / f"{name}.cu"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the library of kernel `name` is cached: keyed by a hash of its
    source, the shared header and the flags."""
    digest = hashlib.sha256(
        kernel_source(name).read_bytes() + COMMON_HEADER.read_bytes()
        + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def build_libraries(names=KERNELS) -> Dict[str, Path]:
    """Compile the named kernel sources into shared libraries, one nvcc per
    source, all started together; cached ones are not rebuilt. Returns their
    paths. The compiler's output (the ptxas figures) is kept beside each
    library as `<library>.log`."""
    libs = {name: library_path(name) for name in names}
    procs = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(kernel_source(name))]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
            continue
        libs[name].with_suffix(".log").write_text(out)
        os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def ptxas_report(name: str) -> str:
    """The compiler's output from the build of kernel `name`: registers,
    shared memory and spills of every instantiation."""
    return build_libraries((name,))[name].with_suffix(".log").read_text()


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (first use) and load the library of kernel `name`."""
    lib = ctypes.CDLL(str(build_libraries((name,))[name]))
    n_ptr, n_int = _C_ARGS[name]
    fn = getattr(lib, "ls4d_" + name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.ls4d_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ls4d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_seconds(names=KERNELS) -> float:
    """Time to build (or find) and load the named kernels' libraries."""
    t0 = time.perf_counter()
    build_libraries(names)
    for name in names:
        load_library(name)
    return time.perf_counter() - t0


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on `device`'s current stream; raises if the
    launch is refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        lib = load_library(name)
        err = getattr(lib, "ls4d_" + name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.ls4d_cuda_error_string(err).decode())


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
    _check_aligned(rows=rows)
    pw = rows.shape[1]
    out = torch.empty((pw - HDR + 1, height, width), dtype=torch.float32,
                      device=rows.device)
    _launch("composite_stream", rows.device, rows.data_ptr(),
            starts.data_ptr(), bg.data_ptr(), out.data_ptr(),
            tiles_x * tiles_y, tiles_x, tile_size, height, width, pw,
            int(hard_cutoffs))
    composite_stream.launches += 1
    return out


composite_stream.launches = 0


def _check_on_device(device, **tensors):
    for name, t in tensors.items():
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")


def _check_aligned(**tensors):
    """The kernels move rows 16 bytes at a time."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


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
    _check_on_device(rows.device, rows=rows, starts=starts, bg=bg)


def _check_list_args(rows, counts, tile_size):
    if rows.dtype != torch.float32 or rows.dim() != 3:
        raise ValueError(f"rows must be [T, K, PW] float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if rows.shape[2] not in SUPPORTED_ROW_WIDTHS:
        raise ValueError(f"row width {rows.shape[2]} not in "
                         f"{SUPPORTED_ROW_WIDTHS}")
    if tile_size != LIST_TILE_SIZE:
        raise ValueError(f"tile size {tile_size}: the tile-list kernels "
                         f"take {LIST_TILE_SIZE}")
    if counts.dtype != torch.int32 or counts.shape != (rows.shape[0],):
        raise ValueError(f"counts must be [{rows.shape[0]}] int32, got "
                         f"{tuple(counts.shape)} {counts.dtype}")
    _check_on_device(rows.device, rows=rows, counts=counts)


def composite_tiles(rows: torch.Tensor, counts: torch.Tensor,
                    bg: torch.Tensor, *, tiles_x: int, tile_size: int = 16,
                    hard_cutoffs: bool = True) -> torch.Tensor:
    """rows [T, K, PW] f32 per-tile lists, front to back and front-compacted;
    counts [T] int32 valid rows per tile; bg [3] -> accum [T, PW - 8 + 1, px]
    (features with bg * T added to rgb, then the alpha sum). The tile origin
    comes from the tile id."""
    if rows.device.type == "cpu":
        return composite_tiles_plain(rows, counts, bg, tiles_x=tiles_x,
                                     tile_size=tile_size,
                                     hard_cutoffs=hard_cutoffs)
    if rows.device.type != "cuda":
        raise ValueError(f"composite_tiles: no kernel for {rows.device}")
    _check_list_args(rows, counts, tile_size)
    _check_bg(bg, rows.device)
    _check_aligned(rows=rows)
    num_tiles, k, pw = rows.shape
    out = torch.empty((num_tiles, pw - HDR + 1, tile_size * tile_size),
                      dtype=torch.float32, device=rows.device)
    _launch("composite_tiles", rows.device, rows.data_ptr(),
            counts.data_ptr(), bg.data_ptr(), out.data_ptr(), num_tiles, k,
            tiles_x, pw, int(hard_cutoffs))
    composite_tiles.launches += 1
    return out


composite_tiles.launches = 0


def composite_tiles_backward(rows: torch.Tensor, counts: torch.Tensor,
                             g_out: torch.Tensor, total: torch.Tensor, *,
                             tiles_x: int, tile_size: int = 16,
                             hard_cutoffs: bool = True) -> torch.Tensor:
    """rows, counts as `composite_tiles`; g_out [T, PW - 8 + 1, px] the
    cotangent of accum; total [T, px] = sum_c accum * g_out -> d_rows
    [T, K, PW], one gradient row per (tile, slot): [dmx, dmy, dc0, dc1, dc2,
    d_op, 0, 0, d_feat ...], zero beyond the walked slots. The caller
    scatter-adds the rows to the Gaussians."""
    if rows.device.type == "cpu":
        return composite_tiles_backward_plain(
            rows, counts, g_out, total, tiles_x=tiles_x, tile_size=tile_size,
            hard_cutoffs=hard_cutoffs)
    if rows.device.type != "cuda":
        raise ValueError(
            f"composite_tiles_backward: no kernel for {rows.device}")
    _check_list_args(rows, counts, tile_size)
    num_tiles, k, pw = rows.shape
    px = tile_size * tile_size
    for name, t, shape in (("g_out", g_out, (num_tiles, pw - HDR + 1, px)),
                           ("total", total, (num_tiles, px))):
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"{name} must be {list(shape)} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    _check_on_device(rows.device, g_out=g_out, total=total)
    _check_aligned(rows=rows)
    d_rows = torch.empty_like(rows)
    _launch("composite_tiles_backward", rows.device, rows.data_ptr(),
            counts.data_ptr(), g_out.data_ptr(), total.data_ptr(),
            d_rows.data_ptr(), num_tiles, k, tiles_x, pw, int(hard_cutoffs))
    composite_tiles_backward.launches += 1
    return d_rows


composite_tiles_backward.launches = 0


def _check_segment_args(rows, starts, tile_size, what="starts"):
    """rows [B, PW] float32 and bounds [n + 1] int32 of a 16-px kernel;
    returns n."""
    if rows.dtype != torch.float32 or rows.dim() != 2:
        raise ValueError(f"rows must be [B, PW] float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if rows.shape[1] not in SUPPORTED_ROW_WIDTHS:
        raise ValueError(f"row width {rows.shape[1]} not in "
                         f"{SUPPORTED_ROW_WIDTHS}")
    if tile_size != LIST_TILE_SIZE:
        raise ValueError(f"tile size {tile_size}: this kernel takes "
                         f"{LIST_TILE_SIZE}")
    if starts.dtype != torch.int32 or starts.dim() != 1 or not starts.numel():
        raise ValueError(f"{what} must be [n + 1] int32, got "
                         f"{tuple(starts.shape)} {starts.dtype}")
    _check_on_device(rows.device, rows=rows, **{what: starts})
    return starts.numel() - 1


def _check_bg(bg, device):
    if bg.dtype != torch.float32 or bg.shape != (3,):
        raise ValueError(f"bg must be [3] float32, got {tuple(bg.shape)}")
    _check_on_device(device, bg=bg)


def composite_stream_chunks(rows: torch.Tensor, starts: torch.Tensor,
                            bg: torch.Tensor, *, tiles_x: int,
                            tile_size: int = 16,
                            hard_cutoffs: bool = True) -> torch.Tensor:
    """rows [B, PW] f32 in (tile, depth) order, starts [T+1] int32 segment
    bounds, bg [3] -> accum [T, PW - 8 + 1, px] as `composite_tiles`. Tile
    t blends rows[starts[t]:starts[t+1]]; an empty segment gives bg."""
    if rows.device.type == "cpu":
        return composite_stream_chunks_plain(
            rows, starts, bg, tiles_x=tiles_x, tile_size=tile_size,
            hard_cutoffs=hard_cutoffs)
    if rows.device.type != "cuda":
        raise ValueError(
            f"composite_stream_chunks: no kernel for {rows.device}")
    num_tiles = _check_segment_args(rows, starts, tile_size)
    _check_bg(bg, rows.device)
    _check_aligned(rows=rows)
    pw = rows.shape[1]
    out = torch.empty((num_tiles, pw - HDR + 1, tile_size * tile_size),
                      dtype=torch.float32, device=rows.device)
    _launch("composite_stream_chunks", rows.device, rows.data_ptr(),
            starts.data_ptr(), bg.data_ptr(), out.data_ptr(), num_tiles,
            tiles_x, pw, int(hard_cutoffs))
    composite_stream_chunks.launches += 1
    return out


composite_stream_chunks.launches = 0


def composite_stream_chunks_backward(rows: torch.Tensor,
                                     starts: torch.Tensor,
                                     g_out: torch.Tensor,
                                     total: torch.Tensor, *, tiles_x: int,
                                     tile_size: int = 16,
                                     hard_cutoffs: bool = True
                                     ) -> torch.Tensor:
    """rows, starts as `composite_stream_chunks` with starts[0] = 0 and
    starts[T] = B (every slot belongs to a tile); g_out [T, PW - 8 + 1, px]
    the cotangent of accum; total [T, px] = sum_c accum * g_out -> d_rows
    [B, PW], one gradient row per slot: [dmx, dmy, dc0, dc1, dc2, d_op, 0, 0,
    d_feat ...]. The caller scatter-adds the rows to the Gaussians."""
    if rows.device.type == "cpu":
        return composite_stream_chunks_backward_plain(
            rows, starts, g_out, total, tiles_x=tiles_x, tile_size=tile_size,
            hard_cutoffs=hard_cutoffs)
    if rows.device.type != "cuda":
        raise ValueError(
            f"composite_stream_chunks_backward: no kernel for {rows.device}")
    num_tiles = _check_segment_args(rows, starts, tile_size)
    pw = rows.shape[1]
    px = tile_size * tile_size
    for name, t, shape in (("g_out", g_out, (num_tiles, pw - HDR + 1, px)),
                           ("total", total, (num_tiles, px))):
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"{name} must be {list(shape)} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    _check_on_device(rows.device, g_out=g_out, total=total)
    _check_aligned(rows=rows)
    d_rows = torch.empty_like(rows)
    _launch("composite_stream_chunks_backward", rows.device, rows.data_ptr(),
            starts.data_ptr(), g_out.data_ptr(), total.data_ptr(),
            d_rows.data_ptr(), num_tiles, tiles_x, pw, int(hard_cutoffs))
    composite_stream_chunks_backward.launches += 1
    return d_rows


composite_stream_chunks_backward.launches = 0


def composite_cells(rows: torch.Tensor, cell_starts: torch.Tensor,
                    bg: torch.Tensor, *, cells_x: int, cell: int = 8,
                    tile_size: int = 16,
                    hard_cutoffs: bool = True) -> torch.Tensor:
    """rows [M, PW] f32 in (cell, depth) order with the tile rect in columns
    6 and 7 (min_x + 256 min_y, max_x + 256 max_y; max exclusive),
    cell_starts [n_cells + 1] int32, bg [3] -> [n_cells, cell * cell,
    PW - 8 + 1, px]: local tile ly * cell + lx of cell c blends the rows of
    rows[cell_starts[c]:cell_starts[c+1]] whose rect covers it."""
    if rows.device.type == "cpu":
        return composite_cells_plain(
            rows, cell_starts, bg, cells_x=cells_x, cell=cell,
            tile_size=tile_size, hard_cutoffs=hard_cutoffs)
    if rows.device.type != "cuda":
        raise ValueError(f"composite_cells: no kernel for {rows.device}")
    n_cells = _check_segment_args(rows, cell_starts, tile_size,
                                  what="cell_starts")
    _check_bg(bg, rows.device)
    _check_aligned(rows=rows)
    if cell < 1 or cells_x < 1:
        raise ValueError(f"cell {cell} and cells_x {cells_x} must be >= 1")
    pw = rows.shape[1]
    out = torch.empty((n_cells, cell * cell, pw - HDR + 1,
                       tile_size * tile_size), dtype=torch.float32,
                      device=rows.device)
    _launch("composite_cells", rows.device, rows.data_ptr(),
            cell_starts.data_ptr(), bg.data_ptr(), out.data_ptr(), n_cells,
            cells_x, cell, pw, int(hard_cutoffs))
    composite_cells.launches += 1
    return out


composite_cells.launches = 0


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding: the float64 product of two
    float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


class _TileGrid:
    """Tile origins [T, 1] and the tile-local pixel basis [px] of the
    tiles at (tx[t], ty[t]) of the tile grid; with `side`, only the window
    of side x side pixels whose first pixel is tile-local (x0, y0)."""

    def __init__(self, tx: torch.Tensor, ty: torch.Tensor, ts: int,
                 side: Optional[int] = None, x0: int = 0, y0: int = 0):
        dev = tx.device
        side = side or ts
        self.ox = (tx * ts).float()[:, None]
        self.oy = (ty * ts).float()[:, None]
        self.lx = (torch.arange(side, device=dev) + x0).repeat(side).float()
        self.ly = (torch.arange(side, device=dev) + y0).repeat_interleave(
            side).float()
        self.xx, self.yy, self.xy = (self.lx * self.lx, self.ly * self.ly,
                                     self.lx * self.ly)

    @classmethod
    def regular(cls, num_tiles: int, tiles_x: int, ts: int, dev):
        """The first `num_tiles` tiles of a grid `tiles_x` wide, row-major."""
        tile = torch.arange(num_tiles, device=dev)
        return cls(tile % tiles_x, tile // tiles_x, ts)

    def alpha(self, r: torch.Tensor, hard_cutoffs: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One row per tile, r [T, PW] -> (alpha_raw, alpha, skip), each
        [T, px]: the kernels' power chain and cutoff rule."""
        mx = r[:, 0:1] - self.ox
        my = r[:, 1:2] - self.oy
        c0, c1, c2, ln_op = r[:, 2:3], r[:, 3:4], r[:, 4:5], r[:, 5:6]
        k0 = (-0.5 * _fma(c0 * mx, mx, c2 * my * my).double()
              - (c1 * mx * my).double()).float()
        k1 = _fma(c1, my, c0 * mx)
        k2 = _fma(c2, my, c1 * mx)
        power = k0
        for coef, basis in ((k1, self.lx), (k2, self.ly),
                            (-0.5 * c0, self.xx), (-0.5 * c2, self.yy),
                            (-c1, self.xy)):
            power = _fma(coef, basis, power)
        alpha_raw = torch.exp(power + ln_op)
        alpha = torch.clamp(alpha_raw, max=MAX_ALPHA)
        skip = power > 0.0
        if hard_cutoffs:
            skip = skip | (alpha < ALPHA_MIN)
        return alpha_raw, alpha, skip


def _blend_plain(row_at, kmax: int, grid: _TileGrid, c_feat: int,
                 bg: torch.Tensor, hard_cutoffs: bool,
                 stats: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential front-to-back blend of every tile's k-th Gaussian at step
    k, for all tiles and pixels at once. `row_at(k)` gives (r [T, PW], valid
    [T, 1]). Returns (acc [C, T, px] with bg * T added to rgb, asum [T, px]).
    With a `stats` dict, stats["pair_pixels"] becomes the number of
    (Gaussian, pixel) pairs evaluated: each pixel counts the Gaussians of
    its list up to and including the one it stops at; and
    stats["live_pair_pixels"] the number of those that are blended (not
    skipped by power > 0 or alpha < 1/255, and not the pair a pixel stops
    at). That is the work these inputs need, whatever the batching of a
    kernel: an evaluated pair costs its alpha, only a live one the blend.
    """
    num_tiles, px = grid.ox.shape[0], grid.lx.shape[0]
    dev = grid.ox.device
    T = torch.ones((num_tiles, px), device=dev)
    acc = torch.zeros((c_feat, num_tiles, px), device=dev)
    asum = torch.zeros_like(T)
    done = torch.zeros_like(T, dtype=torch.bool)
    evaluated = torch.zeros((), dtype=torch.int64, device=dev)
    blended = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(kmax):
        r, valid = row_at(k)
        if stats is not None:
            evaluated += (valid & ~done).sum()
        _, alpha, skip = grid.alpha(r, hard_cutoffs)
        test_T = T * (1.0 - alpha)
        live = valid & ~done & ~skip
        if hard_cutoffs:
            stop = live & (test_T < T_EPS)
            done = done | stop
            live = live & ~stop
        if stats is not None:
            blended += live.sum()
        w = alpha * T
        acc = torch.where(live, acc + r[:, HDR:].T[:, :, None] * w, acc)
        asum = torch.where(live, asum + w, asum)
        T = torch.where(live, test_T, T)
    acc[:3] = acc[:3] + bg[:, None, None] * T
    if stats is not None:
        stats["pair_pixels"] = int(evaluated)
        stats["live_pair_pixels"] = int(blended)
    return acc, asum


def _segment_walk(rows: torch.Tensor, starts: torch.Tensor):
    """The `row_at(k)` callback and step count of `_blend_plain` for ragged
    segments: tile t's k-th row is rows[starts[t] + k]. -> (row_at, kmax,
    seg_start [T], seg_len [T])."""
    starts = starts.long()
    seg_start = starts[:-1]
    seg_len = starts[1:] - seg_start
    kmax = int(seg_len.max()) if seg_len.numel() else 0
    last = max(rows.shape[0] - 1, 0)

    def row_at(k):
        return (rows[torch.clamp(seg_start + k, max=last)],
                (k < seg_len)[:, None])

    return row_at, kmax, seg_start, seg_len


def _blend_segments(rows: torch.Tensor, starts: torch.Tensor,
                    grid: _TileGrid, bg: torch.Tensor, hard_cutoffs: bool,
                    stats: Optional[dict]) -> torch.Tensor:
    """Every tile of `grid` blends its segment rows[starts[t]:starts[t+1]]
    -> accum [T, C + 1, px] (`stats`: see `_blend_plain`)."""
    row_at, kmax, _, _ = _segment_walk(rows, starts)
    acc, asum = _blend_plain(row_at, kmax, grid, rows.shape[1] - HDR, bg,
                             hard_cutoffs, stats)
    return torch.cat([acc, asum[None]], dim=0).permute(1, 0, 2).contiguous()


def composite_stream_chunks_plain(rows: torch.Tensor, starts: torch.Tensor,
                                  bg: torch.Tensor, *, tiles_x: int,
                                  tile_size: int = 16,
                                  hard_cutoffs: bool = True,
                                  stats: Optional[dict] = None
                                  ) -> torch.Tensor:
    """Plain PyTorch version of the stream-layout training forward
    (`stats`: see `_blend_plain`)."""
    grid = _TileGrid.regular(starts.numel() - 1, tiles_x, tile_size,
                             rows.device)
    return _blend_segments(rows, starts, grid, bg, hard_cutoffs, stats)


def composite_stream_plain(rows: torch.Tensor, starts: torch.Tensor,
                           bg: torch.Tensor, *, tiles_x: int, tiles_y: int,
                           tile_size: int, height: int, width: int,
                           hard_cutoffs: bool = True,
                           stats: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch version of the stream kernel (`stats`: see
    `_blend_plain`): the segments' blend, stitched to the cropped image."""
    ts = tile_size
    accum = composite_stream_chunks_plain(
        rows, starts, bg, tiles_x=tiles_x, tile_size=ts,
        hard_cutoffs=hard_cutoffs, stats=stats)          # [T, C+1, px]
    c_out = accum.shape[1]
    img = accum.reshape(tiles_y, tiles_x, c_out, ts, ts)
    img = img.permute(2, 0, 3, 1, 4).reshape(c_out, tiles_y * ts,
                                             tiles_x * ts)
    return img[:, :height, :width].contiguous()


QUAD = 16                      # the forward walk's block: 16x16 pixels
LN_ALPHA_MIN = -5.5412635      # ln(1/255)
COVER_MARGIN_ABS = 1e-2
COVER_MARGIN_REL = 4e-6


def _rect_cover(rows: torch.Tensor, ox, oy, x0, y0) -> torch.Tensor:
    """`quadrant_covered` of csrc/composite_common.cuh in plain PyTorch: may
    a pixel of the 16x16 rect whose first pixel is (x0, y0), in the tile at
    (ox, oy), blend a row under hard cutoffs? rows [M, PW]; the origins are
    tensors that broadcast against [M] -> keep, of the broadcast shape.

    A row is dropped only if the least value over the rect of the conic
    quadratic q (power = -q / 2; on an edge of the rect unless the centre
    is inside) leaves power + ln_op below ln(1/255) by more than a margin,
    COVER_MARGIN_ABS plus COVER_MARGIN_REL times the magnitude of the terms
    that the blend's coefficient form sums the power from (its ~12
    roundings, 6e-8 each, are relative to that). A conic that is not
    positive definite, or not a number, is kept."""
    cx, cy, a, b, c, ln_op = (rows[:, i] for i in range(6))
    span = float(2 * QUAD)
    dx = (cx - ox).abs() + span
    dy = (cy - oy).abs() + span
    mag = 0.5 * (a * dx * dx + c * dy * dy) + b.abs() * dx * dy
    limit = 2.0 * (ln_op - LN_ALPHA_MIN
                   + (COVER_MARGIN_ABS + COVER_MARGIN_REL * mag))
    definite = (a > 0) & (c > 0) & (a * c > b * b)

    def edge_min(a, b, c, d, lo, hi, centre):
        at = centre - b * d / c
        e = torch.minimum(torch.maximum(at, lo), hi) - centre
        return a * d * d + 2.0 * b * d * e + c * e * e

    x1, y1 = x0 + (QUAD - 1.0), y0 + (QUAD - 1.0)
    least = torch.minimum(
        torch.minimum(edge_min(a, b, c, x0 - cx, y0, y1, cy),
                      edge_min(a, b, c, x1 - cx, y0, y1, cy)),
        torch.minimum(edge_min(c, b, a, y0 - cy, x0, x1, cx),
                      edge_min(c, b, a, y1 - cy, x0, x1, cx)))
    inside = (cx >= x0) & (cx <= x1) & (cy >= y0) & (cy <= y1)
    least = torch.where(inside, torch.zeros_like(least), least)
    return ~(definite & (least > limit))


def quadrant_cover_plain(rows: torch.Tensor, ox: torch.Tensor,
                         oy: torch.Tensor, hard_cutoffs: bool = True
                         ) -> torch.Tensor:
    """The stream kernel's quadrant test in plain PyTorch: rows [M, PW] of
    32-px tiles with origins ox, oy [M] -> keep [M, 4] bool, quadrant
    q = 2 qy + qx being the 16x16 pixels from tile-local (16 qx, 16 qy).
    A row is dropped for a quadrant only if every pixel of the quadrant
    would skip it under hard cutoffs (alpha < 1/255; see `_rect_cover`);
    without hard cutoffs every pixel blends every row, so all are kept."""
    m = rows.shape[0]
    keep = torch.ones((m, 4), dtype=torch.bool, device=rows.device)
    if not hard_cutoffs:
        return keep
    ox = torch.as_tensor(ox, dtype=torch.float32, device=rows.device)
    oy = torch.as_tensor(oy, dtype=torch.float32, device=rows.device)
    for q in range(4):
        keep[:, q] = _rect_cover(rows, ox, oy, ox + float(QUAD * (q % 2)),
                                 oy + float(QUAD * (q // 2)))
    return keep


def tile_cover_plain(rows: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                     hard_cutoffs: bool = True) -> torch.Tensor:
    """The tile-list kernel's tile test in plain PyTorch:
    `_rect_cover` with the 16x16 tile as the rect. rows [M, PW], tile
    origins ox, oy broadcasting against [M] -> keep bool; all kept without
    hard cutoffs."""
    ox = torch.as_tensor(ox, dtype=torch.float32, device=rows.device)
    oy = torch.as_tensor(oy, dtype=torch.float32, device=rows.device)
    if not hard_cutoffs:
        shape = torch.broadcast_shapes(ox.shape, oy.shape, rows.shape[:1])
        return torch.ones(shape, dtype=torch.bool, device=rows.device)
    return _rect_cover(rows, ox, oy, ox, oy)


def rect_decode_plain(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A cell row's packed tile corner v = x + 256 y -> (x, y) as the cell
    kernel decodes it, and its plain version with it: y = floor(v / 256) by
    a multiply with 1/256 and x = v - 256 y, both exact for the integers up
    to 65535 that the rows hold (no fmod, no division)."""
    y = torch.floor(v * (1.0 / 256.0))
    return v - 256.0 * y, y


def composite_stream_quadrants_plain(
        rows: torch.Tensor, starts: torch.Tensor, bg: torch.Tensor, *,
        tiles_x: int, tiles_y: int, tile_size: int, height: int, width: int,
        hard_cutoffs: bool = True, stats: Optional[dict] = None
        ) -> torch.Tensor:
    """The stream kernel's scheme at 32-px tiles in plain PyTorch: every
    16x16 quadrant of a tile blends, in the segment's order, the rows of the
    tile's segment that `quadrant_cover_plain` keeps for it. The image is
    `composite_stream_plain`'s; `stats` (see `_blend_plain`) counts the
    pairs this scheme evaluates, and stats["staged_rows"] the (row,
    quadrant) pairs kept of the stats["quadrant_tests"] tested."""
    if tile_size != 2 * QUAD:
        raise ValueError(f"tile size {tile_size}: the quadrants are those of "
                         f"{2 * QUAD}-px tiles")
    dev = rows.device
    num_tiles = tiles_x * tiles_y
    seg_len = (starts[1:] - starts[:-1]).long()
    tile = torch.repeat_interleave(torch.arange(num_tiles, device=dev),
                                   seg_len)
    tx, ty = tile % tiles_x, tile // tiles_x
    keep = quadrant_cover_plain(rows[:int(starts[-1])],
                                (tx * tile_size).float(),
                                (ty * tile_size).float(), hard_cutoffs)
    every = torch.arange(num_tiles, device=dev)
    c_out = rows.shape[1] - HDR + 1
    img = torch.empty((c_out, tiles_y, 2, QUAD, tiles_x, 2, QUAD),
                      device=dev)
    totals = dict(pair_pixels=0, live_pair_pixels=0)
    for q in range(4):
        pick = keep[:, q].nonzero()[:, 0]            # segment order is kept
        q_starts = torch.zeros(num_tiles + 1, dtype=torch.int64, device=dev)
        q_starts[1:] = torch.cumsum(
            torch.bincount(tile[pick], minlength=num_tiles), 0)
        grid = _TileGrid(every % tiles_x, every // tiles_x, tile_size,
                         side=QUAD, x0=QUAD * (q % 2), y0=QUAD * (q // 2))
        q_stats = {} if stats is not None else None
        accum = _blend_segments(rows[pick], q_starts, grid, bg, hard_cutoffs,
                                q_stats)             # [T, C+1, 256]
        img[:, :, q // 2, :, :, q % 2, :] = accum.reshape(
            tiles_y, tiles_x, c_out, QUAD, QUAD).permute(2, 0, 3, 1, 4)
        if stats is not None:
            for k in totals:
                totals[k] += q_stats[k]
    if stats is not None:
        stats.update(totals, staged_rows=int(keep.sum()),
                     quadrant_tests=keep.numel())
    img = img.reshape(c_out, tiles_y * tile_size, tiles_x * tile_size)
    return img[:, :height, :width].contiguous()


def warp_transpose_sum_plain(values: torch.Tensor) -> torch.Tensor:
    """The backward kernels' transposed warp reduction
    (`warp_transpose_sum` in csrc/composite_common.cuh) with tensor
    indexing: values [32, V], lane l's V terms (V <= 32) -> [32]: lane v
    ends with the sum over the 32 lanes of term v. The terms are padded to
    16 or 32; at each shuffle distance d = 16 (for 32 terms), 8, 4, 2, 1 a
    lane keeps the half of its terms that bit d of its lane number names,
    hands the other half to lane l ^ d and adds what that lane hands over;
    16 terms leave the two half-warps to be added last."""
    lanes, v = values.shape
    if lanes != 32 or v > 32:
        raise ValueError(f"values must be [32, V <= 32], got "
                         f"{tuple(values.shape)}")
    n = 16 if v <= 16 else 32
    regs = torch.zeros((32, n), dtype=values.dtype, device=values.device)
    regs[:, :v] = values
    lane = torch.arange(32, device=values.device)
    half = n // 2
    while half >= 1:
        upper = ((lane & half) != 0)[:, None]
        low, high = regs[:, :half], regs[:, half:2 * half]
        keep = torch.where(upper, high, low)
        send = torch.where(upper, low, high)
        regs = keep + send[lane ^ half]              # __shfl_xor_sync
        half //= 2
    out = regs[:, 0]
    if n == 16:
        out = out + out[lane ^ 16]
    return out


def composite_cells_plain(rows: torch.Tensor, cell_starts: torch.Tensor,
                          bg: torch.Tensor, *, cells_x: int, cell: int = 8,
                          tile_size: int = 16, hard_cutoffs: bool = True,
                          cull: bool = False,
                          stats: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch version of the cell-list kernel: for every tile the
    candidates of its cell whose rect covers it, in the list's order, become
    that tile's segment, and the segments are blended as the stream's are.
    With `cull` (and hard cutoffs) a covered row is also dropped where the
    tile test (`tile_cover_plain`) finds that no pixel of the tile can blend
    it: the same image bit for bit from fewer pairs, the count the kernel's
    bound charges (the kernel itself tests the rect only). `stats` (see
    `_blend_plain`) counts the rows that reach the blend only;
    stats["rect_tests"] becomes the number of (tile, candidate) pairs,
    stats["covered_rows"] the pairs whose rect covers the tile and
    stats["kept_rows"] those the blend sees."""
    dev = rows.device
    n_cells = cell_starts.numel() - 1
    bounds = cell_starts.tolist()
    lt = torch.arange(cell * cell, device=dev)
    txs, tys, picks, counts = [], [], [], []
    n_covered = 0
    for ci in range(n_cells):
        cand = rows[bounds[ci]:bounds[ci + 1]]
        tx = (ci % cells_x) * cell + lt % cell                  # [cell^2]
        ty = (ci // cells_x) * cell + lt // cell
        min_x, min_y = rect_decode_plain(cand[:, 6])
        max_x, max_y = rect_decode_plain(cand[:, 7])
        covered = ((min_x <= tx[:, None]) & (tx[:, None] < max_x)
                   & (min_y <= ty[:, None]) & (ty[:, None] < max_y))
        n_covered += int(covered.sum())
        if cull and hard_cutoffs:
            covered &= tile_cover_plain(cand, (tx * tile_size)[:, None],
                                        (ty * tile_size)[:, None])
        picks.append(bounds[ci] + covered.nonzero()[:, 1])  # (tile, depth)
        counts.append(covered.sum(1))
        txs.append(tx)
        tys.append(ty)
    starts = torch.zeros(n_cells * cell * cell + 1, dtype=torch.int64,
                         device=dev)
    starts[1:] = torch.cumsum(torch.cat(counts), 0)
    out = _blend_segments(
        rows[torch.cat(picks)], starts,
        _TileGrid(torch.cat(txs), torch.cat(tys), tile_size), bg,
        hard_cutoffs, stats)
    if stats is not None:
        stats.update(rect_tests=rows.shape[0] * cell * cell,
                     covered_rows=n_covered, kept_rows=int(starts[-1]))
    return out.reshape(n_cells, cell * cell, out.shape[1], out.shape[2])


def composite_tiles_plain(rows: torch.Tensor, counts: torch.Tensor,
                          bg: torch.Tensor, *, tiles_x: int,
                          tile_size: int = 16,
                          hard_cutoffs: bool = True, cull: bool = False,
                          stats: Optional[dict] = None) -> torch.Tensor:
    """Plain PyTorch version of the tile-list forward kernel (`stats`: see
    `_blend_plain`). With `cull` (and hard cutoffs) a row of a tile's list
    is dropped where the tile test (`tile_cover_plain`) finds that no pixel
    of the tile can blend it: the kernel's scheme, whose output is the same
    bit for bit; `stats` then counts the pairs that scheme evaluates and
    stats["kept_rows"] the rows it keeps."""
    num_tiles, k_cap, pw = rows.shape
    kmax = min(int(counts.max()), k_cap) if num_tiles else 0
    grid = _TileGrid.regular(num_tiles, tiles_x, tile_size, rows.device)
    kept = torch.zeros((), dtype=torch.int64, device=rows.device)

    def row_at(k):
        nonlocal kept
        r, valid = rows[:, k], (k < counts)[:, None]
        if cull and hard_cutoffs:
            valid = valid & tile_cover_plain(r, grid.ox[:, 0],
                                             grid.oy[:, 0])[:, None]
        kept = kept + valid.sum()
        return r, valid

    acc, asum = _blend_plain(row_at, kmax, grid, pw - HDR, bg, hard_cutoffs,
                             stats)
    if stats is not None:
        stats["kept_rows"] = int(kept)
    return torch.cat([acc, asum[None]], dim=0).permute(1, 0, 2).contiguous()


def _backward_plain(row_at, kmax: int, grid: _TileGrid, g_out: torch.Tensor,
                    total: torch.Tensor, hard_cutoffs: bool):
    """The backward's front-to-back re-walk, one step per position k of
    every tile's rows (`row_at` as in `_blend_plain`): yields (k, valid
    [T], d [T, PW]), the gradient row of each tile's k-th row (zero where
    the tile has no such row)."""
    c_feat = g_out.shape[1] - 1
    basis = torch.stack([torch.ones_like(grid.lx), grid.lx, grid.ly, grid.xx,
                         grid.yy, grid.xy])              # [6, px]
    g_feat = g_out[:, :c_feat]                           # [T, C, px]
    g_alpha = g_out[:, c_feat]                           # [T, px]
    T = torch.ones_like(total)
    prefix = torch.zeros_like(total)
    done = torch.zeros_like(total, dtype=torch.bool)
    for k in range(kmax):
        r, valid = row_at(k)
        alpha_raw, alpha, skip = grid.alpha(r, hard_cutoffs)
        test_T = T * (1.0 - alpha)
        live = valid & ~done & ~skip
        if hard_cutoffs:
            stop = live & (test_T < T_EPS)
            done = done | stop
            live = live & ~stop
        w = torch.where(live, alpha * T, 0.0)
        phi = (r[:, HDR:, None] * g_feat).sum(1) + g_alpha
        prefix = prefix + w * phi
        d_alpha = torch.where(
            live & (alpha_raw < MAX_ALPHA),
            T * phi - (total - prefix) / torch.clamp(1.0 - alpha, min=1e-6),
            0.0)
        da = d_alpha * alpha                             # dL/dpower [T, px]
        d = (da[:, None, :] * basis).sum(-1)             # [T, 6]
        mx = r[:, 0] - grid.ox[:, 0]
        my = r[:, 1] - grid.oy[:, 0]
        c0, c1, c2, ln_op = r[:, 2], r[:, 3], r[:, 4], r[:, 5]
        out = torch.zeros_like(r)
        out[:, 0] = ((-c0 * mx - c1 * my) * d[:, 0] + c0 * d[:, 1]
                     + c1 * d[:, 2])
        out[:, 1] = ((-c2 * my - c1 * mx) * d[:, 0] + c1 * d[:, 1]
                     + c2 * d[:, 2])
        out[:, 2] = -0.5 * mx * mx * d[:, 0] + mx * d[:, 1] - 0.5 * d[:, 3]
        out[:, 3] = (-mx * my * d[:, 0] + my * d[:, 1] + mx * d[:, 2]
                     - d[:, 5])
        out[:, 4] = -0.5 * my * my * d[:, 0] + my * d[:, 2] - 0.5 * d[:, 4]
        # d_op = d_ln_op / op; the padded slots' sentinel ln_op is guarded
        out[:, 5] = torch.where(ln_op > -1e29, d[:, 0] * torch.exp(-ln_op),
                                0.0)
        out[:, HDR:] = (g_feat * w[:, None, :]).sum(-1)
        T = torch.where(live, test_T, T)
        yield k, valid[:, 0], out


def composite_tiles_backward_plain(rows: torch.Tensor, counts: torch.Tensor,
                                   g_out: torch.Tensor, total: torch.Tensor,
                                   *, tiles_x: int, tile_size: int = 16,
                                   hard_cutoffs: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the tile-list backward kernel: the same
    front-to-back re-walk, one list slot per step."""
    num_tiles, k_cap, _ = rows.shape
    kmax = min(int(counts.max()), k_cap) if num_tiles else 0

    def row_at(k):
        return rows[:, k], (k < counts)[:, None]

    d_rows = torch.zeros_like(rows)
    for k, _, d in _backward_plain(
            row_at, kmax,
            _TileGrid.regular(num_tiles, tiles_x, tile_size, rows.device),
            g_out, total, hard_cutoffs):
        d_rows[:, k] = d
    return d_rows


def composite_stream_chunks_backward_plain(
        rows: torch.Tensor, starts: torch.Tensor, g_out: torch.Tensor,
        total: torch.Tensor, *, tiles_x: int, tile_size: int = 16,
        hard_cutoffs: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the stream-layout backward kernel: every
    tile re-walks its segment, one position per step."""
    row_at, kmax, seg_start, _ = _segment_walk(rows, starts)
    grid = _TileGrid.regular(starts.numel() - 1, tiles_x, tile_size,
                             rows.device)
    d_rows = torch.zeros_like(rows)
    for k, valid, d in _backward_plain(row_at, kmax, grid, g_out, total,
                                       hard_cutoffs):
        d_rows[seg_start[valid] + k] = d[valid]
    return d_rows
