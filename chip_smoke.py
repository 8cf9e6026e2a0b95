#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (langsplat4d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare NAME=TREE [--compare ...] [--rounds 3]

Run from the root of a checkout, on a machine with one CUDA GPU and nvcc.
With --compare it checks nothing and only times the six kernels of this
checkout in turns with those of other builds (see `compare_builds`).
Phases, each failing the run on error:
  1. build the six compositor kernels from csrc/ with nvcc, one nvcc per
     source, all started together;
  2. compare the stream kernel with its plain PyTorch version on synthetic
     segments (16- and 32-px tiles, hard cutoffs on and off, empty and long
     segments, image edges that cut through a 16x16 quadrant, and rows that
     are hard on the kernel's quadrant test), max abs error <= 3e-5;
  3. the render path: the bench workload (200k realistic Gaussians at
     1352x1014, the Neu3D-preset deformation at full width with seeded
     random weights, a 60-frame orbit, lang mode, fine-lang) through the
     port's render_set, counting the stream kernel's launches in that run;
  4. per-stage device times of a frame;
  5. frame 0 composited by the kernel vs the plain version, and vs what
     render_set wrote; kernel and plain times at 32- and 16-px tiles. At
     32 px the bound charges the pairs that the quadrant scheme evaluates,
     counted by its plain twin, whose image must be the plain version's;
  6. the ptxas figures (registers, shared memory, spills) of the kernels
     and the blocks an SM holds of each, reckoned from them; a spill in any
     kernel fails;
  7. the tile-list kernels against their plain versions on synthetic lists
     (hard cutoffs on and off, counts of 0, 1, full and ragged, row widths
     16, 24 and 32, 35 tiles): forward <= 3e-5, backward within rtol 2e-3 /
     atol 2e-4;
  8. the training path: the training-step workload (100k realistic
     Gaussians at 960x536, the same deformation, 16-px tiles of capacity
     512, fine-lang, batch 1) through langsplat4d_torch.train.step:
     1 warm-up + 20 train_step calls, counting both kernels' launches;
  9. step 1 recomputed stage by stage with the kernels and with their plain
     versions on the card: the loss, every column of the gradient rows and
     of the packed rows' gradient, and every trained leaf's gradient, each
     held to rtol 2e-3 / atol 2e-4 relative to its own largest entry;
 10. per-stage device times of a step; kernel and plain times of both
     kernels on step 1's rows. The forward's bound charges the pairs that
     the kernel's scheme (the tile test drops rows no pixel of the tile
     blends) evaluates, counted by its plain twin, whose output must be the
     plain version's with the same live pairs;
 11. torch.profiler over five steps: device kernels per step and the
     device's busy share (taken at the end of the run, with phase 15's
     profile, so that no timing is taken with the profiler attached);
 12. the stream-layout training kernels against their plain versions on
     synthetic ragged segments (empty tiles, one row, segments of more than
     1000 rows, hard cutoffs on and off, row widths 16, 24 and 32): forward
     <= 3e-5, backward within rtol 2e-3 / atol 2e-4 of each column's largest
     entry;
 13. the training path on the stream layout: phase 8's workload and steps
     with `stream_train` on in place of the tile lists, counting the
     launches of the stream-layout forward and backward kernels;
 14. its step 1 stage by stage against the plain versions, as phase 9;
 15. its per-stage times, kernel and plain times, both kernels on the
     longest segment alone, the list and stream steps timed in turns on one
     state, and the profile;
 16. `maybe_stream_switch` on the workload's state: it must choose the
     stream layout;
 17. the cell kernel against its plain version on synthetic cells (a cell
     with no candidate, candidates that cover no tile of the cell, hard
     cutoffs on and off) and on adversarial cell rows (splats whose
     alpha = 1/255 contour grazes a tile's edge, centres on tile borders,
     indefinite conics), <= 3e-5;
 18. the cell-list render option: frames 0-9 of the bench workload through
     langsplat4d_torch.render.pipeline.render at 16-px tiles and 8x8-tile
     cells, counting the cell kernel's launches; frame 0 against the stream
     kernel's image (rgb and language 3e-5, depth 3e-4) and, composited
     again from its rows, against the plain version on the whole frame. The
     bound charges the pairs left once the tile test drops the covered rows
     that no pixel of the tile blends, counted by the plain twin of that
     scheme, whose image must be the plain version's with the same live
     pairs.
Prints one JSON line describing the kernels (each with its time beside the
least time the card could take for the same work), the card's name and
power limit, and as the last line {"ok": true, "device": {...}}. Imports
nothing of JAX or of the JAX package.
"""
import argparse
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 3e-5          # the repo's kernel bound (tests/test_pallas_composite.py)
# name -> (source, the TPU kernel body it replaces)
KERNELS = {
    "composite_stream": ("langsplat4d_torch/csrc/composite_stream.cu",
                         "langsplat4d/ops/tile_composite.py:452"),
    "composite_tiles": ("langsplat4d_torch/csrc/composite_tiles.cu",
                        "langsplat4d/ops/tile_composite.py:77"),
    "composite_tiles_backward": (
        "langsplat4d_torch/csrc/composite_tiles_backward.cu",
        "langsplat4d/ops/tile_composite.py:267"),
    "composite_stream_chunks": (
        "langsplat4d_torch/csrc/composite_stream_chunks.cu",
        "langsplat4d/ops/tile_composite.py:679"),
    "composite_stream_chunks_backward": (
        "langsplat4d_torch/csrc/composite_stream_chunks_backward.cu",
        "langsplat4d/ops/tile_composite.py:787"),
    "composite_cells": ("langsplat4d_torch/csrc/composite_cells.cu",
                        "langsplat4d/ops/tile_composite.py:956"),
}
# One Hopper SM: 32-bit registers (handed out to a warp in units of 256, so
# a thread's count rounds up to 8), shared memory (1 KiB of it reserved per
# resident block), resident threads and blocks.
SM_REGISTERS, SM_SHARED_BYTES, SM_THREADS, SM_BLOCKS = 65536, 233472, 2048, 32
BLOCK_THREADS = 256                     # every kernel's block


def kernel_resources(log):
    """{row width: (registers, shared-memory bytes, spilled bytes, blocks of
    BLOCK_THREADS threads that one SM holds at a time)} of one kernel, from
    its build log: ptxas names each instantiation (`...ILi16E...`) before
    its figures."""
    found, pw = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?ILi(\d+)E", line)
        if m:
            pw = int(m.group(1))
            found[pw] = [0, 0, 0]
        if pw is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found[pw][2] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[pw][0] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            found[pw][1] = int(smem.group(1)) if smem else 0
    return {pw: (regs, smem, spill, min(
        SM_REGISTERS // (-(-regs // 8) * 8 * BLOCK_THREADS),
        SM_SHARED_BYTES // (smem + 1024), SM_THREADS // BLOCK_THREADS,
        SM_BLOCKS)) for pw, (regs, smem, spill) in found.items() if regs}
# Published peaks of one H100 SXM at its full 700 W: HBM bytes/s and float32
# operations/s outside the tensor cores (the compositors are float32 vector
# code with one expf per pair).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


ALPHA_OPS = 20   # one evaluated (Gaussian, pixel) pair: the power chain
                 # (5 fma = 10), + ln_op, expf (counted as 8), min


def forward_ops(evaluated, live, c):
    """float32 operations the forward needs for `evaluated` (Gaussian,
    pixel) pairs of which `live` are blended: every evaluated pair its alpha
    (ALPHA_OPS); a live one besides 1 - alpha, T * (1 - alpha), alpha * T,
    the alpha sum (4) and the c feature fmas (2c). A pair skipped by
    power > 0 or alpha < 1/255 needs none of the latter."""
    return evaluated * ALPHA_OPS + live * (4 + 2 * c)


def backward_ops(evaluated, live, c):
    """The backward's: every evaluated pair its alpha; a live one besides
    1 - alpha and T * (1 - alpha) (2), phi (2c + 1), alpha * T, prefix, S,
    d_alpha, da (9), five basis products, the 6 + c sums over pixels (one
    add per pair each) and the c products w * g_c."""
    return evaluated * ALPHA_OPS + live * (2 + (2 * c + 1) + 9 + 5
                                           + (6 + c) + c)


def bound(n_bytes, n_ops):
    """The least time in ms the card could take: the larger of the bytes
    over the memory rate and the operations over the float32 rate. ->
    (ms, "bytes" or "operations", both times as text)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    parts = (f"{n_bytes / 1e6:.1f} MB in {t_bytes:.4f} ms, "
             f"{n_ops / 1e9:.3f} G operations in {t_ops:.4f} ms")
    return ((t_bytes, "bytes", parts) if t_bytes >= t_ops
            else (t_ops, "operations", parts))

# Config().runtime.render_tile_size of the JAX package's config, restated
# because this script imports nothing of that package
RENDER_TILE_SIZE = 32


def synthetic_stream(tiles_x, tiles_y, tile_size, seg_lens, generator,
                     pw=16):
    """A (tile, depth)-ordered row stream on the CPU: seg_lens[t] Gaussians
    per tile with centres around the tile, PSD conics, opacities in
    [0.05, 0.99] (so pixels saturate and stop) and random features.
    Returns (rows [M, pw] f32, starts [T+1] int32)."""
    seg = torch.as_tensor(seg_lens, dtype=torch.int64)
    m = int(seg.sum())
    tile = torch.repeat_interleave(torch.arange(len(seg)), seg)
    ox = (tile % tiles_x).float() * tile_size
    oy = (tile // tiles_x).float() * tile_size

    def u(lo, hi, *shape):
        return torch.rand(*shape, generator=generator) * (hi - lo) + lo
    cx = ox + u(-8.0, tile_size + 8.0, m)
    cy = oy + u(-8.0, tile_size + 8.0, m)
    sa, sb = u(0.5, 6.0, m), u(0.5, 6.0, m)
    th = u(0.0, np.pi, m)
    c, s = torch.cos(th), torch.sin(th)
    cxx = c * c * sa * sa + s * s * sb * sb + 0.3
    cyy = s * s * sa * sa + c * c * sb * sb + 0.3
    cxy = c * s * (sa * sa - sb * sb)
    det = cxx * cyy - cxy * cxy
    rows = torch.zeros(m, pw)
    rows[:, 0], rows[:, 1] = cx, cy
    rows[:, 2], rows[:, 3], rows[:, 4] = cyy / det, -cxy / det, cxx / det
    rows[:, 5] = torch.log(u(0.05, 0.99, m))
    rows[:, 8:11] = torch.rand(m, 3, generator=generator)
    rows[:, 11:pw - 2] = torch.randn(m, pw - 13, generator=generator)
    rows[:, pw - 2] = torch.sort(u(1.0, 10.0, m)).values
    starts = torch.zeros(len(seg) + 1, dtype=torch.int32)
    starts[1:] = torch.cumsum(seg, 0).to(torch.int32)
    return rows, starts


def adversarial_stream(tiles_x, tiles_y, per_tile, generator, pw=16):
    """A (tile, depth)-ordered row stream for 32-px tiles, on the CPU, that
    is hard on the stream kernel's quadrant test: of the `per_tile` Gaussians
    of a tile a quarter each are
    - rotated, strongly anisotropic splats (axes 6-30 and 0.3-1.2 px) whose
      alpha = 1/255 contour passes within 5% of a pixel on a quadrant's edge
      or corner (tile-local x or y in {0, 15, 16, 31});
    - splats whose opacity is within a factor 0.9-1.5 of 1/255, so that at
      most the pixels next to the centre blend them;
    - splats centred 40 px outside the tile, some wide enough to reach it;
    - `synthetic_stream`'s ordinary ones, which make pixels saturate.
    Returns (rows [M, pw] f32, starts [T+1] int32)."""
    tiles = tiles_x * tiles_y
    rows, starts = synthetic_stream(tiles_x, tiles_y, 32,
                                    [per_tile] * tiles, generator, pw=pw)
    m = rows.shape[0]
    tile = torch.arange(m) // per_tile
    ox = (tile % tiles_x).float() * 32.0
    oy = (tile // tiles_x).float() * 32.0

    def u(lo, hi):
        return torch.rand(m, generator=generator) * (hi - lo) + lo

    def pick(values):
        return torch.tensor(values)[torch.randint(len(values), (m,),
                                                  generator=generator)]
    kind = torch.randint(4, (m,), generator=generator)
    # the conic of a splat with axes (sa, sb) turned by th
    sa = torch.where(kind == 0, u(6.0, 30.0), u(0.5, 6.0))
    sb = torch.where(kind == 0, u(0.3, 1.2), u(0.5, 6.0))
    sa = torch.where((kind == 2) & (u(0.0, 1.0) < 0.5), u(10.0, 25.0), sa)
    th = u(0.0, np.pi)
    c, s_ = torch.cos(th), torch.sin(th)
    cxx = c * c * sa * sa + s_ * s_ * sb * sb + 0.05
    cyy = s_ * s_ * sa * sa + c * c * sb * sb + 0.05
    cxy = c * s_ * (sa * sa - sb * sb)
    det = cxx * cyy - cxy * cxy
    a, b, cc = cyy / det, -cxy / det, cxx / det
    op = torch.where(kind == 1, u(0.9, 1.5) / 255.0, u(0.05, 0.99))
    # kind 0: the centre such that the pixel `at` lies on the level
    # 2 ln(255 op) (1 + delta)^2 of the conic quadratic, delta within 5%
    edge = pick([0.0, 15.0, 16.0, 31.0])
    other = torch.where(u(0.0, 1.0) < 0.5, pick([0.0, 15.0, 16.0, 31.0]),
                        torch.floor(u(0.0, 32.0)))
    swap = u(0.0, 1.0) < 0.5
    at_x = ox + torch.where(swap, edge, other)
    at_y = oy + torch.where(swap, other, edge)
    phi = u(0.0, 2.0 * np.pi)
    ux, uy = torch.cos(phi), torch.sin(phi)
    reach = torch.sqrt(2.0 * torch.log(255.0 * op)
                       / (a * ux * ux + 2.0 * b * ux * uy + cc * uy * uy))
    reach = reach * (1.0 + u(-0.05, 0.05))
    cx, cy = rows[:, 0].clone(), rows[:, 1].clone()
    cx = torch.where(kind == 0, at_x + ux * reach, cx)
    cy = torch.where(kind == 0, at_y + uy * reach, cy)
    # kind 2: 40 px beyond one side of the tile
    side = torch.randint(4, (m,), generator=generator)
    along = u(-8.0, 40.0)
    cx = torch.where(kind == 2, ox + torch.where(
        side == 0, torch.full_like(ox, -40.0),
        torch.where(side == 1, torch.full_like(ox, 71.0), along)), cx)
    cy = torch.where(kind == 2, oy + torch.where(
        side == 2, torch.full_like(oy, -40.0),
        torch.where(side == 3, torch.full_like(oy, 71.0), along)), cy)
    plain = kind == 3
    for col, val in ((0, cx), (1, cy), (2, a), (3, b), (4, cc),
                     (5, torch.log(op))):
        rows[:, col] = torch.where(plain, rows[:, col], val)
    return rows, starts


def kernel_cases():
    """(tile_size, hard_cutoffs, height, width, pw, stream) cases of phase
    2; both image edges are ragged at both tile sizes, and at 32-px tiles
    they cut through a quadrant. `stream` names the rows: "segments"
    (`synthetic_stream` with `case_segments`) or "adversarial"
    (`adversarial_stream`)."""
    cases = [(ts, hard, 100, 150, 16, "segments") for ts in (16, 32)
             for hard in (True, False)]
    cases += [(16, True, 100, 150, 24, "segments")]
    return cases + [(32, hard, 72, 110, pw, "adversarial")
                    for hard, pw in ((True, 16), (False, 16), (True, 32))]


def case_segments(tiles, generator):
    """Segment lengths: a third empty, two long ones spanning many staging
    batches, the rest short."""
    seg = torch.randint(1, 200, (tiles,), generator=generator)
    seg[torch.randperm(tiles, generator=generator)[: tiles // 3]] = 0
    seg[1] = 2500
    seg[tiles - 2] = 1100
    return seg


def compare_case(ts, hard, h, w, pw, stream, device, seed=0):
    """Kernel and plain version on one synthetic case -> max abs error."""
    from langsplat4d_torch.ops.composite import (composite_stream,
                                                 composite_stream_plain)
    g = torch.Generator().manual_seed(seed)
    tx, ty = -(-w // ts), -(-h // ts)
    if stream == "adversarial":
        rows, starts = adversarial_stream(tx, ty, 300, g, pw=pw)
    else:
        rows, starts = synthetic_stream(tx, ty, ts,
                                        case_segments(tx * ty, g), g, pw=pw)
    rows, starts = rows.to(device), starts.to(device)
    bg = torch.tensor([0.2, 0.5, 0.8], device=device)
    kw = dict(tiles_x=tx, tiles_y=ty, tile_size=ts, height=h, width=w,
              hard_cutoffs=hard)
    out = composite_stream(rows, starts, bg, **kw)
    ref = composite_stream_plain(rows, starts, bg, **kw)
    torch.cuda.synchronize()
    if out.shape != (pw - 7, h, w) or not torch.isfinite(out).all():
        raise AssertionError(f"bad kernel output {tuple(out.shape)}")
    return float((out - ref).abs().max())


def synthetic_lists(tiles_x, tiles_y, k_cap, counts, generator, pw=16):
    """Padded per-tile lists on the CPU from `synthetic_stream`: tile t
    holds counts[t] rows front-compacted in rows[t, :counts[t]]; the padded
    slots carry the invalid sentinel ln_op = -1e30 and garbage elsewhere.
    Returns (rows [T, K, pw] f32, counts [T] int32)."""
    counts = torch.as_tensor(counts, dtype=torch.int64)
    stream, starts = synthetic_stream(tiles_x, tiles_y, 16, counts, generator,
                                      pw=pw)
    rows = torch.randn(len(counts), k_cap, pw, generator=generator)
    rows[:, :, 5] = -1e30
    slot = torch.arange(int(counts.sum())) - torch.repeat_interleave(
        starts[:-1].long(), counts)
    rows[torch.repeat_interleave(torch.arange(len(counts)), counts),
         slot] = stream
    return rows, counts.to(torch.int32)


def list_cases():
    """(hard_cutoffs, pw) cases of phase 7."""
    return [(True, 16), (False, 16), (True, 24), (True, 32)]


def case_counts(tiles, k_cap, generator):
    """List lengths: empty, one entry, full and ragged."""
    counts = torch.randint(2, k_cap, (tiles,), generator=generator)
    counts[0], counts[1], counts[2], counts[tiles - 1] = 0, 1, k_cap, k_cap
    counts[torch.randperm(tiles - 4, generator=generator)[:4] + 3] = 0
    return counts


TURN_ROUNDS = 5     # rounds of (lists, stream, stream, lists) in phase 15
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)   # the repo's gradient bound
                                        # (tests/test_pallas_composite.py)


def grad_excess(got, want):
    """max of |got - want| - (atol + rtol |want|): <= 0 within GRAD_TOL."""
    return float(((got - want).abs() - GRAD_TOL["atol"]
                  - GRAD_TOL["rtol"] * want.abs()).max())


def scaled_errors(got, want):
    """(max abs error, excess over GRAD_TOL), both after dividing by the
    largest |want|: the gradient bound taken relative to this tensor's own
    scale. Where `want` is all zero, `got` must be too."""
    scale = float(want.abs().max())
    if scale == 0.0:
        worst = float(got.abs().max())
        return worst, (0.0 if worst == 0.0 else float("inf"))
    return (float((got - want).abs().max()) / scale,
            grad_excess(got / scale, want / scale))


def hold_columns(tag, got, want, phase=9):
    """Hold every column (last axis) of a gradient to GRAD_TOL relative to
    that column's own largest entry, print the columns' errors (as phase
    `phase`), and raise on the first that is beyond the bound."""
    res = [scaled_errors(got[..., j], want[..., j])
           for j in range(want.shape[-1])]
    print(f"[{phase}] {tag} per column, max abs err / column max "
          f"(column max): " + ", ".join(
              f"{j}: {e:.3g} ({float(want[..., j].abs().max()):.3g})"
              for j, (e, _) in enumerate(res)), flush=True)
    for j, (e, x) in enumerate(res):
        if x > 0:
            raise AssertionError(f"{tag} column {j} beyond the gradient "
                                 f"bound: scaled error {e}, excess {x}")


def compare_list_case(hard, pw, device, seed=0, tiles=(7, 5), k_cap=80):
    """The tile-list forward and backward kernels and their plain versions
    on one synthetic case -> (forward max abs error, backward max abs error,
    backward excess over the gradient bound)."""
    from langsplat4d_torch.ops import composite as C
    g = torch.Generator().manual_seed(seed)
    tx, ty = tiles
    rows, counts = synthetic_lists(tx, ty, k_cap,
                                   case_counts(tx * ty, k_cap, g), g, pw=pw)
    g_out = torch.randn(tx * ty, pw - 7, 256, generator=g)
    rows, counts, g_out = (t.to(device) for t in (rows, counts, g_out))
    bg = torch.tensor([0.2, 0.5, 0.8], device=device)
    kw = dict(tiles_x=tx, tile_size=16, hard_cutoffs=hard)
    out = C.composite_tiles(rows, counts, bg, **kw)
    ref = C.composite_tiles_plain(rows, counts, bg, **kw)
    total = (ref * g_out).sum(1)
    d_rows = C.composite_tiles_backward(rows, counts, g_out, total, **kw)
    d_ref = C.composite_tiles_backward_plain(rows, counts, g_out, total, **kw)
    torch.cuda.synchronize()
    for t in (out, d_rows):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite kernel output")
    if out.shape != (tx * ty, pw - 7, 256) or d_rows.shape != rows.shape:
        raise AssertionError(f"bad shapes {tuple(out.shape)} "
                             f"{tuple(d_rows.shape)}")
    return (float((out - ref).abs().max()),
            float((d_rows - d_ref).abs().max()), grad_excess(d_rows, d_ref))


def segment_cases():
    """(hard_cutoffs, pw) cases of phase 12."""
    return [(True, 16), (False, 16), (True, 24), (True, 32)]


def compare_segment_case(hard, pw, device, seed=0, tiles=(7, 5)):
    """The stream-layout training kernels and their plain versions on one
    synthetic case: ragged segments, some empty, one of one row, two of more
    than 1000 rows (`case_segments`) -> (forward max abs error, backward max
    abs error, backward excess over the gradient bound). The bound is taken
    column by column relative to the column's largest entry
    (`scaled_errors`): with a cotangent of unit normals the conic columns
    reach several hundred, and in a few of these ~8000 rows they cancel to
    1e-4 of that, where float32 rounding of the sums over a tile's pixels
    (~1e-6 of the column's scale, 5e-4 absolute) is beyond an elementwise
    atol of 2e-4. A column that is zero in the plain version must be zero."""
    from langsplat4d_torch.ops import composite as C
    g = torch.Generator().manual_seed(seed)
    tx, ty = tiles
    seg = case_segments(tx * ty, g)
    seg[3] = 1
    rows, starts = synthetic_stream(tx, ty, 16, seg, g, pw=pw)
    g_out = torch.randn(tx * ty, pw - 7, 256, generator=g)
    rows, starts, g_out = (t.to(device) for t in (rows, starts, g_out))
    bg = torch.tensor([0.2, 0.5, 0.8], device=device)
    kw = dict(tiles_x=tx, tile_size=16, hard_cutoffs=hard)
    out = C.composite_stream_chunks(rows, starts, bg, **kw)
    ref = C.composite_stream_chunks_plain(rows, starts, bg, **kw)
    total = (ref * g_out).sum(1)
    d_rows = C.composite_stream_chunks_backward(rows, starts, g_out, total,
                                                **kw)
    d_ref = C.composite_stream_chunks_backward_plain(rows, starts, g_out,
                                                     total, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    for t in (out, d_rows):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite kernel output")
    if out.shape != (tx * ty, pw - 7, 256) or d_rows.shape != rows.shape:
        raise AssertionError(f"bad shapes {tuple(out.shape)} "
                             f"{tuple(d_rows.shape)}")
    return (float((out - ref).abs().max()),
            float((d_rows - d_ref).abs().max()),
            max(scaled_errors(d_rows[:, j], d_ref[:, j])[1]
                for j in range(pw)))


def cell_lists(table, lo, hi, cells_x, cells_y, cell, generator):
    """Candidate lists of Gaussians with tile rects [lo, hi) (max exclusive)
    in cells of cell x cell tiles: the rect goes into columns 6 and 7 as
    x + 256 y, and a Gaussian is a candidate of every cell its rect
    touches, in the table's order. Besides, every cell gets some candidates
    whose rect covers none of its tiles, and cell 1 gets no candidate at
    all. Returns (rows, cell_starts [n_cells + 1] int32)."""
    m = table.shape[0]
    table[:, 6] = lo[:, 0] + 256.0 * lo[:, 1]
    table[:, 7] = hi[:, 0] + 256.0 * hi[:, 1]
    picks, lens = [], []
    for ci in range(cells_x * cells_y):
        x0, y0 = (ci % cells_x) * cell, (ci // cells_x) * cell
        touches = ((lo[:, 0] < x0 + cell) & (hi[:, 0] > x0)
                   & (lo[:, 1] < y0 + cell) & (hi[:, 1] > y0))
        strangers = torch.zeros(m, dtype=torch.bool)
        strangers[torch.randperm(m, generator=generator)[:m // 20]] = True
        cand = (touches | strangers) if ci != 1 else torch.zeros_like(touches)
        picks.append(cand.nonzero()[:, 0])
        lens.append(len(picks[-1]))
    starts = torch.zeros(len(lens) + 1, dtype=torch.int32)
    starts[1:] = torch.cumsum(torch.tensor(lens), 0).to(torch.int32)
    return table[torch.cat(picks)], starts


def synthetic_cells(cells_x, cells_y, cell, per_tile, generator, pw=16):
    """Depth-ordered candidate rows per cell on the CPU, from
    `synthetic_stream`'s Gaussians (`per_tile` around every tile of the
    grid, in depth order): each gets a tile rect of random reach around its
    centre (`cell_lists`). Returns (rows [M, pw] f32 with the rect in
    columns 6 and 7, cell_starts [n_cells + 1] int32)."""
    tiles_x, tiles_y = cells_x * cell, cells_y * cell
    table, _ = synthetic_stream(tiles_x, tiles_y, 16,
                                [per_tile] * (tiles_x * tiles_y), generator,
                                pw=pw)
    m = table.shape[0]
    table = table[torch.randperm(m, generator=generator)]
    table[:, pw - 2] = torch.sort(table[:, pw - 2]).values   # depth order
    reach = torch.rand(m, 2, generator=generator) * 40.0 + 4.0
    lo = torch.clamp(torch.floor((table[:, :2] - reach) / 16.0), min=0)
    hi = torch.clamp(torch.floor((table[:, :2] + reach) / 16.0) + 1, min=0)
    hi = torch.minimum(hi, torch.tensor([tiles_x, tiles_y]).float())
    lo = torch.minimum(lo, hi)
    return cell_lists(table, lo, hi, cells_x, cells_y, cell, generator)


def adversarial_cells(cells_x, cells_y, cell, per_tile, generator, pw=16):
    """Depth-ordered candidate rows per cell on the CPU that are hard on the
    cell kernel's tile test: `per_tile` Gaussians at home in every 16-px
    tile, a quarter each
    - rotated, strongly anisotropic splats (axes 6-30 and 0.3-1.2 px) whose
      alpha = 1/255 contour passes within 5% of a pixel on the home tile's
      edge (tile-local x or y in {0, 15});
    - splats centred on a tile border (a multiple of 16 in x or y, or
      both) with an opacity within a factor 0.9-1.5 of 1/255, so that at
      most the pixels next to the centre blend them;
    - indefinite conics (b^2 > a c), which the test must keep;
    - `synthetic_stream`'s ordinary ones, which make pixels saturate.
    Every rect covers its home tile and reaches 0-2 tiles beyond it on each
    side, so most (tile, row) pairs it covers are far from the splat
    (`cell_lists`). Returns (rows [M, pw] f32, cell_starts [n_cells + 1]
    int32)."""
    tiles_x, tiles_y = cells_x * cell, cells_y * cell
    rows, _ = synthetic_stream(tiles_x, tiles_y, 16,
                               [per_tile] * (tiles_x * tiles_y), generator,
                               pw=pw)
    m = rows.shape[0]
    home = torch.arange(m) // per_tile
    hx, hy = home % tiles_x, home // tiles_x
    ox, oy = hx.float() * 16.0, hy.float() * 16.0

    def u(lo, hi):
        return torch.rand(m, generator=generator) * (hi - lo) + lo

    def pick(values):
        return torch.tensor(values)[torch.randint(len(values), (m,),
                                                  generator=generator)]
    kind = torch.randint(4, (m,), generator=generator)
    sa = torch.where(kind == 0, u(6.0, 30.0), u(0.5, 6.0))
    sb = torch.where(kind == 0, u(0.3, 1.2), u(0.5, 6.0))
    th = u(0.0, np.pi)
    c, s_ = torch.cos(th), torch.sin(th)
    cxx = c * c * sa * sa + s_ * s_ * sb * sb + 0.05
    cyy = s_ * s_ * sa * sa + c * c * sb * sb + 0.05
    cxy = c * s_ * (sa * sa - sb * sb)
    det = cxx * cyy - cxy * cxy
    a, b, cc = cyy / det, -cxy / det, cxx / det
    op = torch.where(kind == 1, u(0.9, 1.5) / 255.0, u(0.05, 0.99))
    # kind 0: the pixel `at` on the home tile's edge lies on the level
    # 2 ln(255 op) (1 + delta)^2 of the conic quadratic, delta within 5%
    edge = pick([0.0, 15.0])
    other = torch.where(u(0.0, 1.0) < 0.5, pick([0.0, 15.0]),
                        torch.floor(u(0.0, 16.0)))
    swap = u(0.0, 1.0) < 0.5
    at_x = ox + torch.where(swap, edge, other)
    at_y = oy + torch.where(swap, other, edge)
    phi = u(0.0, 2.0 * np.pi)
    ux, uy = torch.cos(phi), torch.sin(phi)
    reach = torch.sqrt(2.0 * torch.log(255.0 * op)
                       / (a * ux * ux + 2.0 * b * ux * uy + cc * uy * uy))
    reach = reach * (1.0 + u(-0.05, 0.05))
    cx = torch.where(kind == 0, at_x + ux * reach, rows[:, 0])
    cy = torch.where(kind == 0, at_y + uy * reach, rows[:, 1])
    # kind 1: on a border of the home tile
    on_x = u(0.0, 1.0) < 0.7
    on_y = ~on_x | (u(0.0, 1.0) < 0.3)
    cx = torch.where((kind == 1) & on_x, ox + pick([0.0, 16.0]), cx)
    cy = torch.where((kind == 1) & on_y, oy + pick([0.0, 16.0]), cy)
    cx = torch.where((kind == 1) & ~on_x, ox + u(0.0, 16.0), cx)
    cy = torch.where((kind == 1) & ~on_y, oy + u(0.0, 16.0), cy)
    # kind 2: indefinite, b^2 = (1.5 to 4) a c, either sign
    b = torch.where(kind == 2, torch.sqrt(a * cc * u(1.5, 4.0))
                    * torch.where(u(0.0, 1.0) < 0.5, 1.0, -1.0), b)
    plain = kind == 3
    for col, val in ((0, cx), (1, cy), (2, a), (3, b), (4, cc),
                     (5, torch.log(op))):
        rows[:, col] = torch.where(plain, rows[:, col], val)
    order = torch.randperm(m, generator=generator)
    rows, hx, hy = rows[order], hx[order], hy[order]
    rows[:, pw - 2] = torch.sort(rows[:, pw - 2]).values    # depth order
    home = torch.stack([hx, hy], 1).float()
    grid = torch.tensor([tiles_x, tiles_y]).float()
    lo = torch.clamp(home - torch.randint(3, (m, 2), generator=generator),
                     min=0)
    hi = torch.minimum(home + 1 + torch.randint(3, (m, 2),
                                                generator=generator), grid)
    return cell_lists(rows, lo, hi, cells_x, cells_y, cell, generator)


def cell_cases():
    """(hard_cutoffs, pw, rows) cases of phase 17; `rows` names the
    candidates: "synthetic" (`synthetic_cells`) or "adversarial"
    (`adversarial_cells`)."""
    return [(True, 16, "synthetic"), (False, 16, "synthetic"),
            (True, 24, "synthetic"), (True, 16, "adversarial"),
            (False, 32, "adversarial")]


def make_cells(kind, pw, generator, cells=(3, 2), cell=4):
    """The candidate rows of one cell case (see `cell_cases`)."""
    if kind == "adversarial":
        return adversarial_cells(cells[0], cells[1], cell, 12, generator,
                                 pw=pw)
    return synthetic_cells(cells[0], cells[1], cell, 30, generator, pw=pw)


def compare_cell_case(hard, pw, kind, device, seed=0, cells=(3, 2), cell=4):
    """The cell kernel and its plain version on one synthetic case -> max
    abs error."""
    from langsplat4d_torch.ops import composite as C
    g = torch.Generator().manual_seed(seed)
    rows, starts = make_cells(kind, pw, g, cells, cell)
    if int(starts[2] - starts[1]) != 0 or int(starts[1]) < 300:
        raise AssertionError(f"bad synthetic cells {starts.tolist()}")
    rows, starts = rows.to(device), starts.to(device)
    bg = torch.tensor([0.2, 0.5, 0.8], device=device)
    kw = dict(cells_x=cells[0], cell=cell, tile_size=16, hard_cutoffs=hard)
    out = C.composite_cells(rows, starts, bg, **kw)
    ref = C.composite_cells_plain(rows, starts, bg, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    if (out.shape != (cells[0] * cells[1], cell * cell, pw - 7, 256)
            or not torch.isfinite(out).all()):
        raise AssertionError(f"bad kernel output {tuple(out.shape)}")
    if not float(ref[:, :, pw - 8].max()) > 0.5:
        raise AssertionError("the synthetic cells cover nothing")
    return float((out - ref).abs().max())


def bench_workload(device, frames=60, n=200_000, hw=(1014, 1352)):
    """The bench scene, deformation, AABB and orbit (bench.py:38-73)."""
    from langsplat4d_torch.data.cameras import HostCamera
    from langsplat4d_torch.field.deformation import (DeformConfig,
                                                     DeformNetwork)
    from langsplat4d_torch.utils.synth import realistic_gaussians
    (H, W), lang_dim = hw, 3
    gs = realistic_gaussians(n, lang_dim=lang_dim, seed=0,
                             device=device)
    dcfg = DeformConfig(
        lang_dim=lang_dim, no_dlang=False, kplanes_out_dim=16,
        kplanes_resolution=(64, 64, 64, 150), multires=(1, 2), net_width=128,
        defor_depth=0, no_do=False, no_dshs=False, no_ds=False)
    net = DeformNetwork(dcfg, torch.Generator().manual_seed(0)).to(device)
    aabb = torch.tensor([[2.6] * 3, [-2.6] * 3], device=device)
    views = []
    for i in range(frames):
        ang = 2.0 * np.pi * i / frames * 0.25
        Rm = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]], np.float64)
        views.append(HostCamera(R=Rm, T=np.array([0.0, 0.0, 4.5]), fovx=1.0,
                                fovy=0.8, width=W, height=H,
                                time=i / max(frames - 1, 1)))
    return gs, dcfg, net, aabb, views


# the optimisation parameters the training-step workload takes its learning
# rates from (the JAX package's OptimizationConfig defaults, restated)
OPTIM = types.SimpleNamespace(
    position_lr_init=0.00016, position_lr_final=0.0000016,
    position_lr_delay_mult=0.01, position_lr_max_steps=20_000,
    deformation_lr_init=0.00016, deformation_lr_final=0.000016,
    deformation_lr_delay_mult=0.01, grid_lr_init=0.0016,
    grid_lr_final=0.00016, feature_lr=0.0025, opacity_lr=0.05,
    scaling_lr=0.005, rotation_lr=0.001, language_feature_lr=0.0025)


def train_camera(hw=(536, 960)):
    """The training-step workload's camera."""
    from langsplat4d_torch.data.cameras import HostCamera
    return HostCamera(R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), fovx=1.0,
                      fovy=0.8, width=hw[1], height=hw[0])


def train_workload(device, n=100_000, hw=(536, 960), tile_capacity=512,
                   net_width=128, stream=False):
    """The training-step workload (bench.py:293-419): realistic Gaussians,
    the Neu3D-preset deformation, one camera at T = (0, 0, 4), time 0.3,
    16-px tiles, fine-lang, batch 1, random ground truth from a seed, a mask
    of ones, black background; `stream` trains on the stream layout instead
    of the tile lists. -> (state, step config, batch, bg)."""
    from langsplat4d_torch.field.deformation import (DeformConfig,
                                                     DeformNetwork)
    from langsplat4d_torch.render.raster import CameraParams, RasterSettings
    from langsplat4d_torch.train.optim import LRConfig
    from langsplat4d_torch.train.step import Batch, StepConfig
    from langsplat4d_torch.train.trainstate import make_train_state
    from langsplat4d_torch.utils.synth import realistic_gaussians
    (H, W), lang_dim = hw, 3
    rng = np.random.default_rng(1)
    gs = realistic_gaussians(n, lang_dim=lang_dim, seed=1, device=device)
    dcfg = DeformConfig(
        lang_dim=lang_dim, no_dlang=False, kplanes_out_dim=16,
        kplanes_resolution=(64, 64, 64, 150), multires=(1, 2),
        net_width=net_width, defor_depth=0, no_do=False, no_dshs=False,
        no_ds=False)
    net = DeformNetwork(dcfg, torch.Generator().manual_seed(1)).to(device)
    aabb = torch.tensor([[1.6] * 3, [-1.6] * 3], device=device)
    state = make_train_state(gs, net, aabb, active_sh_degree=3)
    cam = train_camera(hw).camera_params(device)

    def up(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)
    batch = Batch(
        cams=CameraParams(*[t[None] for t in cam]),
        times=torch.tensor([0.3], device=device),
        gt_images=up(rng.uniform(size=(1, 3, H, W))),
        gt_lang=up(rng.normal(size=(1, lang_dim, H, W))),
        lang_mask=torch.ones((1, 1, H, W), device=device))
    settings = RasterSettings(image_height=H, image_width=W, sh_degree=3,
                              include_feature=True, analytic_vjp=True,
                              tile_capacity=tile_capacity,
                              stream_train=stream)
    cfg = StepConfig(settings=settings, dcfg=dcfg,
                     lr_cfg=LRConfig.from_optim(OPTIM, 1.0),
                     stage="fine-lang", no_dlang=False)
    return state, cfg, batch, torch.zeros(3, device=device)


class Marks:
    """CUDA events between the stages of one pass; off the GPU it records
    nothing."""

    def __init__(self, device):
        self.on = device.type == "cuda"
        self.events, self.names = [], []

    def mark(self, name=None):
        if self.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)
            if name is not None:
                self.names.append(name)

    def ms(self):
        """{stage: ms}; call after a synchronize."""
        return {n: self.events[i].elapsed_time(self.events[i + 1])
                for i, n in enumerate(self.names)}


def staged_step(cfg, state, batch, bg, plain=False, update=False):
    """One training step of the workload, stage by stage, with the
    compositor's pieces called directly instead of through autograd (the
    same calls `CompositeCV` or, with `stream_train`, `StreamCV` makes), so
    that each stage can be timed and the kernels' inputs and outputs kept.
    `plain` runs the kernels' plain versions instead; `update` applies
    Adam. Returns a dict with the loss, the rows, their bounds (the lists'
    counts or the stream's starts), g_out and total the kernels saw, the
    gradient of the packed rows, the leaves' gradients and the stage
    times."""
    from langsplat4d_torch.ops import composite as C
    from langsplat4d_torch.render.composite_vjp import (drop_padding,
                                                        kernel_rows,
                                                        pad_cotangent,
                                                        scatter_rows)
    from langsplat4d_torch.render.pipeline import prepare_attributes
    from langsplat4d_torch.render.raster import (CameraParams, bin_tiles,
                                                 pack_differentiable,
                                                 preprocess, tiles_to_image)
    from langsplat4d_torch.render.stream import build_stream_train
    from langsplat4d_torch.render.stream_vjp import stream_rows
    from langsplat4d_torch.train import losses
    from langsplat4d_torch.train.optim import (adam_update, group_lrs,
                                               group_of_leaf, trainable_tree)
    settings = cfg.settings
    stream = settings.stream_train
    names = (("composite_stream_chunks", "composite_stream_chunks_backward")
             if stream else ("composite_tiles", "composite_tiles_backward"))
    fwd, bwd = (getattr(C, n + ("_plain" if plain else "")) for n in names)
    kw = dict(tiles_x=settings.tiles_x, tile_size=settings.tile_size,
              hard_cutoffs=settings.hard_cutoffs)
    leaves = state.leaves()
    train = trainable_tree(leaves, cfg.stage, include_feature=True,
                           joint_train=cfg.joint_train, no_dlang=cfg.no_dlang)
    wrt = [n for n in leaves if train[n]]
    for name, p in state.deform.named_parameters():
        p.requires_grad_(train["deform." + name])
    gs = state.gaussians()
    gs.language_feature = gs.language_feature.detach().requires_grad_(True)
    dummy = torch.zeros((state.capacity, 2), device=state.device,
                        requires_grad=True)
    cam = CameraParams(*[t[0] for t in batch.cams])
    m = Marks(state.device)

    m.mark("deform+preprocess")
    a = prepare_attributes(cfg.dcfg, cfg.stage, batch.times[0], gs,
                           state.deform, state.aabb)
    prep = preprocess(settings, cam, a[0], a[3], a[1], a[2], a[4], None,
                      active=gs.active_mask(), means2d_dummy=dummy)
    valid = None
    if stream:
        m.mark("build")
        index, bounds = build_stream_train(settings, prep,
                                           settings.stream_ellipse_cull)
        m.mark("gather")
    else:
        m.mark("lists")
        index, valid = bin_tiles(settings, prep)
        m.mark("pack")
    packed = pack_differentiable(prep, a[5])
    with torch.no_grad():
        if stream:
            rows = stream_rows(packed, index)
        else:
            rows, bounds = kernel_rows(packed, index, valid)
        m.mark("forward kernel")
        accum = fwd(rows, bounds, bg, **kw)
    m.mark("loss")
    out = drop_padding(accum, packed.shape[1] - 6).detach().clone(
        ).requires_grad_(True)
    lang_img = tiles_to_image(settings, out)[3:3 + cfg.dcfg.lang_dim][None]
    loss = cfg.lam * losses.l1_loss(lang_img * batch.lang_mask,
                                    batch.gt_lang * batch.lang_mask)
    g_out, = torch.autograd.grad(loss, out)
    with torch.no_grad():
        g_full = pad_cotangent(g_out, accum.shape[1] - 1)
        total = torch.sum(accum * g_full, dim=1)
        m.mark("backward kernel")
        d_rows = bwd(rows, bounds, g_full, total, **kw)
        m.mark("scatter-add")
        d_packed = scatter_rows(d_rows, index, packed)
    m.mark("rest of backward")
    inputs = [dummy] + [gs.language_feature if n == "language_feature"
                        else leaves[n] for n in wrt]
    got = torch.autograd.grad(packed, inputs, grad_outputs=d_packed,
                              allow_unused=True)
    grads = dict(zip(wrt, got[1:]))
    m.mark("adam")
    if update:
        group_lr = group_lrs(cfg.lr_cfg, 1)
        adam_update(leaves, grads, state.opt,
                    {n: group_lr[group_of_leaf(n)] for n in leaves}, train)
    m.mark()
    if m.on:
        torch.cuda.synchronize()
    return dict(loss=loss.detach(), rows=rows, bounds=bounds, g_out=g_full,
                total=total, accum=accum, d_rows=d_rows, d_packed=d_packed,
                grads=grads, vs_grad=got[0], valid=valid, index=index,
                ms=m.ms() if m.on else {})


def profile_steps(cfg, state, batch, bg, ms_step, steps=5, phase=11):
    """Phase 11 (and part of 15): torch.profiler over a few training steps:
    device kernels per step, their summed time against the unprofiled step
    time `ms_step` (the device's busy share), and the kernels that take most
    of it. Fails if the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    from langsplat4d_torch.train.step import train_step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            train_step(cfg, state, batch, bg, 100 + i, 3)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            rows.append((us / 1e3 / steps, e.count / steps, e.key))
    busy = sum(r[0] for r in rows)
    if not busy > 0:
        raise AssertionError("torch.profiler recorded no device time")
    rows.sort(reverse=True)
    print(f"[{phase}] torch.profiler over {steps} steps: "
          f"{sum(r[1] for r in rows):.0f} device kernels per step, kernel "
          f"time {busy:.3f} ms per step against {ms_step:.3f} ms unprofiled: "
          f"device busy {busy / ms_step:.1%}", flush=True)
    for ms, n, key in rows[:8]:
        print(f"[{phase}]   {ms:.3f} ms/step x{n:.0f}  {key[:90]}",
              flush=True)


def spread(x):
    """The median, least and largest of some timings, as text."""
    return f"median {np.median(x):.3f} (min {min(x):.3f}, max {max(x):.3f})"


def timed_steps(cfg, state, batch, bg, steps, first_iteration):
    """`steps` train_step calls -> (ms/step by CUDA events with the device
    synchronised inside the window, ms/step on the host clock, the losses,
    the last step's outputs). Off the GPU the event time is nan."""
    from langsplat4d_torch.train.step import train_step
    on_card = state.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
    t0 = time.perf_counter()
    step_losses = []
    for i in range(steps):
        out = train_step(cfg, state, batch, bg, first_iteration + i, 3)
        step_losses.append(out[1]["loss"])
    if on_card:
        e1.record()
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    ms_step = e0.elapsed_time(e1) / steps if on_card else float("nan")
    return ms_step, host_ms, [float(x) for x in step_losses], out


def train_phases(dev, steps=20, stream=False, list_ms=None, **workload_kw):
    """Phases 8 to 11 on `dev`, or with `stream` phases 13 to 15, the same
    on the stream layout (a CPU device rehearses them at a small size with
    the plain versions and times nothing). `list_ms` is phase 8's step time,
    printed beside the stream step's. Returns (the kernels' JSON entries for
    the layout's forward and backward kernel, ms per step). The profiles
    (phase 11, and phase 15's) are taken by the caller after every timing of
    the run, so that no timing is taken with the profiler attached."""
    from langsplat4d_torch.ops import composite as C
    from langsplat4d_torch.render.composite_vjp import scatter_rows
    from langsplat4d_torch.train.step import train_step
    on_card = dev.type == "cuda"
    p_run, p_cmp, p_time = (13, 14, 15) if stream else (8, 9, 10)
    names = (("composite_stream_chunks", "composite_stream_chunks_backward")
             if stream else ("composite_tiles", "composite_tiles_backward"))
    fwd, bwd = (getattr(C, n) for n in names)
    fwd_plain, bwd_plain = (getattr(C, n + "_plain") for n in names)

    # 8 / 13. the main path
    state, cfg, batch, bg = train_workload(dev, stream=stream, **workload_kw)
    before = {n: p.detach().clone() for n, p in state.leaves().items()}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    fwd.launches = bwd.launches = 0
    state, metrics, vs_grad, vis, radii = train_step(cfg, state, batch, bg,
                                                     1, 3)      # warm-up
    first_loss = float(metrics["loss"])
    ms_step, host_ms, step_losses, out = timed_steps(cfg, state, batch, bg,
                                                     steps, 2)
    _, _, vs_grad, vis, radii = out
    launches = (fwd.launches, bwd.launches)
    step_losses = [first_loss] + step_losses
    peak = torch.cuda.max_memory_allocated() / 2 ** 20 if on_card else 0.0
    print(f"[{p_run}] train_step x{steps} after 1 warm-up"
          f"{' on the stream layout' if stream else ''}: {ms_step:.3f} "
          f"ms/step (CUDA events), {1e3 / ms_step:.3f} it/s; host clock "
          f"{host_ms:.3f} ms/step; peak memory {peak:.1f} MiB; loss "
          f"{step_losses[0]:.6f} -> {step_losses[-1]:.6f}; visible "
          f"{int(vis.sum())}; launches forward {launches[0]}, backward "
          f"{launches[1]}", flush=True)
    if not all(np.isfinite(step_losses)):
        raise AssertionError(f"loss not finite: {step_losses}")
    if not step_losses[-1] < step_losses[0]:
        raise AssertionError(f"loss did not fall: {step_losses}")
    if on_card and min(launches) < steps + 1:
        raise AssertionError(f"kernels launched {launches} times in "
                             f"{steps + 1} steps")
    if not (torch.isfinite(vs_grad).all() and vs_grad.abs().max() > 0):
        raise AssertionError("viewspace gradient zero or not finite")
    moved = set()
    for n, p in state.leaves().items():
        if not torch.isfinite(p).all():
            raise AssertionError(f"{n} not finite after training")
        if not torch.equal(p, before[n]):
            moved.add(n)
    want = {n for n in before
            if n == "language_feature" or ".lang_deform." in n}
    if moved != want:
        raise AssertionError(f"leaves that changed: {sorted(moved)}; "
                             f"expected {sorted(want)}")
    del before

    # 9 / 14. step 1 again from the same seed, stage by stage: kernels vs
    # plain
    state, cfg, batch, bg = train_workload(dev, stream=stream, **workload_kw)
    ker = staged_step(cfg, state, batch, bg, plain=False)
    ref = staged_step(cfg, state, batch, bg, plain=True)
    if stream:
        n_valid = ker["rows"].shape[0]
        seg = ker["bounds"][1:] - ker["bounds"][:-1]
        over = seg > cfg.settings.tile_capacity
        print(f"[{p_cmp}] step 1: stream of {n_valid} slots in "
              f"{seg.numel()} segments, longest {int(seg.max())}, empty "
              f"{int((seg == 0).sum())}; {int(over.sum())} segments are "
              f"longer than the lists' capacity "
              f"{cfg.settings.tile_capacity} and hold "
              f"{int(seg[over].sum())} slots, "
              f"{int((seg[over] - cfg.settings.tile_capacity).sum())} of "
              f"them beyond that capacity", flush=True)
    else:
        n_valid = int(ker["bounds"].sum())
        full = float((ker["bounds"] == cfg.settings.tile_capacity
                      ).float().mean())
        print(f"[{p_cmp}] step 1: valid list entries {n_valid}, tiles with "
              f"a full list {full:.4f}", flush=True)
    for n, g in ker["grads"].items():
        if g is None or not torch.isfinite(g).all():
            raise AssertionError(f"gradient of {n} missing or not finite")
    rel = abs(float(ker["loss"]) - first_loss) / first_loss
    fwd_err = float((ker["accum"] - ref["accum"]).abs().max())
    d_err = float((ker["d_packed"] - ref["d_packed"]).abs().max())
    print(f"[{p_cmp}] staged loss vs train_step's: rel diff {rel:.3g}; "
          f"kernels vs plain: loss {float(ker['loss']):.8f} vs "
          f"{float(ref['loss']):.8f}, accum max abs err {fwd_err:.3g}, "
          f"d_packed max abs err {d_err:.3g} of max "
          f"{float(ref['d_packed'].abs().max()):.3g}", flush=True)
    if rel > 1e-6:
        raise AssertionError("the staged step is not train_step's step")
    if fwd_err > TOL or abs(float(ker["loss"] - ref["loss"])) > 1e-7:
        raise AssertionError("forward kernel disagrees with plain")
    # the loss is a mean over 1.5M pixel-channels, so the gradients are tiny
    # and their columns differ by orders of magnitude (the feature columns,
    # which alone reach the trained leaves in fine-lang, are the smallest):
    # each column is held to the gradient bound relative to its own largest
    # entry, and so is each trained leaf
    hold_columns("d_rows", ker["d_rows"], ref["d_rows"], p_cmp)
    hold_columns("d_packed", ker["d_packed"], ref["d_packed"], p_cmp)
    for n in ["vs_grad"] + sorted(ref["grads"]):
        got, want = ((ker[n], ref[n]) if n == "vs_grad"
                     else (ker["grads"][n], ref["grads"][n]))
        e, x = scaled_errors(got, want)
        print(f"[{p_cmp}] {n}: max abs err / leaf max {e:.3g} (leaf max "
              f"{float(want.abs().max()):.3g})", flush=True)
        if float(want.abs().max()) == 0.0:
            raise AssertionError(f"the gradient of {n} is zero")
        if x > 0:
            raise AssertionError(f"gradient of {n} beyond the gradient "
                                 f"bound: scaled error {e}, excess {x}")
    if not on_card:
        return [], ms_step

    # 10 / 15. per-stage times, kernel and plain times
    n_stage = 10
    tot = {}
    for i in range(n_stage + 1):
        ms = staged_step(cfg, state, batch, bg, update=True)["ms"]
        if i:                                        # pass 0 warms up
            for k, v in ms.items():
                tot[k] = tot.get(k, 0.0) + v / n_stage
    print(f"[{p_time}] per-stage ms of a step (CUDA events, mean of "
          f"{n_stage}): " + ", ".join(f"{k} {v:.3f}" for k, v in tot.items())
          + f"; sum {sum(tot.values()):.3f}", flush=True)

    kw = dict(tiles_x=cfg.settings.tiles_x, tile_size=16, hard_cutoffs=True)
    rows, bounds, g_out, total = (ker[k] for k in
                                  ("rows", "bounds", "g_out", "total"))
    stats = {}
    plain_out = fwd_plain(rows, bounds, bg, stats=stats, **kw)
    pairs, live = stats["pair_pixels"], stats["live_pair_pixels"]
    f_pairs = pairs           # what the forward's bound charges
    if not stream:
        # The lists carry rows that no pixel of their tile blends (they are
        # cut with no ellipse cull), and the kernel's tile test drops them:
        # the same output, bit for bit, from the pairs that the plain twin
        # of that scheme counts, which the forward's bound charges (the
        # backward's keeps the plain version's count, as before).
        needed = {}
        culled = C.composite_tiles_plain(rows, bounds, bg, cull=True,
                                         stats=needed, **kw)
        print(f"[{p_time}] step 1 lists: the tile test keeps "
              f"{needed['kept_rows']} of {n_valid} rows; the plain version "
              f"evaluates {pairs} pair-pixels, the culled scheme "
              f"{needed['pair_pixels']}, live {live} and "
              f"{needed['live_pair_pixels']}", flush=True)
        if (not torch.equal(culled, plain_out)
                or needed["live_pair_pixels"] != live):
            raise AssertionError("the culled list scheme drops a pair that "
                                 "blends")
        f_pairs = needed["pair_pixels"]
    t_n, pw = ker["accum"].shape[0], rows.shape[-1]
    c = ker["d_packed"].shape[1] - 6      # the real channels, padding apart
    # each input read once, each output written once: the valid rows (the
    # lists' padding is never needed), their bounds, bg, accum; the backward
    # reads g_out and total besides and writes all of d_rows
    valid_row_bytes = n_valid * pw * 4
    out_bytes = t_n * (pw - 7) * 256 * 4
    f_bound = bound(valid_row_bytes + bounds.numel() * 4 + 12 + out_bytes,
                    forward_ops(f_pairs, live, c))
    b_bound = bound(valid_row_bytes + bounds.numel() * 4 + out_bytes
                    + t_n * 256 * 4 + rows.numel() * 4,
                    backward_ops(pairs, live, c))
    f_ms = time_ms(lambda: fwd(rows, bounds, bg, **kw), 20)
    fp_ms = time_ms(lambda: fwd_plain(rows, bounds, bg, **kw), 1)
    b_ms = time_ms(lambda: bwd(rows, bounds, g_out, total, **kw), 20)
    bp_ms = time_ms(lambda: bwd_plain(rows, bounds, g_out, total, **kw), 1)
    print(f"[{p_time}] step 1 rows {list(rows.shape)}, {f_pairs} evaluated "
          f"pair-pixels of which {live} live, {c} channels: forward kernel "
          f"{f_ms:.3f} ms (bound {f_bound[0]:.4f} by {f_bound[1]}: "
          f"{f_bound[2]}), plain {fp_ms:.1f} ms; backward kernel "
          f"{b_ms:.3f} ms (bound {b_bound[0]:.4f} by {b_bound[1]}: "
          f"{b_bound[2]}), plain {bp_ms:.1f} ms", flush=True)
    if stream:
        # the longest segment alone, every other tile empty: one block's
        # walk, which the whole launch cannot finish before
        seg = bounds[1:] - bounds[:-1]
        t = int(seg.argmax())
        lo, hi = int(bounds[t]), int(bounds[t + 1])
        alone = torch.zeros_like(bounds)
        alone[t + 1:] = hi - lo
        rows_t = rows[lo:hi].contiguous()
        f1_ms = time_ms(lambda: fwd(rows_t, alone, bg, **kw), 20)
        b1_ms = time_ms(lambda: bwd(rows_t, alone, g_out, total, **kw), 20)
        print(f"[{p_time}] the longest segment alone ({hi - lo} slots, "
              f"tile {t}): forward kernel {f1_ms:.3f} ms, backward kernel "
              f"{b1_ms:.3f} ms", flush=True)
    packed0 = torch.zeros_like(ker["d_packed"])
    sc_ms = time_ms(lambda: scatter_rows(ker["d_rows"], ker["index"],
                                         packed0), 20)
    if stream:
        print(f"[{p_time}] scatter-add of {ker['index'].numel()} gradient "
              f"rows, none of them padding: {sc_ms:.3f} ms", flush=True)
    else:
        # with the lists' invalid slots as bin_tiles fills them, and with
        # all of them aimed at Gaussian 0
        at_zero = torch.where(ker["valid"], ker["index"], 0)
        z_ms = time_ms(lambda: scatter_rows(ker["d_rows"], at_zero, packed0),
                       20)
        print(f"[{p_time}] scatter-add of {ker['index'].numel()} gradient "
              f"rows: {sc_ms:.3f} ms; with every invalid slot at index 0 "
              f"{z_ms:.3f} ms", flush=True)
    per_step = [x / (steps + 1) for x in launches]
    print(f"[{p_time}] launches per step: forward {per_step[0]:.2f}, "
          f"backward {per_step[1]:.2f}", flush=True)
    print(f"[{p_time}] kernel / bound: forward {f_ms / f_bound[0]:.2f}, "
          f"backward {b_ms / b_bound[0]:.2f}", flush=True)
    if stream:
        # both layouts in turns on this state and card: rounds of lists,
        # stream, stream, lists; a window of 10 steps after one warm-up
        lists = cfg._replace(settings=dataclasses.replace(
            cfg.settings, stream_train=False))
        turns = {False: [], True: []}
        it = 200
        for _ in range(TURN_ROUNDS):
            for on in (False, True, True, False):
                cf = cfg if on else lists
                train_step(cf, state, batch, bg, it, 3)         # warm-up
                turns[on].append(timed_steps(cf, state, batch, bg, 10,
                                             it + 1)[0])
                it += 11
        print(f"[{p_time}] ms/step in turns on one state, "
              f"{2 * TURN_ROUNDS} windows of 10 steps for each layout: lists "
              f"{spread(turns[False])}, stream {spread(turns[True])}; phase "
              f"8 read {list_ms:.3f} for the lists and phase 13 "
              f"{ms_step:.3f} for the stream", flush=True)
    return [
        dict(name=names[0], launches=launches[0], max_abs_err=fwd_err,
             ms=f_ms, plain_ms=fp_ms, bound_ms=f_bound[0],
             bound_by=f_bound[1]),
        dict(name=names[1], launches=launches[1],
             max_abs_err=float((ker["d_rows"] - ref["d_rows"]).abs().max()),
             ms=b_ms, plain_ms=bp_ms, bound_ms=b_bound[0],
             bound_by=b_bound[1]),
    ], ms_step


def frame_stream(settings, dcfg, gs, net, aabb, view, grid_spatial, events):
    """One lang frame split at the layer boundaries; `events` (6 CUDA
    events or None) are recorded between the stages."""
    from langsplat4d_torch.ops.composite import composite_stream
    from langsplat4d_torch.render.pipeline import prepare_attributes
    from langsplat4d_torch.render.raster import preprocess
    from langsplat4d_torch.render.stream import (gather_rows,
                                                 pack_attribute_table,
                                                 sorted_pairs)
    ev = events or [None] * 6

    def mark(i):
        if ev[i] is not None:
            ev[i].record()
    cam = view.camera_params(gs.device)
    mark(0)
    a = prepare_attributes(dcfg, "fine-lang", view.time, gs, net, aabb,
                           grid_spatial=grid_spatial)
    mark(1)
    prep = preprocess(settings, cam, a[0], a[3], a[1], a[2], a[4], None,
                      active=gs.active_mask())
    mark(2)
    keys, starts, dorder = sorted_pairs(settings, prep)
    mark(3)
    rows = gather_rows(pack_attribute_table(prep, a[5]), keys, dorder)
    mark(4)
    bg = torch.zeros(3, device=gs.device)
    img = composite_stream(
        rows, starts, bg, tiles_x=settings.tiles_x, tiles_y=settings.tiles_y,
        tile_size=settings.tile_size, height=settings.image_height,
        width=settings.image_width, hard_cutoffs=settings.hard_cutoffs)
    mark(5)
    return rows, starts, bg, img, keys.numel()


def cell_phases(dev, frames=10, **workload_kw):
    """Phase 18 on `dev` (a CPU device rehearses it at a small size with the
    plain version and times nothing): the first `frames` views of the bench
    workload through `pipeline.render` with the cell-list option, frame 0
    against the stream kernel's image and against the plain version.
    Returns the cell kernel's JSON entry."""
    from langsplat4d_torch.field.deformation import make_grid_spatial_cache
    from langsplat4d_torch.ops import composite as C
    from langsplat4d_torch.render.pipeline import render
    from langsplat4d_torch.render.raster import RasterSettings
    on_card = dev.type == "cuda"
    gs, dcfg, net, aabb, views = bench_workload(dev, frames=60,
                                                **workload_kw)
    h, w = views[0].height, views[0].width
    stream_st = RasterSettings(image_height=h, image_width=w, sh_degree=3)
    cells_st = dataclasses.replace(stream_st, cell_composite=True)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        grid_spatial = make_grid_spatial_cache(net, dcfg, aabb, gs.xyz)

        def frame(settings, view):
            return render(settings, dcfg, "fine-lang",
                          view.camera_params(dev), view.time, gs, net, aabb,
                          bg, grid_spatial=grid_spatial)

        def render_frames(settings):
            """-> (the frames' outputs, ms/frame by CUDA events)."""
            if not on_card:
                return ([frame(settings, v) for v in views[:frames]],
                        float("nan"))
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            outs = [frame(settings, v) for v in views[:frames]]
            e1.record()
            torch.cuda.synchronize()
            return outs, e0.elapsed_time(e1) / frames

        frame(cells_st, views[0])                            # warm-ups
        frame(stream_st, views[0])
        C.composite_cells.launches = 0
        outs, first_ms = render_frames(cells_st)
        launches = C.composite_cells.launches
        # both paths in turns: rounds of cells, stream, stream, cells, the
        # first window being the one above
        turns = {True: [first_ms], False: []}
        order = (False, False, True) + (True, False, False, True) * (
            (TURN_ROUNDS if on_card else 1) - 1)
        for on in order:
            turns[on].append(render_frames(cells_st if on else stream_st)[1])
        print(f"[18] pipeline.render x{frames} with the cell option, "
              f"composite_cells launches {launches}; ms/frame (CUDA events) "
              f"in turns, {len(turns[True])} windows of {frames} frames "
              f"each: cell option {spread(turns[True])}, the stream path at "
              f"16-px tiles {spread(turns[False])}", flush=True)
        if on_card and launches < frames:
            raise AssertionError(f"cell kernel launched {launches} times "
                                 f"for {frames} frames")
        for o in outs:
            for key in ("render", "language_feature_image", "depth"):
                if not torch.isfinite(o[key]).all():
                    raise AssertionError(f"{key} not finite")

        # frame 0 against the stream kernel's image at 16-px tiles
        _, _, _, img, _ = frame_stream(stream_st, dcfg, gs, net, aabb,
                                       views[0], grid_spatial, None)
        errs = {}
        for key, ref, tol in (("render", img[:3], TOL),
                              ("language_feature_image", img[3:6], TOL),
                              ("depth", img[6:7], 3e-4)):
            if outs[0][key].shape != ref.shape:
                raise AssertionError(f"{key}: shape "
                                     f"{tuple(outs[0][key].shape)}")
            errs[key] = float((outs[0][key] - ref).abs().max())
        print("[18] frame 0, cell option vs stream kernel, max abs err: "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f"; covered {float((img[-1] > 0.5).float().mean()):.3f} of "
              f"the frame", flush=True)
        if (errs["render"] > TOL or errs["language_feature_image"] > TOL
                or errs["depth"] > 3e-4):
            raise AssertionError("the cell option's frame differs from the "
                                 "stream kernel's")

        # frame 0's rows again: kernel vs plain on the whole frame, and the
        # pairs the kernel's culled scheme evaluates
        rows, cell_starts, kw = frame_cell_rows(cells_st, dcfg, gs, net, aabb,
                                                views[0], grid_spatial)
        out = C.composite_cells(rows, cell_starts, bg, **kw)
        t0 = time.perf_counter()
        ref = C.composite_cells_plain(rows, cell_starts, bg, **kw)
        if on_card:
            torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        err = float((out - ref).abs().max())
        print(f"[18] frame 0: kernel vs plain on the whole frame max abs err "
              f"{err:.3g}", flush=True)
        if not err <= TOL:
            raise AssertionError(f"cell kernel vs plain {err} > {TOL}")
        needed = cell_scheme_report(rows, cell_starts, bg, kw, ref)
        if not on_card:
            return None
        k_ms = time_ms(lambda: C.composite_cells(rows, cell_starts, bg,
                                                 **kw), 20)
    # each input read once, the output written once; the operations are the
    # blend's over the rows the kernel's scheme evaluates (the rect and tile
    # tests of the (tile, candidate) pairs are left out, so the bound is a
    # little low)
    c_bound = bound(rows.numel() * 4 + cell_starts.numel() * 4 + 12
                    + out.numel() * 4,
                    forward_ops(needed["pair_pixels"],
                                needed["live_pair_pixels"],
                                3 + dcfg.lang_dim + 1))
    print(f"[18] cell kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms; "
          f"{needed['pair_pixels']} evaluated pair-pixels of which "
          f"{needed['live_pair_pixels']} live, bound {c_bound[0]:.4f} ms by "
          f"{c_bound[1]} ({c_bound[2]}): kernel / bound "
          f"{k_ms / c_bound[0]:.2f}", flush=True)
    return dict(name="composite_cells", launches=launches, max_abs_err=err,
                ms=k_ms, plain_ms=p_ms, bound_ms=c_bound[0],
                bound_by=c_bound[1])


def frame_cell_rows(settings, dcfg, gs, net, aabb, view, grid_spatial):
    """One frame's cell rows, as the cell option builds them -> (rows,
    cell_starts, the cell kernel's keyword arguments)."""
    from langsplat4d_torch.render.pipeline import prepare_attributes
    from langsplat4d_torch.render.raster import preprocess
    from langsplat4d_torch.render.stream import bin_cells, pack_cell_rows
    dev = gs.device
    a = prepare_attributes(dcfg, "fine-lang", view.time, gs, net, aabb,
                           grid_spatial=grid_spatial)
    prep = preprocess(settings, view.camera_params(dev), a[0], a[3], a[1],
                      a[2], a[4], None, active=gs.active_mask())
    src, cell_starts = bin_cells(settings, prep)
    rows = pack_cell_rows(prep, a[5], src)
    return rows, cell_starts, dict(cells_x=settings.cells_x,
                                   cell=settings.bin_cell_tiles,
                                   tile_size=16, hard_cutoffs=True)


def cell_scheme_report(rows, cell_starts, bg, kw, ref, phase=18):
    """The cell kernel's scheme on one frame's rows, counted by its plain
    twin (`composite_cells_plain` with `cull`): a tile evaluates only the
    candidates whose rect covers it and that the tile test keeps. Prints
    the candidates, the rows covered and kept per tile and per 256-candidate
    pass of the walk (every pass, as if no pixel stopped), and the pairs
    the plain version and the scheme evaluate. Fails if the scheme's output
    is not `ref` (the plain version's) bit for bit or its live pairs
    differ. -> the scheme's stats."""
    from langsplat4d_torch.ops import composite as C
    whole, needed = {}, {}
    C.composite_cells_plain(rows, cell_starts, bg, stats=whole, **kw)
    culled = C.composite_cells_plain(rows, cell_starts, bg, cull=True,
                                     stats=needed, **kw)
    lens = (cell_starts[1:] - cell_starts[:-1]).long()
    tiles = lens.numel() * kw["cell"] ** 2
    passes = int((lens + 255).div(256, rounding_mode="floor").sum()
                 ) * kw["cell"] ** 2
    print(f"[{phase}] frame 0: {rows.shape[0]} candidates in {lens.numel()} "
          f"cells, longest list {int(lens.max())}, {needed['rect_tests']} "
          f"(tile, candidate) pairs in {passes} passes of {tiles} tiles; "
          f"rect-covered rows {needed['covered_rows']} "
          f"({needed['covered_rows'] / tiles:.1f} a tile, "
          f"{needed['covered_rows'] / passes:.1f} a pass), kept by the tile "
          f"test {needed['kept_rows']} ({needed['kept_rows'] / tiles:.1f} a "
          f"tile, {needed['kept_rows'] / passes:.1f} a pass); evaluated "
          f"pair-pixels {whole['pair_pixels']} over the covered rows, "
          f"{needed['pair_pixels']} over the kept, live "
          f"{whole['live_pair_pixels']} and {needed['live_pair_pixels']}",
          flush=True)
    if (not torch.equal(culled, ref)
            or needed["live_pair_pixels"] != whole["live_pair_pixels"]):
        raise AssertionError("the culled cell scheme drops a pair that "
                             "blends")
    return needed


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def load_build(name, tree):
    """The `ops/composite.py` of `tree` as a module of its own, which builds
    from that tree's csrc/ into that tree's _build/."""
    path = os.path.join(tree, "langsplat4d_torch", "ops", "composite.py")
    spec = importlib.util.spec_from_file_location(f"composite_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def compare_inputs(dev):
    """{label: (kernel name, row width, call(composite module) -> output)}:
    the six kernels on the inputs the main paths give them (frame 0 of the
    bench workload as a stream at 32- and 16-px tiles and as cell lists,
    step 1 of the training-step workload on both layouts, and the stream
    layout's longest segment alone: one block's walk)."""
    from langsplat4d_torch.field.deformation import make_grid_spatial_cache
    from langsplat4d_torch.render.raster import RasterSettings
    cases = {}
    gs, dcfg, net, aabb, views = bench_workload(dev)
    h, w = views[0].height, views[0].width
    with torch.no_grad():
        grid_spatial = make_grid_spatial_cache(net, dcfg, aabb, gs.xyz)
        for ts in (32, 16):
            st = RasterSettings(image_height=h, image_width=w, sh_degree=3,
                                tile_size=ts)
            rows, starts, bg, _, _ = frame_stream(
                st, dcfg, gs, net, aabb, views[0], grid_spatial, None)
            kw = dict(tiles_x=st.tiles_x, tiles_y=st.tiles_y, tile_size=ts,
                      height=h, width=w, hard_cutoffs=True)
            cases[f"composite_stream {ts}px [{rows.shape[0]} rows]"] = (
                "composite_stream", rows.shape[1],
                lambda m, a=(rows, starts, bg), kw=kw:
                m.composite_stream(*a, **kw))
        st = RasterSettings(image_height=h, image_width=w, sh_degree=3,
                            cell_composite=True)
        rows, cell_starts, kw = frame_cell_rows(st, dcfg, gs, net, aabb,
                                                views[0], grid_spatial)
        cases[f"composite_cells [{rows.shape[0]} candidates]"] = (
            "composite_cells", rows.shape[1],
            lambda m, a=(rows, cell_starts, torch.zeros(3, device=dev)),
            kw=kw: m.composite_cells(*a, **kw))
    del gs, net
    for stream in (False, True):
        state, cfg, batch, bg = train_workload(dev, stream=stream)
        step = staged_step(cfg, state, batch, bg)
        names = (("composite_stream_chunks",
                  "composite_stream_chunks_backward") if stream
                 else ("composite_tiles", "composite_tiles_backward"))
        kw = dict(tiles_x=cfg.settings.tiles_x, tile_size=16,
                  hard_cutoffs=True)
        rows, bounds = step["rows"], step["bounds"]
        extras = ((bg,), (step["g_out"], step["total"]))
        for n, extra in zip(names, extras):
            cases[f"{n} {list(rows.shape)}"] = (
                n, rows.shape[-1], lambda m, n=n, a=(rows, bounds) + extra,
                kw=kw: getattr(m, n)(*a, **kw))
        if stream:
            seg = bounds[1:] - bounds[:-1]
            t = int(seg.argmax())
            lo, hi = int(bounds[t]), int(bounds[t + 1])
            alone = torch.zeros_like(bounds)
            alone[t + 1:] = hi - lo
            rows_t = rows[lo:hi].contiguous()
            for n, extra in zip(names, extras):
                cases[f"{n} [the longest segment alone, {hi - lo} rows]"] = (
                    n, rows.shape[-1], lambda m, n=n,
                    a=(rows_t, alone) + extra, kw=kw: getattr(m, n)(*a, **kw))
        del state
    return cases


def compare_builds(specs, rounds, dev):
    """Times the six kernels of this checkout ("this") in turns with those of
    other builds, on one card in one process. A spec is NAME=TREE: TREE, a
    path under this checkout, holds `langsplat4d_torch/ops/composite.py` and
    `langsplat4d_torch/csrc/` (an unpacked `git archive` of another commit,
    or a copy with one design step changed). The inputs are made once, with
    this checkout's modules. Every round times every build's kernel (mean of
    20 launches by CUDA events) in the order given and then in the reverse
    order, so each is timed 2 * rounds times and none always follows the
    same neighbour. Prints per kernel and build the median, least and
    largest time, the largest difference from this checkout's output
    relative to the output's largest entry, and the registers at that row
    width; then the card's name and power limit. It checks nothing."""
    builds = {"this": load_build("this", REPO)}
    for spec in specs:
        name, _, tree = spec.partition("=")
        builds[name] = load_build(name, os.path.join(REPO, tree))
    for name, mod in builds.items():
        print(f"build {name}: build+load {mod.build_seconds():.2f} s",
              flush=True)
    order = list(builds) + list(builds)[::-1]
    for label, (kernel, pw, call) in compare_inputs(dev).items():
        ref = call(builds["this"])
        scale = float(ref.abs().max()) or 1.0
        times = {name: [] for name in builds}
        for _ in range(rounds):
            for name in order:
                times[name].append(time_ms(lambda m=builds[name]: call(m),
                                           20))
        print(label, flush=True)
        for name, mod in builds.items():
            diff = float((call(mod) - ref).abs().max()) / scale
            regs = kernel_resources(mod.ptxas_report(kernel))[pw][0]
            print(f"  {name:>12}: ms {spread(times[name])}; vs this "
                  f"{diff:.3g}; {regs} registers", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", action="append", default=[],
                    metavar="NAME=TREE")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not all(os.path.isfile(os.path.join(REPO, src))
               for src, _ in KERNELS.values()):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from langsplat4d_torch.ops import composite
    from langsplat4d_torch.field.deformation import make_grid_spatial_cache
    from langsplat4d_torch.render.driver import render_set
    from langsplat4d_torch.render.pipeline import binning_report
    from langsplat4d_torch.render.raster import RasterSettings
    from langsplat4d_torch.train.loop import maybe_stream_switch
    from langsplat4d_torch.train.step import train_step

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    if args.compare:
        compare_builds(args.compare, args.rounds, dev)
        print(smi)
        return 0

    # 1. build
    print(f"[1] build+load of {len(composite.KERNELS)} kernels, in "
          f"parallel: {composite.build_seconds():.2f} s", flush=True)

    # 2. kernel vs plain on synthetic segments
    errs = []
    for case in kernel_cases():
        err = compare_case(*case, device=dev)
        errs.append(err)
        print(f"[2] ts={case[0]} hard={case[1]} {case[2]}x{case[3]} "
              f"pw={case[4]} {case[5]}: max abs err {err:.3g}", flush=True)
        if not err <= TOL:
            raise AssertionError(f"kernel vs plain {err} > {TOL}")

    # 3. the main path: render_set on the bench workload
    gs, dcfg, net, aabb, views = bench_workload(dev)
    out_root = os.path.join(REPO, "langsplat4d_torch", "_build", "smoke")
    shutil.rmtree(out_root, ignore_errors=True)
    cfg = types.SimpleNamespace(
        model=types.SimpleNamespace(model_path=out_root,
                                    white_background=False),
        runtime=types.SimpleNamespace(render_tile_size=RENDER_TILE_SIZE,
                                      nonormalized=False))
    model = types.SimpleNamespace(gaussians=gs, deform=net, aabb=aabb,
                                  active_sh_degree=3)
    composite.composite_stream.launches = 0
    t0 = time.perf_counter()
    fps = render_set(cfg, model, dcfg, None, "video", 0, views, mode="lang",
                     load_stage="fine-lang", noimage=False, nonpy=False,
                     novideo=True)
    launches = composite.composite_stream.launches
    print(f"[3] render_set: {len(views)} frames, FPS {fps:.3f}, "
          f"{time.perf_counter() - t0:.1f} s with writes; "
          f"composite_stream launches {launches}", flush=True)
    if launches < len(views):
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{len(views)} frames")

    # 4. per-stage device times
    settings = RasterSettings(image_height=views[0].height,
                              image_width=views[0].width, sh_degree=3,
                              tile_size=RENDER_TILE_SIZE)
    with torch.no_grad():
        grid_spatial = make_grid_spatial_cache(net, dcfg, aabb, gs.xyz)
        names = ("deform", "preprocess", "emit+sort", "gather", "composite")
        tot = dict.fromkeys(names, 0.0)
        n_stage = 10
        for i in range(n_stage + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            frame_stream(settings, dcfg, gs, net, aabb, views[i],
                         grid_spatial, ev)
            torch.cuda.synchronize()
            if i:                                    # frame 0 warms up
                for j, n in enumerate(names):
                    tot[n] += ev[j].elapsed_time(ev[j + 1]) / n_stage
        print("[4] per-stage ms (CUDA events, mean of frames 1-10): "
              + ", ".join(f"{n} {tot[n]:.3f}" for n in names), flush=True)

        # 5. frame 0: kernel vs plain, vs render_set's output; timings
        timing = {}
        for ts in (RENDER_TILE_SIZE, 16):
            st = RasterSettings(image_height=views[0].height,
                                image_width=views[0].width, sh_degree=3,
                                tile_size=ts)
            rows, starts, bg, img, emitted = frame_stream(
                st, dcfg, gs, net, aabb, views[0], grid_spatial, None)
            kw = dict(tiles_x=st.tiles_x, tiles_y=st.tiles_y, tile_size=ts,
                      height=st.image_height, width=st.image_width,
                      hard_cutoffs=True)
            stats = {}
            ref = composite.composite_stream_plain(rows, starts, bg,
                                                   stats=stats, **kw)
            torch.cuda.synchronize()
            if img.shape != (9, 1014, 1352) or not torch.isfinite(img).all():
                raise AssertionError(f"bad frame {tuple(img.shape)}")
            err = float((img - ref).abs().max())
            errs.append(err)
            valid = int(starts[-1])
            print(f"[5] frame 0 ts={ts}: emitted pairs {emitted}, valid "
                  f"pairs {valid}, kernel vs plain max abs err {err:.3g}",
                  flush=True)
            if not err <= TOL:
                raise AssertionError(f"frame 0 kernel vs plain {err} > {TOL}")
            if ts == RENDER_TILE_SIZE:
                saved = np.load(os.path.join(out_root, "video_lang", "ours_0",
                                             "renders_npy", "00000.npy"))
                lang = img[3:6].permute(1, 2, 0).cpu().numpy()
                d = float(np.abs(saved - lang).max())
                print(f"[5] render_set frame 0 vs recomputed: {d:.3g}",
                      flush=True)
                if not d <= TOL:
                    raise AssertionError(f"render_set frame 0 differs {d}")
            k_ms = time_ms(lambda: composite.composite_stream(
                rows, starts, bg, **kw), 20)
            p_ms = time_ms(lambda: composite.composite_stream_plain(
                rows, starts, bg, **kw), 1)
            needed = stats
            if ts == 2 * composite.QUAD:
                # The plain version evaluates every row of a 32-px tile at
                # all of its 1024 pixels. The same image, bit for bit, comes
                # from evaluating a row only in the 16x16 quadrants that the
                # kernel's test keeps for it, so those pairs, counted here by
                # the plain twin of that scheme, are what the function needs:
                # the bound charges them and not the plain version's count.
                needed = {}
                q_img = composite.composite_stream_quadrants_plain(
                    rows, starts, bg, stats=needed, **kw)
                q_err = float((q_img - ref).abs().max())
                print(f"[5] ts={ts}: the plain version evaluates "
                      f"{stats['pair_pixels']} pair-pixels; by quadrants the "
                      f"kernel stages {needed['staged_rows']} of "
                      f"{needed['quadrant_tests']} (row, quadrant) pairs "
                      f"and evaluates {needed['pair_pixels']} pair-pixels "
                      f"of which {needed['live_pair_pixels']} live; the "
                      f"plain quadrant scheme vs plain max abs err "
                      f"{q_err:.3g}", flush=True)
                if (q_err > TOL or needed["live_pair_pixels"]
                        != stats["live_pair_pixels"]):
                    raise AssertionError("the quadrant scheme drops a pair "
                                         "that blends")
            pw = rows.shape[1]
            s_bound = bound(
                valid * pw * 4 + starts.numel() * 4 + 12 + img.numel() * 4,
                forward_ops(needed["pair_pixels"], needed["live_pair_pixels"],
                            3 + dcfg.lang_dim + 1))    # rgb, language, depth
            timing[ts] = (k_ms, p_ms, s_bound)
            print(f"[5] ts={ts}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms; "
                  f"{needed['pair_pixels']} pair-pixels to evaluate of which "
                  f"{needed['live_pair_pixels']} live, bound "
                  f"{s_bound[0]:.4f} ms by {s_bound[1]} ({s_bound[2]}): "
                  f"kernel / bound {k_ms / s_bound[0]:.2f}", flush=True)
    shutil.rmtree(out_root, ignore_errors=True)
    del gs, net, views, rows, starts, img, ref
    torch.cuda.empty_cache()

    # 6. the kernels' resources, one line pair per row width 32, 24, 16,
    # and the blocks an SM holds of each; no kernel may spill
    for name in composite.KERNELS:
        log = composite.ptxas_report(name)
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[6] {name}: {line.strip()}", flush=True)
        res = kernel_resources(log)
        if sorted(res) != sorted(composite.SUPPORTED_ROW_WIDTHS):
            raise AssertionError(f"{name}: no ptxas figures for row widths "
                                 f"{composite.SUPPORTED_ROW_WIDTHS}")
        print(f"[6] {name}: resident blocks per SM at row widths "
              + ", ".join(f"{pw}: {res[pw][3]}" for pw in sorted(res)),
              flush=True)
        if any(r[2] for r in res.values()):
            raise AssertionError(f"{name} spills registers")

    # 7. the tile-list kernels vs plain on synthetic lists
    for hard, pw in list_cases():
        f_err, b_err, b_excess = compare_list_case(hard, pw, dev)
        print(f"[7] hard={hard} pw={pw}: forward max abs err {f_err:.3g}, "
              f"backward max abs err {b_err:.3g}, excess over rtol "
              f"{GRAD_TOL['rtol']} / atol {GRAD_TOL['atol']}: "
              f"{b_excess:.3g}", flush=True)
        if not f_err <= TOL:
            raise AssertionError(f"forward kernel vs plain {f_err} > {TOL}")
        if not b_excess <= 0:
            raise AssertionError("backward kernel vs plain beyond the "
                                 "gradient bound")

    # 8-11. the training path
    entries, list_ms = train_phases(dev)

    k_ms, p_ms, s_bound = timing[RENDER_TILE_SIZE]
    entries.insert(0, dict(
        name="composite_stream", launches=launches, max_abs_err=max(errs),
        ms=k_ms, plain_ms=p_ms, bound_ms=s_bound[0], bound_by=s_bound[1]))

    # 12. the stream-layout training kernels vs plain on synthetic segments
    for hard, pw in segment_cases():
        f_err, b_err, b_excess = compare_segment_case(hard, pw, dev)
        print(f"[12] hard={hard} pw={pw}: forward max abs err {f_err:.3g}, "
              f"backward max abs err {b_err:.3g}, excess over rtol "
              f"{GRAD_TOL['rtol']} / atol {GRAD_TOL['atol']} of each "
              f"column's largest entry: {b_excess:.3g}", flush=True)
        if not f_err <= TOL:
            raise AssertionError(f"forward kernel vs plain {f_err} > {TOL}")
        if not b_excess <= 0:
            raise AssertionError("backward kernel vs plain beyond the "
                                 "gradient bound")

    # 13-15. the training path on the stream layout
    stream_entries, stream_ms = train_phases(dev, stream=True,
                                             list_ms=list_ms)
    entries += stream_entries

    # 16. the loop's switch on the workload's state
    state, cfg, _, _ = train_workload(dev)
    sat = binning_report(cfg.settings, train_camera().camera_params(dev),
                         state.gaussians())
    switched = maybe_stream_switch(cfg.settings, state, [train_camera()])
    print(f"[16] undeformed Gaussians: {sat['tile_full_frac']:.4f} of the "
          f"tile lists full at capacity {cfg.settings.tile_capacity}, "
          f"longest list {int(sat['tile_max_count'])}; maybe_stream_switch "
          f"-> stream_train={getattr(switched, 'stream_train', None)}",
          flush=True)
    if switched is None or not switched.stream_train:
        raise AssertionError("maybe_stream_switch did not choose the stream "
                             "layout")
    del state, cfg
    torch.cuda.empty_cache()

    # 17. the cell kernel vs plain on synthetic cells
    for hard, pw, kind in cell_cases():
        err = compare_cell_case(hard, pw, kind, dev)
        print(f"[17] hard={hard} pw={pw} {kind}: max abs err {err:.3g}",
              flush=True)
        if not err <= TOL:
            raise AssertionError(f"cell kernel vs plain {err} > {TOL}")

    # 18. the cell-list render option
    entries.append(cell_phases(dev))

    # 11, and 15's: the profiles of the two training steps
    for stream, ms_step, phase in ((False, list_ms, 11),
                                   (True, stream_ms, 15)):
        state, cfg, batch, bg = train_workload(dev, stream=stream)
        train_step(cfg, state, batch, bg, 1, 3)                 # warm-up
        profile_steps(cfg, state, batch, bg, ms_step, phase=phase)
    print(json.dumps({"kernels": [
        dict(e, route="cuda", source=KERNELS[e["name"]][0],
             replaces=KERNELS[e["name"]][1], library_ms=None)
        for e in entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
