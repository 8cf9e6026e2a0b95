#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (langsplat4d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare NAME=TREE [--compare ...] [--rounds 3]
    python3 chip_smoke.py --only 25,26,27,28,29

Run from the root of a checkout, on a machine with one CUDA GPU and nvcc.
With --compare it checks nothing and only times the six kernels of this
checkout in turns with those of other builds (see `compare_builds`).
Phases, each failing the run on error:
  1. build the six compositor kernels and the plane-gradient kernel from
     csrc/ with nvcc, one nvcc per source, all started together, and the
     host image codec (csrc/imgcodec.cpp) with c++ beside them;
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
     kernel fails, and so does a stack frame (an array in local memory) in
     the plane-gradient kernel's functions;
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
     pairs;
 19. a HyperNeRF scene on disk, written with the port's own writers: 48
     frames at 960x536 on a quarter orbit, rendered from 200k seeded
     Gaussians, a 100k-point initial cloud, language ground truth of 32
     segments with seeded 512-d "CLIP" features; read back through the
     port's Scene, every decoded image equal to the array written;
 22. (run after 19, before 20) the language autoencoder at full width
     through `langsplat4d_torch.ae.train` and `.ae.test` (their `main`):
     encoder 256-128-64-32-3, decoder 16-32-64-128-256-256-512, on the
     scene's 512-d features, 200 epochs; the export,
     `language_features_dim3`, is what phase 20 trains on; ms per train
     batch, the eval loss, the export's rows/s;
 20. training(cfg) on that scene with configs/hypernerf/default.py at full
     width, the depth cuts printed (300/100/300/100 iterations, densify,
     prune and opacity reset firing in both base stages): it/s, wall time
     and CUDA-event step times per stage beside phase 8's step-only it/s,
     num_active after each densification event, the stream switch, the
     batch build's first-epoch and cached times, peak memory; the training
     kernels' launches must equal the camera renders of the steps, and the
     fine-base loss of its last 10 iterations must be at most 0.6x that of
     its first 10; then save_scene, load_trained_model and render_set of 10
     frames of the saved model, whose frame 0 the render kernel must
     composite as its plain version does on the same rows;
 21. the plane-gradient kernel (csrc/plane_grad.cu, the HexPlane sample's
     backward) against its plain version on synthetic planes (points
     spread, on one row, in one cell, a GaussianState's padding, the
     loop's time plane with its padding; 4-32 channels) within the
     gradient bound, two calls bit-equal, and so on the loop's first
     time-plane call, where it is timed beside aten's backward and beside
     PyTorch's sorting scatter (`index_put_`) on the rows with a gradient;
     then the
     first 5 coarse-base iterations of the loop with the kernels and
     with their plain versions: every step's gradients and the Adam
     moments held to rtol 2e-3 / atol 2e-4 of each leaf's largest entry,
     parameters too where the gradient is at least a tenth of the leaf's
     largest and elsewhere within what that bound allows through Adam's
     steps; two identical runs of 5 iterations of coarse-base,
     coarse-lang and fine-base with the loop's deterministic setting (all
     four stages): the largest difference per leaf, which must be 0; 10
     iterations of coarse-base and of fine-base with the deterministic
     algorithms on and off, in turns, and of fine-base as the loop runs it
     against its run with aten's grid_sample backward and the
     deterministic algorithms off, and against its runs with the plane
     gradient through `index_put_`; the DenseGrid's backward (`empty_voxel`:
     the same segmented sums over eight corners) against its plain
     version, two calls bit-equal, and two identical fine-base runs with
     `empty_voxel` on, bit-equal;
 23. evaluation of phase 20's saved model: render_set in lang mode over 8
     video frames through the render kernel (the first held against the
     plain version on its rows) with the ground-truth maps; COCO
     annotations of the 6 largest segments (convex hulls, scipy) and a
     text cache of their 512-d features; `python -m langsplat4d_torch.eval`
     (its `main`) with the renders as levels 1-3: Mean IoU, CUDA-event ms
     a frame of the AE decode, the relevancy, the smoothing and threshold +
     IoU, the eval's s/frame; the first frame's relevancy maps against the
     plain CPU computation (1e-5); the video helpers at full width (a
     seeded 4096-d VAE decoder on a seeded [536, 960, 6] map);
 24. scripts/train_eval.sh's flow through the port's CLIs on that scene:
     `python -m langsplat4d_torch.train` (phase A: the preset at full
     width, a third of phase 20's stage budgets (CLI_STAGE_ITERS) with
     its densification cuts, fine-lang 0, a checkpoint at fine-base's
     last iteration, the render-process snapshots, the debug grid and the
     viewer bridge answering one request; phase B: the discrete
     fine-lang-discrete stage resumed from that checkpoint, cut to 200
     iterations), `.render` in lang mode at fine-lang-discrete over the
     video split (frame 0 held against the plain version on its rows),
     `.eval` on those renders; then prepare_discrete_stage in both modes on
     phase 20's saved state, its K-Means held against the plain version;
     last, phase A three more times, without, without and with the
     snapshots, for its it/s with and without them in turns;
 25. the port's image codec (csrc/imgcodec.cpp, host C++) against its
     numpy twins on inputs the phase writes itself: PNGs in every row
     filter, a per-row mix and libpng's adaptive choice, in grey, grey +
     alpha, RGB and RGBA; JPEGs of the port's encoder at quality 75 and
     95, with and without restart intervals; PIL's resample in its four
     filters, down and up, RGB and RGBA: byte for byte; then the codec's
     and the twins' ms per 1352x1014 frame (a PNG of Paeth rows, one of
     adaptive rows, a JPEG, a lanczos resample from 2704x2028);
 26. Neu3D at full width through the CLIs: a dynerf scene of 6 cameras x
     20 frames at the reader's 1352x1014 (adaptive-filter PNGs rendered
     from phase 3's 200k Gaussians with Neu3D's deformation, 100k initial
     points, 3-d language ground truth under the names the loader asks
     for), `python -m langsplat4d_torch.train` with configs/neu3d/default.py
     at full width (batch 4) at 200/60/200/60 iterations with phase 20's
     densification cuts, `.render --mode
     lang` over the test split (frame 0 held against the plain version on
     its rows), `.eval --dataset_type neu3d` on test_lang; it/s per stage,
     decode ms a frame, the batch build on misses against hits, and
     fine-base in turns at the default 4096 MB GT cache and at 256 MB;
 27. the other formats: Blender, COLMAP (JPEG frames) and MultipleView
     scenes written tiny and trained a few iterations through
     `training(cfg)` (kernels 1 and 2 must launch, the loss finite), and a
     PanopticSports scene (JPEG frames, an off-centre principal point) read
     and rendered through `render_set` and kernel 3, frame 0 held against
     the plain version;
 28. (run after 24) the multi-rank path, langsplat4d_torch/parallel/, with
     its ranks spawned on this one card under gloo (NCCL refuses two ranks
     on one device; they take turns on the card, so nothing here is a
     speed-up): kernel 3 in tile-row bands (`tile_row0`) on synthetic
     streams against its plain version and bit-equal to the whole image's
     launch; the bench workload's first 10 frames through render_set with
     gaussian_shards 2 and 3 (an uneven 11/11/10 split of 32 tile rows) in
     both exchanges, rank 0's stitched frames bit-equal to the one-process
     render_set's, kernel 3 launched once a band a frame and its first
     band held against the plain version, per-rank ms a frame by stage,
     the bytes each rank sends and its peak memory; both exchanges on a
     world of one rank under NCCL, bit-equal; phase 8's step workload with
     two cameras on a data 2 x gauss 2 mesh for 20 steps, after each the
     gathered parameters and Adam moments held against the one-process
     step (rtol 2e-3 / atol 2e-4 of each leaf's largest entry), kernels 1
     and 2 of the first step against their plain versions, then densify
     and prune under the mesh against one process; last, the train CLI
     under `torch.distributed.run` on 2 ranks with gaussian_shards 2 on
     phase 19's scene (MESH_CLI_ITERS), and the render CLI on 2 ranks,
     every frame bit-equal to the one-process render CLI's;
 29. (run after 27) the offline preprocessing, langsplat4d_torch/
     preprocess/, on 8 frames at HyperNeRF's 960x536 (rgb/2x) with 4-level
     mask stacks of 100/75/50/30 segments and id maps, written by the
     phase: masks_update on ~100 SAM-style candidates a level and frame
     (segments, shifted near-duplicates, eroded contained masks, unions),
     process_sequence with a seeded 512-d stand-in encoder (a fixed linear
     map of the tiles), process_frames for every object id,
     generate_captions with a stand-in captioner, encode_feature and
     assemble_final_features with a seeded 4096-d stand-in embedder, then
     `langsplat4d_torch.ae.train` (5 epochs) and `.ae.test` on the written
     *_f.npy; every stage again with device="cpu" in this process: NMS
     indices, tiles, seg maps, prompt PNGs and video-feature files equal,
     the fp16 features within 1e-3; ms a frame per stage.
Prints one JSON line describing the kernels (each with its time beside the
least time the card could take for the same work, and its launches in
phase 20's loop as `loop_launches`, in phase 23's render as
`eval_launches`, in phase 24's CLIs as `cli_launches`, in phase 26's as
`neu3d_launches`, and in phase 28's bands as `band_launches` and sharded
steps as `mesh_launches`, summed over the ranks), the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Imports nothing
of JAX or of the JAX package. `--only 25,26,27,28,29` runs the build and
those phases alone (26 and 28 with 19 and 22) and prints no kernels line.
"""
import argparse
import contextlib
import copy
import dataclasses
import functools
import hashlib
import importlib.util
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time

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
    # not a TPU kernel: the backward of the HexPlane's plane sample, which
    # the JAX package leaves to jax.grad (XLA's deterministic scatter-add)
    "plane_grad": ("langsplat4d_torch/csrc/plane_grad.cu",
                   "langsplat4d/ops/grid_sample.py:13"),
    # the same library's segmented sums over the DenseGrid's eight corners:
    # the backward of dense_grid_query, which the JAX package leaves to
    # jax.grad
    "dense_grid_grad": ("langsplat4d_torch/csrc/plane_grad.cu",
                        "langsplat4d/field/hexplane.py:73"),
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


def demangled(symbol):
    """A kernel's name from its mangled symbol: the last component of
    its nested name (`_ZN<len><namespace><len><name>...`), with an integer
    template argument as `<16>`."""
    if not symbol.startswith("_ZN"):
        return symbol
    i, name = 3, symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        n = int(symbol[i:j])
        name, i = symbol[j:j + n], j + n
    t = re.match(r"ILi(\d+)E", symbol[i:])
    return name + (f"<{t.group(1)}>" if t else "")


def function_resources(log):
    """{function: (registers, stack-frame bytes, spilled bytes)} of every
    entry function in a build log, named as `chunk_sums<16>`."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = demangled(m.group(1))
            found[name] = [0, 0, 0]
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            found[name][1] = int(m.group(1))
            found[name][2] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in found.items()}


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
    from langsplat4d_torch.config import Config
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
                     lr_cfg=LRConfig.from_optim(Config().optim, 1.0),
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
    # the plain versions take seconds: each is timed on one call, the one
    # whose result is used (no warm-up)
    fp_ms, plain_out = once_ms(lambda: fwd_plain(rows, bounds, bg,
                                                 stats=stats, **kw))
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
    b_ms = time_ms(lambda: bwd(rows, bounds, g_out, total, **kw), 20)
    bp_ms, _ = once_ms(lambda: bwd_plain(rows, bounds, g_out, total, **kw))
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


# the scene on disk and the training loop (phases 19 to 21)
LOOP_STAGE_ITERS = (300, 100, 300, 100)  # the preset's: 3000/1000/10000/10000
# densify and prune fire at iterations 200 and 300 of both base stages, the
# opacity reset once in each, at 200: both base stages count iterations from
# 1, so any interval of 151-299 fires exactly once in each, and at 250 the
# reset's recovery fills the last 10 iterations of fine-base, which the
# loss check reads (PERF.md, section 6)
LOOP_CUTS = dict(densify_from_iter=100, densification_interval=100,
                 pruning_from_iter=100, min_points_for_prune=50_000,
                 opacity_reset_interval=200)
N_FEATURES = 32        # the language ground truth's segment features
CLIP_DIM = 512         # their width on disk: a CLIP ViT-B/16 feature's


def write_scene(root, dev, frames=48, hw=(536, 960), n_true=200_000,
                n_init=100_000, seed=19):
    """Phase 19's writer: a HyperNeRF (nerfies) scene in `root`, written
    with the port's own writers. `frames` views of a seeded
    `realistic_gaussians(n_true)` set on a quarter orbit (radius 4.5, the
    bench's), time = frame / (frames - 1), rendered by the port on `dev` at
    `hw` (the rgb/2x size of a HyperNeRF vrig capture at 960x536); the
    initial cloud is a seeded subset of `n_init` true centres with noise and
    their colours; each true Gaussian carries one of 32 seeded unit 3-d
    features, that of the nearest of 32 seeded positions, and `_s.npy`
    holds, at every level, the per-pixel argmax of the rendered language
    image against the 32 features (-1 where the image's norm is under 0.2).
    `_f.npy` holds the 32 segments' features as the reference lays them
    out, at CLIP's width: seeded unit 512-d vectors, drawn from a generator
    of their own so that the pictures are those of the earlier runs.
    Returns {frame id: the uint8 image written}."""
    from concurrent.futures import ThreadPoolExecutor
    from langsplat4d_torch.core.sh import C0
    from langsplat4d_torch.core.transforms import focal2fov
    from langsplat4d_torch.data.cameras import HostCamera
    from langsplat4d_torch.data.png import png_bytes
    from langsplat4d_torch.data.readers import store_ply
    from langsplat4d_torch.field.deformation import (DeformConfig,
                                                     DeformNetwork)
    from langsplat4d_torch.render.driver import to8b
    from langsplat4d_torch.render.pipeline import render
    from langsplat4d_torch.render.raster import RasterSettings
    from langsplat4d_torch.utils.synth import realistic_gaussians
    rng = np.random.default_rng(seed)
    clip = np.random.default_rng(seed + 1).normal(size=(N_FEATURES, CLIP_DIM))
    clip = (clip / np.linalg.norm(clip, axis=1, keepdims=True)).astype(
        np.float32)
    H, W = hw
    gs = realistic_gaussians(n_true, lang_dim=3, seed=seed, device=dev)
    feats = rng.normal(size=(N_FEATURES, 3)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    anchors = torch.from_numpy(rng.uniform(-1.2, 1.2, size=(N_FEATURES, 3))
                               .astype(np.float32)).to(dev)
    near = torch.cdist(gs.xyz, anchors).argmin(1)
    f_dev = torch.from_numpy(feats).to(dev)
    gs.language_feature = torch.where(gs.active_mask()[:, None], f_dev[near],
                                      0.0)
    os.makedirs(os.path.join(root, "camera"), exist_ok=True)
    os.makedirs(os.path.join(root, "rgb", "2x"), exist_ok=True)
    lf_dir = os.path.join(root, "language_features")
    os.makedirs(lf_dir, exist_ok=True)
    ids = [f"{i:06d}" for i in range(frames)]
    for name, obj in (
            ("dataset.json", {"ids": ids, "val_ids": [], "train_ids": ids}),
            ("metadata.json", {iid: {"camera_id": 0, "warp_id": i,
                                     "appearance_id": 0}
                               for i, iid in enumerate(ids)}),
            ("scene.json", {"near": 0.1, "far": 10.0, "scale": 1.0,
                            "center": [0.0, 0.0, 0.0]})):
        with open(os.path.join(root, name), "w") as f:
            json.dump(obj, f)
    focal = 2 * (W / 2) / np.tan(0.5)     # full-resolution focal: fovx 1.0
    settings = RasterSettings(image_height=H, image_width=W, sh_degree=3)
    net = DeformNetwork(DeformConfig(), torch.Generator().manual_seed(seed))
    aabb = torch.tensor([[2.6] * 3, [-2.6] * 3], device=dev)
    bg = torch.ones(3, device=dev)       # the presets' white background
    written, pngs = {}, []
    for i, iid in enumerate(ids):
        ang = 0.5 * np.pi * i / (frames - 1)
        c = np.array([4.5 * np.sin(ang), 0.0, -4.5 * np.cos(ang)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        r_w2c = np.stack([x, np.cross(z, x), z])
        with open(os.path.join(root, "camera", f"{iid}.json"), "w") as f:
            json.dump({"orientation": r_w2c.tolist(), "position": c.tolist(),
                       "focal_length": focal,
                       "principal_point": [W, H], "skew": 0.0,
                       "pixel_aspect_ratio": 1.0,
                       "image_size": [2 * W, 2 * H]}, f)
        cam = HostCamera(R=r_w2c.T, T=-c @ r_w2c.T,
                         fovx=focal2fov(focal / 2, W),
                         fovy=focal2fov(focal / 2, H), width=W, height=H)
        t = i / (frames - 1)
        with torch.no_grad():
            out = render(settings, DeformConfig(), "coarse-lang",
                         cam.camera_params(dev), t, gs, net, aabb, bg)
            lang = out["language_feature_image"]            # [3, H, W]
            seg = torch.einsum("chw,kc->khw", lang, f_dev).argmax(0)
            seg = torch.where(lang.norm(dim=0) < 0.2, -1, seg)
        img = to8b(out["render"].cpu().numpy()).transpose(1, 2, 0)
        written[iid] = np.ascontiguousarray(img)
        rid = i + 1       # train, test and video cameras all read frame + 1
        np.save(os.path.join(lf_dir, f"{rid:06d}_s.npy"),
                np.stack([seg.to(torch.int16).cpu().numpy()] * 4))
        np.save(os.path.join(lf_dir, f"{rid:06d}_f.npy"), clip)
        pngs.append((os.path.join(root, "rgb", "2x", f"{iid}.png"),
                     written[iid]))

    def write_png(item):
        with open(item[0], "wb") as f:
            f.write(png_bytes(item[1]))
    with ThreadPoolExecutor() as ex:
        list(ex.map(write_png, pngs))
    n = gs.num_active
    pick = np.sort(rng.choice(n, size=min(n_init, n), replace=False))
    xyz = gs.xyz[:n].cpu().numpy()[pick]
    xyz = xyz + rng.normal(0.0, 0.01, size=xyz.shape).astype(np.float32)
    rgb = np.clip(gs.features_dc[:n, 0].cpu().numpy()[pick] * C0 + 0.5, 0, 1)
    store_ply(os.path.join(root, "points3D_downsample2.ply"), xyz,
              np.round(rgb * 255.0))
    return written


def scene_phase(dev, root, **kw):
    """Phase 19: write the scene and read it back through the port's Scene;
    every decoded image must equal the uint8 array written. Prints the
    decode time per image, of the files written (filter None) and of one
    image re-encoded with the Paeth filter on every row."""
    from langsplat4d_torch.data.png import decode_png, png_bytes, read_png
    from langsplat4d_torch.data.scene import Scene
    t0 = time.perf_counter()
    written = write_scene(root, dev, **kw)
    write_s = time.perf_counter() - t0
    scene = Scene(root)
    cams = scene.getVideoCameras()
    t0 = time.perf_counter()
    for i in range(len(cams)):
        cams[i].image
    decode_ms = (time.perf_counter() - t0) / len(cams) * 1e3
    for i in range(len(cams)):
        cam = cams[i]
        raw = read_png(cam.image_path)
        want = written[os.path.splitext(cam.image_name)[0]]
        if not (np.array_equal(raw, want) and np.array_equal(
                cam.image, want.transpose(2, 0, 1).astype(np.float32)
                / np.float32(255.0))):
            raise AssertionError(f"{cam.image_name} decodes differently")
    first = next(iter(written.values()))
    data = png_bytes(first, 4)          # Paeth, PIL's usual choice
    t0 = time.perf_counter()
    back = decode_png(data)
    paeth_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(back, first):
        raise AssertionError("the Paeth image decodes differently")
    h, w = first.shape[:2]
    print(f"[19] scene written in {write_s:.1f} s: {len(written)} frames at "
          f"{w}x{h}, {len(scene.point_cloud.points)} initial points, "
          f"splits train {len(scene.getTrainCameras())} / test "
          f"{len(scene.getTestCameras())} / video {len(cams)}; extent "
          f"{scene.cameras_extent:.4f}; every decoded image equals the "
          f"array written; decode {decode_ms:.2f} ms/image (load_image, "
          f"filter None), {paeth_ms:.1f} ms for one image with the Paeth "
          f"filter on every row", flush=True)
    return scene


def loop_config(root, model_path, iters=LOOP_STAGE_ITERS, cuts=LOOP_CUTS,
                hidden=None, quiet=False):
    """configs/hypernerf/default.py through the port's config loader, on the
    scene at `root` and its language features as phase 22 exports them,
    with the depth cuts (each printed on a line of its own). `hidden`
    overrides deformation fields (a CPU rehearsal narrows the network with
    it; the card runs the preset's widths)."""
    from langsplat4d_torch.config import (Config, apply_overrides,
                                          load_py_config)
    cfg = Config()
    apply_overrides(cfg, load_py_config(os.path.join(
        REPO, "configs", "hypernerf", "default.py")))
    cfg.model.source_path = root
    cfg.model.model_path = model_path
    cfg.model.language_features_name = f"language_features_dim{AE_ENC[-1]}"
    cfg.model.feature_level = 1
    cfg.runtime.watchdog_execv = False      # a trip fails the run
    # the preset's render-process snapshots are phase 24's, through the
    # train CLI, which prints their cost beside these phases' it/s
    cfg.model.render_process = False
    cfg.extras.test_iterations = []
    cfg.extras.save_iterations = []
    cfg.extras.checkpoint_iterations = []
    names = ("coarse_base_iterations", "coarse_lang_iterations",
             "fine_base_iterations", "fine_lang_iterations")
    for k, v in list(zip(names, iters)) + list(cuts.items()):
        if not quiet:
            print(f"[20] depth cut: optim.{k} {getattr(cfg.optim, k)} -> "
                  f"{v}", flush=True)
        setattr(cfg.optim, k, v)
    for k, v in (hidden or {}).items():
        setattr(cfg.hidden, k, v)
    return cfg


class LoopProbe:
    """Wraps the loop's train_step_packed, build_batch,
    scene_reconstruction, maybe_stream_switch and the densification
    functions while it is entered: CUDA events around every step (nothing
    is synchronised until the end), the step losses as tensors, the host
    time of every batch build with whether it missed the GT cache, the wall
    time of every stage, and `events`: (stage, iteration, what, num_active
    after it) for each densify, prune, grow, opacity reset and stream
    switch."""
    DENSIFY = dict(densify="densify", prune="prune", grow="grow",
                   reset_opacity="reset")

    def __init__(self, dev):
        from langsplat4d_torch.train import loop
        self.loop, self.dev = loop, dev
        self.steps, self.builds, self.stages, self.events = [], [], [], []
        self.stage, self.iteration, self.eval_renders = None, 0, 0

    def __enter__(self):
        from langsplat4d_torch.data import gt_cache
        loop, on_card = self.loop, self.dev.type == "cuda"
        self.saved = (loop.train_step_packed, loop.build_batch,
                      loop.scene_reconstruction, loop.maybe_stream_switch,
                      loop.eval_step)
        self.saved_d = {n: getattr(loop.D, n) for n in self.DENSIFY}
        step, build, stage_fn, switch, eval_step = self.saved

        def recorded(name, what):
            fn = self.saved_d[name]

            def wrapped(*a, **k):
                out = fn(*a, **k)
                st = out[0] if isinstance(out, tuple) else out
                self.events.append((self.stage, self.iteration, what,
                                    st.num_active))
                return out
            return wrapped
        for name, what in self.DENSIFY.items():
            setattr(loop.D, name, recorded(name, what))

        def probed_switch(settings, state, cams, iteration=0):
            out = switch(settings, state, cams, iteration)
            if out is not None:
                self.events.append((self.stage, iteration, "stream_switch",
                                    state.num_active))
            return out

        def timed_step(cfg, *a, **k):
            ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  if on_card else None)
            if ev:
                ev[0].record()
            out = step(cfg, *a, **k)
            if ev:
                ev[1].record()
            self.steps.append((cfg.stage, len(a[1]), ev, out[1]["loss"]))
            self.iteration += 1
            return out

        def timed_build(cams, cfg, *a, **k):
            cache = gt_cache.get_cache(cfg.runtime.gt_cache_mb, self.dev)
            misses = cache.misses
            t0 = time.perf_counter()
            out = build(cams, cfg, *a, **k)
            self.builds.append((time.perf_counter() - t0,
                                cache.misses > misses))
            return out

        def timed_stage(cfg, scene, state, dcfg, stage, *a, **k):
            self.stage, self.iteration = stage, 0
            t0 = time.perf_counter()
            out = stage_fn(cfg, scene, state, dcfg, stage, *a, **k)
            if on_card:
                torch.cuda.synchronize()
            self.stages.append((stage, a[1], time.perf_counter() - t0))
            return out
        def counted_eval(*a, **k):
            self.eval_renders += 1
            return eval_step(*a, **k)
        loop.train_step_packed, loop.build_batch = timed_step, timed_build
        loop.scene_reconstruction = timed_stage
        loop.maybe_stream_switch = probed_switch
        loop.eval_step = counted_eval
        return self

    def __exit__(self, *exc):
        (self.loop.train_step_packed, self.loop.build_batch,
         self.loop.scene_reconstruction, self.loop.maybe_stream_switch,
         self.loop.eval_step) = self.saved
        for name, fn in self.saved_d.items():
            setattr(self.loop.D, name, fn)

    def losses(self, stage):
        return [float(s[3]) for s in self.steps if s[0] == stage]

    def step_ms(self, stage):
        return [s[2][0].elapsed_time(s[2][1]) for s in self.steps
                if s[0] == stage and s[2]]


class FirstComposite:
    """Keeps the inputs and output of the render kernel's first call while
    it is entered (render_set's warm-up renders the first view), to hold it
    against composite_stream_plain on the same rows afterwards."""

    def __enter__(self):
        from langsplat4d_torch.render import raster
        self.raster, self.first = raster, []
        self.kernel = raster.composite_stream

        def kept(rows, starts, bg, **kw):
            img = self.kernel(rows, starts, bg, **kw)
            if not self.first:
                self.first.append((rows, starts, bg, kw, img))
            return img
        raster.composite_stream = kept
        return self

    def __exit__(self, *exc):
        self.raster.composite_stream = self.kernel

    def hold(self, phase, what):
        """max |kernel - plain| on the kept rows, printed; fails past TOL."""
        from langsplat4d_torch.ops import composite as C
        rows, starts, bg, kw, img = self.first[0]
        with torch.no_grad():
            ref = C.composite_stream_plain(rows, starts, bg, **kw)
        err = float((img - ref).abs().max())
        print(f"[{phase}] {what}: {int(starts[-1])} (tile, Gaussian) pairs "
              f"at {kw['tile_size']}-px tiles; composite_stream against "
              f"composite_stream_plain on render_set's rows: max abs err "
              f"{err:.3g} (bound {TOL})", flush=True)
        if not err <= TOL:
            raise AssertionError(f"{what}: render kernel vs plain {err} > "
                                 f"{TOL}")
        self.first.clear()
        return err


class PlaneProbe:
    """Keeps, while entered, the inputs of the first backward of the
    HexPlane's grid_sample_2d on a time plane at its first scales (more
    rows than columns): the plane, the coordinates and the output
    gradient."""

    def __enter__(self):
        from langsplat4d_torch.field import hexplane
        self.hx, self.fn, self.kept, self.armed = (
            hexplane, hexplane.grid_sample_2d, [], False)

        def probed(plane, coords):
            out = self.fn(plane, coords)
            if (not self.armed and out.requires_grad
                    and plane.shape[1] > plane.shape[2]):
                self.armed = True
                p, c = plane.detach().clone(), coords.detach().clone()
                out.register_hook(
                    lambda g: self.kept.append((p, c, g.detach().clone())))
            return out
        hexplane.grid_sample_2d = probed
        return self

    def __exit__(self, *exc):
        self.hx.grid_sample_2d = self.fn


def loop_phase(dev, root, step_ms=None, **cfg_kw):
    """Phase 20: training(cfg) on `dev` with the hypernerf preset at full
    width, then save_scene, load_trained_model and render_set of 10 frames
    of the saved model, whose frame 0 the render kernel must composite as
    composite_stream_plain does on the same rows (within TOL, as phase 5
    holds the bench's frame). `step_ms` is phase 8's ms per step, printed beside
    the loop's. Returns (the four training kernels' launches in the loop,
    the render kernel's launches in render_set, the inputs of the loop's
    first plane-gradient call on a time plane, in a list, and each stage's
    it/s)."""
    from langsplat4d_torch.checkpoint import load_trained_model
    from langsplat4d_torch.field.deformation import DeformConfig
    from langsplat4d_torch.ops import composite as C
    from langsplat4d_torch.ops import grid_sample as G
    from langsplat4d_torch.render.driver import render_set
    from langsplat4d_torch.train import loop
    on_card = dev.type == "cuda"
    model_path = os.path.join(root, "model")
    cfg = loop_config(root, model_path, **cfg_kw)
    names = ("composite_tiles", "composite_tiles_backward",
             "composite_stream_chunks", "composite_stream_chunks_backward")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for n in names:
        getattr(C, n).launches = 0
    G.plane_grad.launches = 0
    t0 = time.perf_counter()
    with LoopProbe(dev) as probe, PlaneProbe() as plane_probe:
        state = loop.training(cfg, device=dev)
    total_s = time.perf_counter() - t0
    launches = {n: getattr(C, n).launches for n in names}
    launches["plane_grad"] = G.plane_grad.launches
    events = probe.events
    peak = torch.cuda.max_memory_allocated() / 2 ** 20 if on_card else 0.0
    renders = sum(s[1] for s in probe.steps)
    for stage, iters, secs in probe.stages:
        ms = probe.step_ms(stage)
        print(f"[20] {stage}: {iters} iterations in {secs:.2f} s, "
              f"{iters / secs:.3f} it/s; CUDA-event step time median "
              f"{np.median(ms) if ms else float('nan'):.3f} ms "
              f"(min {min(ms) if ms else float('nan'):.3f}, max "
              f"{max(ms) if ms else float('nan'):.3f})", flush=True)
    fl = [s for s in probe.stages if s[0] == "fine-lang"][0]
    if step_ms:
        print(f"[20] full loop against step only: fine-lang (batch 1) "
              f"{fl[1] / fl[2]:.3f} it/s through training(cfg), phase 8's "
              f"train_step {1e3 / step_ms:.3f} it/s on its workload",
              flush=True)
    for stage, it, what, n in events:
        print(f"[20] {stage} iteration {it}: {what} -> num_active {n}",
              flush=True)
    switched = [e for e in events if e[2] == "stream_switch"]
    print(f"[20] stream switch: "
          + (f"fired in {switched[0][0]} at iteration {switched[0][1]}"
             if switched else "did not fire"), flush=True)
    cold = [b[0] for b in probe.builds if b[1]]
    warm = [b[0] for b in probe.builds if not b[1]]
    print(f"[20] build_batch: {len(cold)} calls that missed the GT cache, "
          f"mean {np.mean(cold) * 1e3 if cold else float('nan'):.2f} ms; "
          f"{len(warm)} cached, mean "
          f"{np.mean(warm) * 1e3 if warm else float('nan'):.2f} ms "
          f"(host clock, on the producer thread)", flush=True)
    print(f"[20] training(cfg) {total_s:.1f} s for {len(probe.steps)} steps "
          f"({renders} camera renders, {probe.eval_renders} renders of the "
          f"debug grid); launches: "
          + ", ".join(f"{n} {v}" for n, v in launches.items())
          + f"; peak memory {peak:.1f} MiB; final num_active "
          f"{state.num_active}", flush=True)
    if on_card and not launches["plane_grad"]:
        raise AssertionError("the plane-gradient kernel never launched")
    for stage in loop.STAGE_ORDER:
        ls = probe.losses(stage)
        print(f"[20] {stage} loss, mean of each 25 iterations: "
              + " ".join(f"{np.mean(ls[i:i + 25]):.4f}"
                         for i in range(0, len(ls), 25)), flush=True)
    if not all(np.isfinite(probe.losses(s)).all()
               for s in loop.STAGE_ORDER):
        raise AssertionError("a loss is not finite")
    kinds = {(e[0], e[2]) for e in events}
    for stage in ("coarse-base", "fine-base"):
        for what in ("densify", "prune", "reset"):
            if (stage, what) not in kinds:
                raise AssertionError(f"no {what} in {stage}")
    if on_card:
        fwd = launches["composite_tiles"] + launches[
            "composite_stream_chunks"]
        bwd = launches["composite_tiles_backward"] + launches[
            "composite_stream_chunks_backward"]
        if fwd != renders + probe.eval_renders or bwd != renders:
            raise AssertionError(f"kernel launches {fwd} / {bwd} for "
                                 f"{renders} camera renders and "
                                 f"{probe.eval_renders} outside the steps")
        if not launches["composite_tiles"]:
            raise AssertionError("the tile-list kernels never launched")
    fb = probe.losses("fine-base")
    head, tail = float(np.mean(fb[:10])), float(np.mean(fb[-10:]))
    print(f"[20] fine-base loss, first 10 iterations {head:.6f}, last 10 "
          f"{tail:.6f}: ratio {tail / head:.4f} (floor 0.6)", flush=True)
    if not tail <= 0.6 * head:
        raise AssertionError("the fine-base loss did not fall to 0.6x")

    # the saved model: load and render 10 frames through render_set
    iteration = cfg.optim.fine_lang_iterations
    loop.save_scene(cfg, state, iteration, "fine-lang", model_path)
    dcfg = DeformConfig.from_config(cfg.hidden, cfg.runtime,
                                    max_sh_degree=cfg.model.sh_degree)
    scene = loop.Scene(root)
    model, it = load_trained_model(model_path, "fine-lang", -1, dcfg,
                                   aabb=scene.aabb, device=dev)
    if it != iteration or model.gaussians.num_active != state.num_active:
        raise AssertionError("the saved model reads back differently")
    video = scene.getVideoCameras()
    views = [video[i] for i in range(min(10, len(video)))]
    C.composite_stream.launches = 0
    with FirstComposite() as first:
        fps = render_set(cfg, model, dcfg, scene, "video", it, views,
                         mode="rgb", load_stage="fine-lang", novideo=True)
    render_launches = C.composite_stream.launches
    first.hold(20, "saved model frame 0")
    frame = np.load(os.path.join(model_path, "video_rgb", f"ours_{it}",
                                 "renders_npy", "00000.npy"))
    gt = views[0].image.transpose(1, 2, 0)
    psnr = -10 * np.log10(np.mean((np.clip(frame, 0, 1) - gt) ** 2))
    print(f"[20] saved model: {model.gaussians.num_active} Gaussians, "
          f"render_set of {len(views)} frames at {fps:.3f} FPS, "
          f"composite_stream "
          f"launches {render_launches}; frame 0 PSNR {psnr:.2f} dB against "
          f"its ground truth", flush=True)
    if on_card and render_launches < len(views):
        raise AssertionError("the render kernel did not launch per frame")
    if not (np.isfinite(frame).all() and frame.shape == gt.shape):
        raise AssertionError("the saved model renders a bad frame")
    rates = {stage: iters / secs for stage, iters, secs in probe.stages}
    return launches, render_launches, plane_probe.kept[:1], rates


# the language autoencoder and the evaluation (phases 22 and 23) at the
# reference's widths; one set of dims for train, test and eval (their CLIs'
# defaults differ, as the reference's do)
AE_ENC = (256, 128, 64, 32, 3)
AE_DEC = (16, 32, 64, 128, 256, 256, 512)
# the depth cut: the reference trains 100 epochs of a scene's segment
# features, tens of thousands of rows, ~1e5 batches of 64 in all; phase
# 19's scene has 48 x 32 rows, 24 batches an epoch, and AE_EPOCHS of them
# (4,800 batches) fit the phase's ~30 s (300 took 34.5-45.6 s on the card)
AE_EPOCHS = 200
EVAL_FRAMES, EVAL_PROMPTS = 8, 6
# the video search's AE (eval.py's defaults): 4096-d video features
VIDEO_ENC = (2048, 1024, 512, 256, 128, 64, 32, 6)
VIDEO_DEC = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def ae_argv(root, dev):
    argv = ["--dataset_path", root, "--model_name", "smoke",
            "--encoder_dims", *map(str, AE_ENC),
            "--decoder_dims", *map(str, AE_DEC),
            "--feature_dims", str(CLIP_DIM), "--hidden_dims", str(AE_ENC[-1]),
            "--ckpt_dir", os.path.join(root, "ae_ckpt")]
    # the CLIs run on the card unless told otherwise
    return argv if dev.type == "cuda" else argv + ["--device", str(dev)]


def ae_phase(dev, root, epochs=AE_EPOCHS):
    """Phase 22: `python -m langsplat4d_torch.ae.train` (its `main`) on the
    scene's 512-d segment features at full width for `epochs` epochs, then
    `ae.test`, which exports `language_features_dim3` (phase 20 trains on
    it). Prints the CUDA-event ms per train batch (the median gap between
    consecutive Adam steps), the best eval loss, the export's rows/s (wall
    clock, files included), and the mean cosine of the decoded export to
    the features. Returns the checkpoint's path."""
    from langsplat4d_torch.ae import model as M
    from langsplat4d_torch.ae import test as ae_test
    from langsplat4d_torch.ae import train as ae_train
    from langsplat4d_torch.ae.data import load_feature_dataset
    on_card = dev.type == "cuda"
    argv = ae_argv(root, dev)
    data, _ = load_feature_dataset(os.path.join(root, "language_features"))
    marks, update = [], ae_train.adam_update

    def marked(*a, **k):
        update(*a, **k)
        if on_card:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
    ae_train.adam_update = marked
    t0 = time.perf_counter()
    try:
        best = ae_train.main(argv + ["--num_epochs", str(epochs)])
    finally:
        ae_train.adam_update = update
    if on_card:
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    gaps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    batches = epochs * -(-len(data) // 64)
    print(f"[22] ae.train: {len(data)} features of width {data.shape[1]}, "
          f"encoder {list(AE_ENC)}, decoder {list(AE_DEC)}, {epochs} epochs, "
          f"{batches} batches (depth cut: the reference's 100 epochs come to "
          f"~1e5 batches), {train_s:.1f} s; CUDA-event ms per train batch "
          f"median "
          f"{np.median(gaps) if gaps else float('nan'):.3f} (min "
          f"{min(gaps) if gaps else float('nan'):.3f}); best eval loss "
          f"{best:.6f}", flush=True)
    if not np.isfinite(best):
        raise AssertionError("the AE's eval loss is not finite")
    t0 = time.perf_counter()
    out_dir = ae_test.main(argv)
    export_s = time.perf_counter() - t0
    ckpt = os.path.join(root, "ae_ckpt", "smoke", "best_ckpt.pth")
    names = sorted(f for f in os.listdir(out_dir) if f.endswith("_f.npy"))
    codes = np.load(os.path.join(out_dir, names[0]))
    if (len(names) != len(os.listdir(out_dir)) // 2
            or codes.shape != (N_FEATURES, AE_ENC[-1])
            or not np.allclose(np.linalg.norm(codes, axis=1), 1, atol=1e-5)):
        raise AssertionError(f"a bad export in {out_dir}")
    model = M.load_ckpt(ckpt, AE_ENC, AE_DEC, device=dev)
    with torch.no_grad():
        dec = model.decode(torch.from_numpy(codes).to(dev)).cpu().numpy()
    cos = float(np.mean(np.sum(dec * data[:N_FEATURES], axis=1)))
    print(f"[22] ae.test: {len(data)} rows exported to "
          f"{os.path.basename(out_dir)} in {export_s:.2f} s, "
          f"{len(data) / export_s:.0f} rows/s; decoded export against the "
          f"features: mean cosine {cos:.4f}", flush=True)
    return ckpt


class EvalProbe:
    """CUDA events around the eval CLI's stages while it is entered: the AE
    decode of a frame's levels, the relevancy, the heatmap smoothing, and
    activate_stream as a whole (threshold and IoU are what it spends beyond
    the two); keeps the first relevancy call's inputs and output and every
    activate_stream result."""
    STAGES = ("decode", "relevancy", "smoothing", "activate")

    def __init__(self, dev):
        self.on_card = dev.type == "cuda"
        self.events = {k: [] for k in self.STAGES}
        self.first_relevancy, self.results = [], []

    def _wrap(self, mod, name, stage, keep=None):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  if self.on_card else None)
            if ev:
                ev[0].record()
            out = fn(*a, **k)
            if ev:
                ev[1].record()
                self.events[stage].append(ev)
            if keep is not None:
                keep(a, out)
            return out
        self.saved.append((mod, name, fn))
        setattr(mod, name, wrapped)

    def __enter__(self):
        from langsplat4d_torch.eval import __main__ as cli
        from langsplat4d_torch.eval import evaluate as E
        self.saved = []

        def keep_rel(a, out):
            if not self.first_relevancy:
                self.first_relevancy.append((*a, out))
        self._wrap(cli, "decode_levels", "decode")
        self._wrap(E, "relevancy_maps", "relevancy", keep_rel)
        self._wrap(E, "smooth_heatmaps", "smoothing")
        self._wrap(E, "activate_stream", "activate",
                   lambda a, out: self.results.append((a[1], out)))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def ms(self, stage):
        return [a.elapsed_time(b) for a, b in self.events[stage]]


def annotate_and_eval(dev, root, ae_ckpt, base, views, it, work, phase,
                      prompts=EVAL_PROMPTS, dataset_type="hypernerf",
                      embed=None):
    """The eval's inputs for the lang renders in `base` (render_set's
    ours_<it> directory of `views`: the video split of a HyperNeRF scene,
    the test split of a Neu3D one) and its run: COCO annotations of the
    `prompts` segments of largest area, each the convex hull of its pixels
    (scipy), a text cache of their features (through `embed` where given)
    and 4 seeded negatives, the renders linked as levels 1-3 under `work`;
    then `python -m langsplat4d_torch.eval` (its `main`) with
    `--dataset_type` under an EvalProbe.
    Prints Mean IoU, the eval's s/frame and, on the card, the CUDA-event ms
    a frame of its stages. Returns (Mean IoU, the probe, the prompts'
    segment ids, their names, {(frame, segment): the hull's mask})."""
    import json as json_mod
    from scipy.spatial import ConvexHull
    from langsplat4d_torch.eval import __main__ as cli
    from langsplat4d_torch.eval import evaluate as E
    from langsplat4d_torch.eval import relevancy as R
    from langsplat4d_torch.train import loop
    on_card = dev.type == "cuda"
    scene = loop.Scene(root)
    H, W = views[0].height, views[0].width
    frames = len(views)
    # annotations, text cache and the feature layout eval reads
    lf_dir = os.path.join(root, "language_features")
    split, split_name, first_stem = (("video", "video_lang", 1)
                                     if dataset_type == "hypernerf"
                                     else ("test", "test_lang", 0))
    segs = [v.get_language_feature_compact(lf_dir, 1, split,
                                           scene.dataset_type)[0]
            .astype(np.int64) for v in views]
    areas = np.bincount(np.concatenate([g[g >= 0] for g in segs]),
                        minlength=N_FEATURES)
    objs = [int(k) for k in np.argsort(-areas, kind="stable")[:prompts]]
    names = {k: f"segment{k:02d}" for k in objs}
    images, anns, hull_masks = [], [], {}
    for j, seg in enumerate(segs):
        images.append({"id": j, "file_name":
                       f"{j + first_stem:05d}_png.rf.{j}.jpg",
                       "height": H, "width": W})
        for k in objs:
            ys, xs = np.nonzero(seg == k)
            if len(xs) < 16:
                continue
            pts = np.stack([xs, ys], 1).astype(np.float64)
            hull = pts[ConvexHull(pts, qhull_options="QJ").vertices]
            poly = hull.reshape(-1).tolist()
            anns.append({"id": len(anns), "image_id": j, "category_id": k + 1,
                         "bbox": [float(xs.min()), float(ys.min()),
                                  float(xs.max() - xs.min()),
                                  float(ys.max() - ys.min())],
                         "segmentation": [poly]})
            hull_masks[(j, k)] = E.polygon_to_mask((H, W), hull)
    os.makedirs(os.path.join(work, "annot", "train"))
    with open(os.path.join(work, "annot", "train",
                           "_annotations.coco.json"), "w") as f:
        json_mod.dump({"categories": [{"id": k + 1, "name": names[k]}
                                      for k in objs],
                       "images": images, "annotations": anns}, f)
    clip = np.load(os.path.join(lf_dir, sorted(os.listdir(lf_dir))[0]
                                .replace("_s.npy", "_f.npy")))
    if embed is not None:
        clip = embed(clip)
    negs = np.random.default_rng(23).normal(size=(4, clip.shape[1]))
    cache = os.path.join(work, "text_cache.npz")
    np.savez(cache, **{names[k]: clip[k] for k in objs},
             **dict(zip(R.NEGATIVES, negs.astype(np.float32))))
    for level in (1, 2, 3):
        d = os.path.join(work, "exps", f"smoke_{level}", split_name)
        os.makedirs(d)
        os.symlink(base, os.path.join(d, f"ours_{it}"))
    argv = ["--exp_name", "smoke", "--iterations", str(it),
            "--annotation_folder", os.path.join(work, "annot"),
            "--ae_ckpt_path", ae_ckpt,
            "--encoder_hidden_dims", *map(str, AE_ENC),
            "--decoder_hidden_dims", *map(str, AE_DEC),
            "--feat_dim", str(AE_ENC[-1]), "--dataset_type", dataset_type,
            "--feat_root", os.path.join(work, "exps"),
            "--text_embedding_cache", cache,
            "--output_path", os.path.join(work, "out")]
    if not on_card:
        argv += ["--device", str(dev)]
    t0 = time.perf_counter()
    with EvalProbe(dev) as probe:
        miou = cli.main(argv)
    if on_card:
        torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    n = len(probe.results)
    print(f"[{phase}] eval: {n} frames, {len(objs)} prompts ({len(anns)} "
          f"annotations), 3 levels; Mean IoU {miou}; {eval_s / n:.3f} s a "
          f"frame (wall clock, loading included)", flush=True)
    if on_card:
        ms = {k: np.mean(probe.ms(k)) for k in EvalProbe.STAGES}
        print(f"[{phase}] eval stages, CUDA-event ms a frame: AE decode "
              f"{ms['decode']:.3f}, relevancy {ms['relevancy']:.3f}, "
              f"smoothing {ms['smoothing']:.3f}, threshold + IoU "
              f"{ms['activate'] - ms['relevancy'] - ms['smoothing']:.3f} "
              f"(activate_stream {ms['activate']:.3f})", flush=True)
    return miou, probe, objs, names, hull_masks


def eval_phase(dev, root, ae_ckpt, frames=EVAL_FRAMES, prompts=EVAL_PROMPTS,
               **cfg_kw):
    """Phase 23: evaluation on phase 20's saved model. render_set in lang
    mode over `frames` video frames through the render kernel (the first
    frame's composite held against composite_stream_plain on its rows) with
    the ground-truth maps; COCO annotations of the `prompts` segments of
    largest area, each the convex hull of its pixels (scipy; the ground
    truth is the filled hull); a text cache of their 512-d features and 4
    seeded negatives; then `python -m langsplat4d_torch.eval` (its `main`)
    with the renders linked as levels 1-3. Prints Mean IoU, the CUDA-event
    ms per frame of each stage and the eval's s/frame, holds the first
    frame's relevancy maps against the plain CPU computation within 1e-5,
    and runs the video helpers at full width: a seeded VAE decoder
    (eval.py's video dims) on a seeded [H, W, 6] map through
    cal_avg_video_feature, then evaluate_video_feature and
    smooth_similarity. Returns the render kernel's launches."""
    from langsplat4d_torch.ae.model import VanillaVAE
    from langsplat4d_torch.checkpoint import load_trained_model
    from langsplat4d_torch.eval import __main__ as cli
    from langsplat4d_torch.eval import evaluate as E
    from langsplat4d_torch.eval import relevancy as R
    from langsplat4d_torch.field.deformation import DeformConfig
    from langsplat4d_torch.ops import composite as C
    from langsplat4d_torch.render.driver import render_set
    from langsplat4d_torch.train import loop
    on_card = dev.type == "cuda"
    model_path = os.path.join(root, "model")
    cfg = loop_config(root, model_path, quiet=True, **cfg_kw)
    dcfg = DeformConfig.from_config(cfg.hidden, cfg.runtime,
                                    max_sh_degree=cfg.model.sh_degree)
    scene = loop.Scene(root)
    model, it = load_trained_model(model_path, "fine-lang", -1, dcfg,
                                   aabb=scene.aabb, device=dev)
    video = scene.getVideoCameras()
    picks = np.linspace(0, len(video) - 1, frames).round().astype(int)
    views = [video[int(i)] for i in picks]
    C.composite_stream.launches = 0
    with FirstComposite() as first:
        fps = render_set(cfg, model, dcfg, scene, "video", it, views,
                         mode="lang", load_stage="fine-lang", novideo=True)
    launches = C.composite_stream.launches
    first.hold(23, "eval frame 0")
    if on_card and launches < len(views):
        raise AssertionError("the render kernel did not launch per frame")
    del model
    base = os.path.join(model_path, "video_lang", f"ours_{it}")
    H, W = views[0].height, views[0].width
    gts = sorted(os.listdir(os.path.join(base, "gt_npy")))
    if len(gts) != frames or np.load(os.path.join(
            base, "gt_npy", gts[0])).shape != (H, W, AE_ENC[-1]):
        raise AssertionError("render_set wrote no ground-truth maps")
    print(f"[23] render_set, lang mode: frames {picks.tolist()} at {W}x{H}, "
          f"{fps:.3f} FPS, composite_stream launches {launches}; "
          f"ground-truth maps in gt_npy", flush=True)

    miou, probe, objs, names, hull_masks = annotate_and_eval(
        dev, root, ae_ckpt, base, views, it, os.path.join(root, "eval"), 23,
        prompts)
    n = len(probe.results)
    if not (n == frames and miou is not None and 0.0 <= miou <= 1.0):
        raise AssertionError(f"eval gave Mean IoU {miou} over {n} frames")
    sem, pos, neg, rel = probe.first_relevancy[0]
    with torch.no_grad():
        plain = R.relevancy_maps(sem.cpu(), pos.cpu(), neg.cpu())
    r_err = float((rel.cpu() - plain).abs().max())
    print(f"[23] frame 0's relevancy maps {tuple(rel.shape)} against the "
          f"plain CPU computation: max abs err {r_err:.3g} (bound 1e-5)",
          flush=True)
    if not r_err <= 1e-5:
        raise AssertionError(f"relevancy on the card vs the CPU {r_err}")
    del sem, pos, neg, rel, plain, probe.first_relevancy

    # the video helpers at full width
    vae = VanillaVAE(VIDEO_ENC, VIDEO_DEC, latent_dim=VIDEO_ENC[-1],
                     feature_dim=VIDEO_DEC[-1],
                     generator=torch.Generator().manual_seed(23)).to(dev)
    vae.eval()
    rng = np.random.default_rng(23)
    vmap = rng.normal(size=(H, W, VIDEO_ENC[-1])).astype(np.float32)
    q = rng.normal(size=VIDEO_DEC[-1]).astype(np.float32)
    k0 = objs[0]
    sims, ev = [], None
    with torch.no_grad():
        for j, (prompts_j, out) in enumerate(probe.results):
            if (j, k0) not in hull_masks:
                continue
            mask = torch.from_numpy(hull_masks[(j, k0)]).to(dev)
            if ev is None and on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            sim = E.cal_avg_video_feature(
                lambda x: cli.plain_decode(vae, x), mask, vmap, q)
            if len(sims) == 0 and on_card:
                ev[1].record()
            sims.append((j, sim, out[2][names[k0]][0]))
    res = E.evaluate_video_feature(sims, [(2, 5)],
                                   float(np.mean([x[1] for x in sims])))
    smoothed = E.smooth_similarity(sims, 1, [0.1, 0.8, 0.1])
    first_ms = ev[0].elapsed_time(ev[1]) if ev else float("nan")
    print(f"[23] video helpers: {names[k0]} over {len(sims)} frames, "
          f"decoder {list(VIDEO_DEC)} on a [{H}, {W}, {VIDEO_ENC[-1]}] map: "
          f"first cal_avg_video_feature {first_ms:.3f} ms "
          f"({int(hull_masks[(sims[0][0], k0)].sum())} pixels); vIoU "
          f"{res['average_iou']:.4f}, accuracy {res['accuracy']:.4f}; "
          f"smoothed similarities "
          + " ".join(f"{x[1]:.4f}" for x in smoothed), flush=True)
    if not (sims and all(np.isfinite(x[1]) for x in smoothed)
            and np.isfinite(res["average_iou"])):
        raise AssertionError("the video helpers gave a bad result")
    return launches


# phase 24: the discrete stage's budget, fine_lang_iterations + 10000 in
# the reference (train.py:441), cut as tests/test_e2e.py:145-157 cuts it;
# the Gaussians whose K-Means the plain version checks
DISCRETE_ITERS = 200
# phase A's stage budgets: a third of phase 20's (coarse-base, coarse-lang,
# fine-base; 300/100/300 until phase 26 came, 150/50/150 until phase 28
# came), which keeps the four runs of the snapshots' turns inside the
# script's time
CLI_STAGE_ITERS = (100, 40, 100, 40)
KMEANS_PLAIN_ROWS = 256
def free_port():
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class CallTimer:
    """Wall seconds of every call of the named module attributes while
    entered, the device synchronised before and after each call (so the
    time is the call's own): `calls[name]` lists them."""

    def __init__(self, dev, targets):
        self.on_card = dev.type == "cuda"
        self.targets = targets
        self.calls = {name: [] for _, name in targets}

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name in self.targets]
        for mod, name, fn in self.saved:
            def timed(*a, _fn=fn, _name=name, **k):
                if self.on_card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                if self.on_card:
                    torch.cuda.synchronize()
                self.calls[_name].append(time.perf_counter() - t0)
                return out
            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def viewer_request(cam, out, stop, port, timeout=600.0):
    """A viewer on network_gui's protocol, run on a thread: connect to the
    train CLI's bridge (retrying until it listens), ask for `cam`'s view at
    its size (the view and projection matrices in the viewer's axes, as the
    reference's viewer sends them), read the frame and the source path
    back, hang up. Puts ("frame" [H, W, 3] uint8, "source", "seconds") or
    ("error") into `out`."""
    import json as json_mod
    import socket
    import struct
    w, h = cam.width, cam.height
    view = cam.world_view_transform.astype(np.float32).copy()
    proj = cam.full_proj_transform.astype(np.float32).copy()
    view[:, 1:3] *= -1
    proj[:, 1] *= -1
    msg = json_mod.dumps({
        "resolution_x": w, "resolution_y": h, "train": True,
        "fov_y": cam.fovy, "fov_x": cam.fovx, "z_near": 0.01,
        "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
        "keep_alive": True, "scaling_modifier": 1.0,
        "view_matrix": view.reshape(-1).tolist(),
        "view_projection_matrix": proj.reshape(-1).tolist()}).encode()
    t_end = time.perf_counter() + timeout
    try:
        while True:
            try:
                conn = socket.create_connection(("127.0.0.1", port),
                                                timeout=5)
                break
            except OSError:
                if stop.is_set() or time.perf_counter() > t_end:
                    raise
                time.sleep(0.05)
        with conn:
            conn.settimeout(timeout)
            t0 = time.perf_counter()
            conn.sendall(struct.pack("<I", len(msg)) + msg)
            buf = b""
            while len(buf) < w * h * 3 + 4:
                part = conn.recv(1 << 20)
                if not part:
                    raise ConnectionError("the bridge hung up")
                buf += part
            n_src = struct.unpack("<I", buf[w * h * 3:w * h * 3 + 4])[0]
            while len(buf) < w * h * 3 + 4 + n_src:
                part = conn.recv(1 << 20)
                if not part:
                    raise ConnectionError("the bridge hung up")
                buf += part
            out["seconds"] = time.perf_counter() - t0
            out["frame"] = np.frombuffer(buf[:w * h * 3], np.uint8).reshape(
                h, w, 3)
            out["source"] = buf[w * h * 3 + 4:].decode("ascii")
    except Exception as e:         # reported to, and raised by, the caller
        out["error"] = repr(e)


def cli_phase(dev, root, ae_ckpt, loop_rates=None, iters=LOOP_STAGE_ITERS,
              cuts=LOOP_CUTS, hidden=None, discrete_iters=DISCRETE_ITERS):
    """Phase 24: scripts/train_eval.sh's flow through the port's CLIs (each
    its `main(argv)`) on phase 19's scene and phase 22's export.
    Phase A: `python -m langsplat4d_torch.train` with
    configs/hypernerf/default.py at full width, the depth cuts `iters`
    (CLI_STAGE_ITERS on the card) and `cuts` (phase 20's),
    --fine_lang_iterations 0 --no_dlang 0 and a checkpoint at fine-base's
    last iteration; the preset's render-process snapshots, the debug grid
    and the viewer bridge on a free port, where one request of a
    viewer (`viewer_request`) is answered with a frame of the camera's
    size. Phase B: use_discrete_lang_f=t, --resume_from_final_stage 1
    --init_from_stage fine-base from phase A's checkpoint, the stage cut to
    DISCRETE_ITERS and saved there. Then `python -m langsplat4d_torch.render`
    in lang mode at fine-lang-discrete over the video split, frame 0's
    composite held against the plain version on its rows, and
    `python -m langsplat4d_torch.eval` on those renders as levels 1-3.
    Last, prepare_discrete_stage in both modes on phase 20's saved state,
    timed, its K-Means held against the plain version on
    KMEANS_PLAIN_ROWS Gaussians. Then `snapshot_turns`. Prints it/s per
    stage beside phase 20's
    (`loop_rates`), the snapshots' and the grid's cost, the render's FPS,
    Mean IoU and s/frame. `iters`, `cuts`, `hidden` and `discrete_iters`
    are for a rehearsal on the CPU (the card runs the preset's widths).
    Returns the kernels' launches in the CLIs' runs (train, render)."""
    import threading
    from langsplat4d_torch.checkpoint import load_trained_model
    from langsplat4d_torch.field.deformation import DeformConfig
    from langsplat4d_torch.ops import composite as C
    from langsplat4d_torch.ops import grid_sample as G
    from langsplat4d_torch.ops.kmeans import N_INIT, kmeans, kmeans_plain
    from langsplat4d_torch.render import __main__ as render_cli
    from langsplat4d_torch.train import __main__ as train_cli
    from langsplat4d_torch.train import loop
    from langsplat4d_torch.train.trainstate import make_train_state
    on_card = dev.type == "cuda"
    model_path = os.path.join(root, "cli_model")
    cfg_file = os.path.join(root, "cli_config.py")
    with open(cfg_file, "w") as f:
        f.write(f"_base_ = "
                f"{os.path.join(REPO, 'configs', 'hypernerf', 'default.py')!r}"
                "\nwatchdog_execv = False   # a trip fails the run\n"
                + (f"ModelHiddenParams = {hidden!r}\n" if hidden else ""))
    names = ("composite_tiles", "composite_tiles_backward",
             "composite_stream", "composite_stream_chunks",
             "composite_stream_chunks_backward")
    for n in names:
        getattr(C, n).launches = 0
    G.plane_grad.launches = 0
    saved_env = {k: os.environ.get(k) for k in ("ExpsDir",
                                                "use_discrete_lang_f")}
    os.environ["ExpsDir"] = os.path.join(root, "exps")
    device = [] if on_card else ["--device", str(dev)]
    base = ["--source_path", root, "--model_path", model_path,
            "--expname", "smoke_cli", "--configs", cfg_file,
            "--language_features_name", f"language_features_dim{AE_ENC[-1]}",
            "--feature_level", "1"] + device
    flags = dict(zip(("coarse_base_iterations", "coarse_lang_iterations",
                      "fine_base_iterations"), iters[:3]), **cuts)
    flags = [a for k, v in flags.items() for a in (f"--{k}", str(v))]
    print("[24] phase A depth cuts: " + " ".join(flags)
          + " (fine_lang_iterations 0 as scripts/train_eval.sh)", flush=True)
    fb_last = iters[2]
    argv_a = base + flags + ["--fine_lang_iterations", "0", "--no_dlang", "0",
                            "--checkpoint_iterations", str(fb_last)]
    port = free_port()
    scene = loop.Scene(root)
    reply, stop = {}, threading.Event()
    client = threading.Thread(target=viewer_request,
                              args=(scene.getTrainCameras()[0], reply, stop,
                                    port), daemon=True)
    try:
        with LoopProbe(dev) as probe_a, CallTimer(dev, [
                (loop, "render_process_snapshot"),
                (loop, "_debug_grid")]) as costs:
            client.start()
            t0 = time.perf_counter()
            state = train_cli.main(argv_a + ["--port", str(port)])
            a_s = time.perf_counter() - t0
        stop.set()
        client.join(timeout=60)
        for stage, n_it, secs in probe_a.stages:
            ms = probe_a.step_ms(stage)
            was = (loop_rates or {}).get(stage)
            print(f"[24] phase A {stage}: {n_it} iterations in {secs:.2f} s, "
                  f"{n_it / secs:.3f} it/s through the train CLI"
                  + (f" (phase 20's training(cfg): {was:.3f})" if was else "")
                  + f"; CUDA-event step median "
                  f"{np.median(ms) if ms else float('nan'):.3f} ms",
                  flush=True)
        a_rates = rates_of(probe_a)
        snaps, grids = (costs.calls["render_process_snapshot"],
                        costs.calls["_debug_grid"])
        print(f"[24] phase A {a_s:.1f} s in all, final num_active "
              f"{state.num_active}; on the training thread (the renders and "
              f"the copies' start; the encode and write run on the loop's "
              f"writer thread): render-process snapshots {len(snaps)} "
              f"calls, {sum(snaps):.2f} s ({np.mean(snaps) * 1e3 if snaps else 0:.1f} "
              f"ms each); debug grids {len(grids)} calls, "
              f"{sum(grids):.2f} s ({np.mean(grids) * 1e3 if grids else 0:.1f} ms "
              f"each): {100 * (sum(snaps) + sum(grids)) / a_s:.1f}% of the "
              f"phase", flush=True)
        cam0 = scene.getTrainCameras()[0]
        frame = reply.get("frame")
        print(f"[24] viewer bridge on port {port}: "
              + (f"frame {frame.shape[1]}x{frame.shape[0]} in "
                 f"{reply['seconds'] * 1e3:.1f} ms, source "
                 f"{reply['source']!r}" if frame is not None
                 else f"no frame ({reply.get('error')})"), flush=True)
        if (frame is None or frame.shape != (cam0.height, cam0.width, 3)
                or reply["source"] != root or not frame.std() > 0):
            raise AssertionError("the viewer bridge sent no frame of the "
                                 "camera's size")
        if not (snaps and grids):
            raise AssertionError("no render-process snapshot or debug grid")
        shots = os.listdir(os.path.join(model_path, "render_process"))
        grid_files = os.listdir(os.path.join(model_path,
                                             "training_output_img"))
        if len(shots) < len(snaps) or len(grid_files) != len(grids):
            raise AssertionError("the snapshots or grids were not written")
        ckpt = os.path.join(model_path, f"chkpnt_fine-base_{fb_last}.pth")
        if not os.path.isfile(ckpt):
            raise AssertionError(f"no checkpoint {ckpt}")
        for stage in ("coarse-base", "coarse-lang", "fine-base"):
            if not np.isfinite(probe_a.losses(stage)).all():
                raise AssertionError(f"a {stage} loss is not finite")
        del state

        # phase B: the discrete stage from phase A's checkpoint
        os.environ["use_discrete_lang_f"] = "t"
        argv_b = base + ["--fine_lang_iterations", "0",
                         "--resume_from_final_stage", "1",
                         "--init_from_stage", "fine-base",
                         "--start_checkpoint", ckpt,
                         "--save_iterations", str(discrete_iters)]
        print(f"[24] phase B depth cut: fine-lang-discrete "
              f"{discrete_iters} iterations of fine_lang_iterations 0 + "
              f"10000 (train.py:441), as tests/test_e2e.py:145-157 cuts "
              f"it; saved at {discrete_iters}", flush=True)
        with LoopProbe(dev) as probe_b, CallTimer(
                dev, [(loop, "prepare_discrete_stage")]) as prep:
            whole = loop.scene_reconstruction

            def cut(cfg, scene_, state_, dcfg, stage, joint, n_it, timer,
                    **kw):
                return whole(cfg, scene_, state_, dcfg, stage, joint,
                             min(n_it, discrete_iters), timer, **kw)
            loop.scene_reconstruction = cut
            try:
                t0 = time.perf_counter()
                state = train_cli.main(argv_b)
                b_s = time.perf_counter() - t0
            finally:
                loop.scene_reconstruction = whole
        (stage, n_it, secs), = probe_b.stages
        lf = state.params["language_feature"]
        ls = probe_b.losses(stage)
        print(f"[24] phase B {stage}: {n_it} iterations in {secs:.2f} s, "
              f"{n_it / secs:.3f} it/s ({b_s:.1f} s with the checkpoint "
              f"read); prepare_discrete_stage (fine-base) "
              f"{prep.calls['prepare_discrete_stage'][0]:.3f} s; "
              f"language_feature {tuple(lf.shape)}; loss, mean of each 50 "
              f"iterations: " + " ".join(
                  f"{np.mean(ls[i:i + 50]):.4f}"
                  for i in range(0, len(ls), 50)), flush=True)
        if (stage != "fine-lang-discrete" or n_it != discrete_iters
                or lf.shape[1] != state.deform.cfg.centers_num * AE_ENC[-1]
                or not np.isfinite(ls).all()):
            raise AssertionError("phase B did not train the discrete stage")
        del state
    finally:
        stop.set()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # the render CLI at fine-lang-discrete, lang mode, the video split
    argv_r = ["--model_path", model_path, "--source_path", root,
              "--configs", cfg_file, "--mode", "lang",
              "--load_stage", "fine-lang-discrete", "--skip_train",
              "--skip_test", "--novideo", "1", "--noimage", "1"] + device
    before = C.composite_stream.launches
    with FirstComposite() as first:
        fps = render_cli.main(argv_r)["video"]
    render_launches = C.composite_stream.launches - before
    first.hold(24, "the render CLI's frame 0 at fine-lang-discrete")
    out = os.path.join(model_path, "video_lang", f"ours_{discrete_iters}")
    video = list(scene.getVideoCameras())
    maps = sorted(os.listdir(os.path.join(out, "renders_npy")))
    m0 = np.load(os.path.join(out, "renders_npy", maps[0]))
    print(f"[24] render CLI: {len(maps)} video frames in lang mode at "
          f"fine-lang-discrete, FPS {fps:.3f}, composite_stream launches "
          f"{render_launches}", flush=True)
    if (len(maps) != len(video) or m0.shape != (video[0].height,
                                                video[0].width, AE_ENC[-1])
            or not np.isfinite(m0).all()):
        raise AssertionError("the render CLI wrote bad maps")
    if on_card and render_launches < len(video):
        raise AssertionError("the render kernel did not launch per frame")
    launches = {n: getattr(C, n).launches for n in names}
    launches["plane_grad"] = G.plane_grad.launches

    # the eval CLI on those renders
    miou, probe, *_ = annotate_and_eval(dev, root, ae_ckpt, out, video,
                                        discrete_iters,
                                        os.path.join(root, "eval_cli"), 24)
    if not (len(probe.results) == len(video) and miou is not None
            and 0.0 <= miou <= 1.0):
        raise AssertionError(f"the eval gave Mean IoU {miou}")

    # prepare_discrete_stage in both modes on phase 20's saved state
    model20 = os.path.join(root, "model")
    cfg = loop_config(root, model20, quiet=True, hidden=hidden)
    dcfg = DeformConfig.from_config(cfg.hidden, cfg.runtime,
                                    max_sh_degree=cfg.model.sh_degree)
    model, _ = load_trained_model(model20, "fine-lang", -1, dcfg,
                                  aabb=scene.aabb, device=dev)
    secs = {}
    for mode in ("fine-base", "fine-lang"):
        st = make_train_state(model.gaussians, model.deform, model.aabb)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = loop.prepare_discrete_stage(cfg, st, dcfg, init_from_stage=mode)
        if on_card:
            torch.cuda.synchronize()
        secs[mode] = time.perf_counter() - t0
    n = st.num_active
    lf = model.gaussians.language_feature.detach().cpu().numpy()
    lf_n = torch.from_numpy(lf / (np.linalg.norm(lf, axis=-1, keepdims=True)
                                  + 1e-9)).to(dev)
    t0 = time.perf_counter()
    samples = loop.deformed_lang_samples(st, dcfg, lf_n)
    if on_card:
        torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    rows = samples[:KMEANS_PLAIN_ROWS]
    c_k, i_k = kmeans(rows, cfg.runtime.centers_num)
    t0 = time.perf_counter()
    c_p, i_p = kmeans_plain(rows.cpu(), cfg.runtime.centers_num)
    plain_s = time.perf_counter() - t0
    stage_rows = st.params["language_feature"][:KMEANS_PLAIN_ROWS].reshape(
        KMEANS_PLAIN_ROWS, AE_ENC[-1], -1).permute(0, 2, 1).cpu()
    i_err = float(((i_k.cpu() - i_p).abs() / i_p.clamp(min=1e-12)).max())
    c_err = float((c_k.cpu() - c_p).abs().max())
    s_err = float((stage_rows - c_p).abs().max())
    print(f"[24] prepare_discrete_stage on phase 20's saved state ({n} "
          f"Gaussians): fine-base {secs['fine-base']:.3f} s; fine-lang "
          f"{secs['fine-lang']:.3f} s (100 deformed samples "
          f"{sample_s:.3f} s, then the batched K-Means, k "
          f"{cfg.runtime.centers_num}, n_init {N_INIT}); the "
          f"first {KMEANS_PLAIN_ROWS} Gaussians' K-Means against the plain "
          f"version ({plain_s:.2f} s on the host): inertia rel err "
          f"{i_err:.3g}, centres max abs err {c_err:.3g}, the stage's "
          f"centres {s_err:.3g} (bound 1e-4)", flush=True)
    if not (i_err <= 1e-4 and c_err <= 1e-4 and s_err <= 1e-4):
        raise AssertionError("the K-Means differs from its plain version")
    if on_card:
        for k in ("composite_tiles", "composite_tiles_backward",
                  "composite_stream", "plane_grad"):
            if not launches[k]:
                raise AssertionError(f"{k} never launched in phase 24")
    print("[24] launches in the CLIs' runs: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()), flush=True)
    snapshot_turns(dev, root, argv_a, cfg_file, model_path, a_rates)
    return launches


def rates_of(probe):
    """{stage: it/s} of a LoopProbe's stages, and "all": every stage's
    iterations over their seconds."""
    rates = {stage: n_it / secs for stage, n_it, secs in probe.stages}
    rates["all"] = (sum(n for _, n, _ in probe.stages)
                    / sum(t for _, _, t in probe.stages))
    return rates


def snapshot_turns(dev, root, argv_a, cfg_file, model_path, first):
    """Phase A's it/s with and without the preset's render-process
    snapshots, in turns: the phase's own run (`first`, snapshots on, the
    viewer served), then three more through the train CLI with the same
    flags and no viewer (--port -1): off, off, on, each into its own model
    path. The debug grid is on in all four."""
    from langsplat4d_torch.train import __main__ as train_cli
    off_cfg = os.path.join(root, "cli_config_off.py")
    with open(off_cfg, "w") as f:
        f.write(f"_base_ = {cfg_file!r}\n"
                "ModelParams = dict(render_process=False)\n")
    saved = os.environ.get("ExpsDir")
    os.environ["ExpsDir"] = os.path.join(root, "exps")
    turns = [(True, first)]
    try:
        for i, on in enumerate((False, False, True)):
            argv = [os.path.join(root, f"cli_turn{i}") if a == model_path
                    else (cfg_file if on else off_cfg) if a == cfg_file
                    else a for a in argv_a] + ["--port", "-1"]
            with LoopProbe(dev) as probe:
                train_cli.main(argv)
            shots = os.path.join(root, f"cli_turn{i}", "render_process")
            if os.path.isdir(shots) != on:
                raise AssertionError("render_process did not follow the "
                                     "config")
            turns.append((on, rates_of(probe)))
    finally:
        if saved is None:
            os.environ.pop("ExpsDir", None)
        else:
            os.environ["ExpsDir"] = saved
    for stage in first:
        on = [r[stage] for o, r in turns if o]
        off = [r[stage] for o, r in turns if not o]
        print(f"[24] phase A {stage} in turns (on, off, off, on), it/s: "
              + ", ".join(f"{r[stage]:.3f}" for _, r in turns)
              + f"; snapshots on mean {np.mean(on):.3f}, off mean "
              f"{np.mean(off):.3f}: on/off {np.mean(on) / np.mean(off):.4f}",
              flush=True)


def plane_grad_cases():
    """(label, channels, plane H x W, points, share of padded rows, layout)
    of phase 21's check of the plane-gradient kernel: points spread over
    the plane and past its borders, all on one row (a time plane: one time
    a camera), all in one cell, and a GaussianState's padding (rows with a
    zero gradient at one position), at the presets' widths; the last, the
    shape and padding of phase 20's first time-plane call."""
    return [("spread", 16, (64, 64), 200_000, 0.0, "spread"),
            ("time row", 16, (150, 64), 200_000, 0.0, "row"),
            ("one cell", 8, (32, 32), 50_000, 0.0, "cell"),
            ("padded", 16, (150, 128), 434_176, 0.78, "row"),
            ("narrow", 4, (9, 13), 1_000, 0.2, "spread"),
            ("wide", 32, (64, 64), 30_000, 0.0, "spread"),
            ("loop time plane", 16, (150, 64), 434_176, 0.84, "row")]


def plane_grad_inputs(case, dev, seed=0):
    """A case's (plane, coords, g) on `dev`, from a seed."""
    _, c, (h, w), n, padded, layout = case
    gen = torch.Generator().manual_seed(seed)
    plane = torch.rand(c, h, w, generator=gen) + 0.1
    co = torch.rand(n, 2, generator=gen) * 2.4 - 1.2
    if layout == "row":
        co[:, 1] = 0.3
    elif layout == "cell":
        co = 0.1 + torch.rand(n, 2, generator=gen) * 1e-3
    g = torch.randn(n, c, generator=gen)
    k = int(n * padded)
    if k:                        # the padding: one position, zero gradient
        co[n - k:] = 0.0
        g[n - k:] = 0.0
    return plane.to(dev), co.to(dev), g.to(dev)


def plane_grad_rounding(plane, coords, g, grads):
    """How far each of `grads` (d plane, d coords) lies from the exact
    gradient, in units of what float32 summation in any order may miss:
    the largest |got - ref| / (gamma_k * A) over the elements, where ref is
    plane_grad_plain in float64 from the same float32 corner weights and
    distances, A the sum of the magnitudes of an element's terms, and
    gamma_k = k u / (1 - k u) (u = 2^-24) for its k roundings: a cell's
    gradient has one product and one addition a term (k its terms with a
    gradient), a point's 4 C terms of two products each and one scaling
    (k = 4 C + 2). At most 1 for any order of the sums: where the terms
    cancel, as on a time plane that is all ones (its initial value), the
    bound holds where one relative to the largest entry cannot."""
    from langsplat4d_torch.ops import grid_sample as G
    c, h, w = plane.shape
    p64, g64 = plane.double(), g.double()
    ref_p, ref_c = G.plane_grad_plain(p64, coords, g64)
    cells, _, (e, w_, s, n), (on_x, on_y), _ = corners = G._corners(h, w,
                                                                      coords)
    mag_p = G.plane_grad_plain(p64.abs(), coords, g64.abs())[0]
    live = ((g != 0).any(1)).double()
    k_p = torch.zeros(h * w, dtype=torch.float64, device=g.device)
    k_p.index_add_(0, cells.reshape(-1), live.repeat(4))
    v = p64.abs().reshape(c, h * w).T[cells]                 # [4, n, C]
    v[1] *= on_x[:, None]
    v[2] *= on_y[:, None]
    v[3] *= (on_x & on_y)[:, None]
    ga = g64.abs()
    s, n, e, w_ = s[:, None], n[:, None], e[:, None], w_[:, None]
    mag_c = torch.stack(
        [(((v[0] + v[1]) * s + (v[2] + v[3]) * n) * ga).sum(1) * ((w - 1) / 2),
         (((v[0] + v[2]) * e + (v[1] + v[3]) * w_) * ga).sum(1)
         * ((h - 1) / 2)], 1)
    u = 2.0 ** -24

    def gamma(k):
        return k * u / (1 - k * u)
    bounds = (gamma(k_p).reshape(h, w)[None] * mag_p,
              gamma(4 * c + 2) * mag_c)
    ratios = []
    for got, ref, b in zip(grads, (ref_p, ref_c), bounds):
        err = (got.double() - ref).abs()
        ratios.append(float(torch.where(err == 0, 0.0, err / b).max()))
    return max(ratios)


def compare_plane_grad_case(case, dev, seed=0):
    """The kernel against plane_grad_plain on the case's inputs: the plane
    and coordinates' gradients, each held to the repo's gradient bound
    relative to its largest entry (the sums run in another order); both
    within float32's rounding of the exact gradient (plane_grad_rounding);
    two calls bit-equal. Returns (max abs err of the plane gradient, of the
    coordinates', the largest scaled excess, the share of the rounding
    bound, bit-equal)."""
    from langsplat4d_torch.ops import grid_sample as G
    plane, co, g = plane_grad_inputs(case, dev, seed)
    gp, gc = G.plane_grad(plane, co, g)
    gp2, gc2 = G.plane_grad(plane, co, g)
    rp, rc = G.plane_grad_plain(plane, co, g)
    torch.cuda.synchronize()
    excess = max(scaled_errors(gp, rp)[1], scaled_errors(gc, rc)[1])
    same = torch.equal(gp, gp2) and torch.equal(gc, gc2)
    return (float((gp - rp).abs().max()), float((gc - rc).abs().max()),
            excess, plane_grad_rounding(plane, co, g, (gp, gc)), same)


def plane_grad_index_put(plane, coords, g, filtered=True):
    """What plane_grad computes, through PyTorch's sorting scatter
    (`index_put_(accumulate=True)`, deterministic) in place of
    csrc/plane_grad.cu: the coordinates' gradient as plane_grad_plain forms
    it; the plane's from the corners of the rows with a gradient only,
    taken out with `nonzero` (`filtered`: one wait for the host a call), or
    else with the other rows' corners keyed past the plane, one cell each,
    into HW + n cells. Phase 21 times it against the kernel."""
    from langsplat4d_torch.ops import grid_sample as G
    c, h, w = plane.shape
    n, hw = coords.shape[0], h * w
    corners = G._corners(h, w, coords)
    cells, wts = corners[:2]
    live = (g != 0).any(1)
    if filtered:
        idx = live.nonzero()[:, 0]
        keys, vals, cap = cells[:, idx], wts[:, idx, None] * g[idx][None], hw
    else:
        keys = torch.where(live[None], cells,
                           hw + torch.arange(n, device=g.device)[None])
        vals, cap = wts[:, :, None] * g[None], hw + n
    out = torch.zeros((cap, c), dtype=g.dtype, device=g.device)
    out.index_put_((keys.reshape(-1),), vals.reshape(-1, c), accumulate=True)
    return out[:hw].T.reshape(c, h, w), G.coords_grad_plain(plane, g, corners)


def plane_grad_entry(inputs, launches):
    """The kernels line's entry of the plane-gradient kernel on the inputs
    of one call of phase 20's loop (its first on a time plane, all ones):
    within float32's rounding of the exact gradient (plane_grad_rounding;
    the plain version, which adds with atomics, is printed beside it, and
    its difference from the kernel relative to the largest entry), two
    calls bit-equal (it raises otherwise); kernel, plain and library times
    (aten's grid_sampler_2d_backward, which adds with atomics), beside the
    same function through `index_put_` on the rows with a gradient (both
    forms of plane_grad_index_put, under the deterministic algorithms, each
    checked as the kernel is); the bound on the bytes and operations of the
    call."""
    from langsplat4d_torch.ops import grid_sample as G
    from langsplat4d_torch.train.loop import deterministic_on
    plane, co, g = inputs
    c, h, w = plane.shape
    n = co.shape[0]
    gp, gc = G.plane_grad(plane, co, g)
    gp2, gc2 = G.plane_grad(plane, co, g)
    rp, rc = G.plane_grad_plain(plane, co, g)
    err = max(float((gp - rp).abs().max()), float((gc - rc).abs().max()))
    scaled = (scaled_errors(gp, rp)[0], scaled_errors(gc, rc)[0])
    ratio = plane_grad_rounding(plane, co, g, (gp, gc))
    plain_ratio = plane_grad_rounding(plane, co, g, (rp, rc))
    same = torch.equal(gp, gp2) and torch.equal(gc, gc2)
    print(f"[21] plane_grad on the loop's first time-plane call: max abs "
          f"err vs plain {err:.3g} (relative to the largest entry: plane "
          f"{scaled[0]:.3g}, coordinates {scaled[1]:.3g}); share of "
          f"float32's rounding bound on the exact gradient: kernel "
          f"{ratio:.3g}, plain {plain_ratio:.3g}; two calls bit-equal: "
          f"{same}", flush=True)
    if not (ratio <= 1 and same):
        raise AssertionError("plane_grad on the loop's call: beyond the "
                             "rounding bound or not reproducible")
    k_ms = time_ms(lambda: G.plane_grad(plane, co, g), 20)
    p_ms = time_ms(lambda: G.plane_grad_plain(plane, co, g), 5)
    go, inp, grid = g.T[None, :, :, None].contiguous(), plane[None], co[
        None, :, None, :]
    l_ms = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        go, inp, grid, 0, 1, True, [True, True]), 20)
    put_ms = {}
    with deterministic_on(g.device):
        for filtered in (True, False):
            fn = functools.partial(plane_grad_index_put, plane, co, g,
                                   filtered=filtered)
            (ip, ic), (ip2, ic2) = fn(), fn()
            x = plane_grad_rounding(plane, co, g, (ip, ic))
            if not (x <= 1 and torch.equal(ip, ip2) and torch.equal(ic, ic2)):
                raise AssertionError("plane_grad_index_put: beyond the bound "
                                     "or not reproducible")
            put_ms[filtered] = time_ms(fn, 20)
    live = int((g != 0).any(1).sum())
    # read coords, g, the plane; write both gradients. Per live point and
    # corner and channel: the plane term (1 multiply, 1 add) and the
    # coordinates' (6 multiplies, 2 adds); the padded rows only their
    # coordinates'
    b = bound(4 * (n * 2 + n * c + c * h * w + n * 2 + c * h * w),
              live * 4 * c * 10 + (n - live) * 4 * c * 8)
    print(f"[21] plane_grad on that call: plane [{c}, {h}, {w}], {n} points "
          f"({live} with a gradient): kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms, aten's backward {l_ms:.3f} ms; index_put_ on the "
          f"rows with a gradient, taken out by nonzero {put_ms[True]:.3f} "
          f"ms, keyed past the plane {put_ms[False]:.3f} ms; bound "
          f"{b[0]:.4f} ms by {b[1]}", flush=True)
    return dict(name="plane_grad", launches=launches, max_abs_err=err,
                ms=k_ms, plain_ms=p_ms, bound_ms=b[0], bound_by=b[1],
                library_ms=l_ms, loop_launches=launches)


# the DenseGrid of the `empty_voxel` gate (field/hexplane.py): one channel
# over 64^3 cells; the loop's capacity of rows, most of them padding
DENSE_WORLD, DENSE_ROWS, DENSE_PADDED = (64, 64, 64), 434_176, 0.78


def dense_grid_inputs(dev, seed=0, n=DENSE_ROWS, padded=DENSE_PADDED):
    """(grid [1, 64, 64, 64], ind [n, 3], g [n, 1]) on `dev`, from a seed:
    points spread over the grid and past it (corners off the grid read 0),
    a share of them padding (one position, a zero gradient), as a
    GaussianState's rows reach dense_grid_query's backward."""
    gen = torch.Generator().manual_seed(seed)
    grid = torch.rand(1, *DENSE_WORLD, generator=gen) + 0.5
    ind = torch.rand(n, 3, generator=gen) * 2.2 - 1.1
    g = torch.randn(n, 1, generator=gen)
    k = int(n * padded)
    if k:
        ind[n - k:] = 0.0
        g[n - k:] = 0.0
    return grid.to(dev), ind.to(dev), g.to(dev)


def compare_dense_grid_case(dev, seed=0, **kw):
    """dense_grid_grad (csrc/plane_grad.cu's eight corners a point and its
    segmented sums) against dense_grid_grad_plain: the grid's and the
    points' gradients each within the repo's gradient bound relative to
    its largest entry (the sums run in another order), the corners' keys
    and weights those of dense_grid_keys bit for bit, two calls bit-equal.
    Returns (max abs err of the grid gradient, of the points', the largest
    scaled excess, bit-equal)."""
    from langsplat4d_torch.ops import grid_sample as G
    grid, ind, g = dense_grid_inputs(dev, seed, **kw)
    gg, gi = G.dense_grid_grad(grid, ind, g)
    gg2, gi2 = G.dense_grid_grad(grid, ind, g)
    rg, ri = G.dense_grid_grad_plain(grid, ind, g)
    keys, wts, _ = G.dense_grid_corners(grid, ind, g)
    want_keys, want_wts = G.dense_grid_keys(grid.shape, ind, g)
    torch.cuda.synchronize()
    excess = max(scaled_errors(gg, rg)[1], scaled_errors(gi, ri)[1])
    same = (torch.equal(gg, gg2) and torch.equal(gi, gi2)
            and torch.equal(keys, want_keys) and torch.equal(wts, want_wts))
    return (float((gg - rg).abs().max()), float((gi - ri).abs().max()),
            excess, same)


def dense_grid_phase(dev, root, iters=5):
    """Phase 21's check of the DenseGrid backward (`empty_voxel`, which no
    preset sets): the kernel against its plain version on dense_grid_inputs
    (and on a small case), two calls bit-equal; two identical runs of
    `iters` fine-base iterations with `empty_voxel` on, which must be
    bit-equal; kernel, plain and library times (aten's
    grid_sampler_3d_backward, which adds with atomics) and the bound.
    Returns the kernels line's entry, its launches those of the two runs."""
    import copy
    from langsplat4d_torch.ops import grid_sample as G
    from langsplat4d_torch.train import loop
    from langsplat4d_torch.utils.timer import Timer
    for kw in (dict(), dict(n=2_000, padded=0.2)):
        e_g, e_i, excess, same = compare_dense_grid_case(dev, **kw)
        print(f"[21] dense_grid_grad ({kw.get('n', DENSE_ROWS)} points): max "
              f"abs err vs plain {e_g:.3g} (grid), {e_i:.3g} (points), "
              f"excess over the gradient bound {excess:.3g}; two calls, "
              f"and the corners against dense_grid_keys, bit-equal: {same}",
              flush=True)
        if not (excess <= 0 and same):
            raise AssertionError("dense_grid_grad beyond the bound, not "
                                 "reproducible or off dense_grid_keys")
    cfg = loop_config(root, "", hidden={"empty_voxel": True}, quiet=True)
    scene = loop.Scene(root)
    state0, dcfg = loop.init_state_from_scene(cfg, scene,
                                              seed=cfg.extras.seed,
                                              device=dev)
    with torch.no_grad():     # a grid that is not all ones, so it gates
        vox = state0.deform.deformation_net.empty_voxel.grid
        vox.copy_(torch.rand(vox.shape, generator=torch.Generator()
                             .manual_seed(21)).to(dev) + 0.5)
    G.dense_grid_grad.launches = 0
    runs = [loop.scene_reconstruction(cfg, scene, copy.deepcopy(state0),
                                      dcfg, "fine-base", False, iters,
                                      Timer()) for _ in range(2)]
    launches = G.dense_grid_grad.launches
    diff = max(float((p.detach() - runs[1].leaves()[n].detach()).abs().max())
               for n, p in runs[0].leaves().items())
    vox_moved = float((runs[0].leaves()[
        "deform.deformation_net.empty_voxel.grid"].detach()
        - vox.detach()).abs().max())
    print(f"[21] two identical fine-base runs of {iters} iterations with "
          f"empty_voxel: largest difference {diff:.3g}; the grid moved by "
          f"up to {vox_moved:.3g}; dense_grid_grad launches {launches}",
          flush=True)
    if diff != 0 or not launches or not vox_moved > 0:
        raise AssertionError("the empty_voxel runs differ, or the grid "
                             "gradient never ran")
    del runs, state0
    grid, ind, g = dense_grid_inputs(dev)
    gg, gi = G.dense_grid_grad(grid, ind, g)
    rg, ri = G.dense_grid_grad_plain(grid, ind, g)
    err = max(float((gg - rg).abs().max()), float((gi - ri).abs().max()))
    k_ms = time_ms(lambda: G.dense_grid_grad(grid, ind, g), 20)
    p_ms = time_ms(lambda: G.dense_grid_grad_plain(grid, ind, g), 5)
    go = g.T.reshape(1, 1, 1, 1, -1).contiguous()
    inp, pos = grid[None], ind.reshape(1, 1, 1, -1, 3)
    l_ms = time_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(
        go, inp, pos, 0, 0, True, [True, True]), 20)
    n, cells = ind.shape[0], grid.numel()
    live = int((g != 0).any(1).sum())
    # read ind, g, the grid; write both gradients. Per live point and corner
    # the grid term (1 multiply, 1 add) and the points' (3 x 2 multiplies,
    # 3 adds, the weight's 2 multiplies); the padded rows their points'
    b = bound(4 * (n * 3 + n + cells + cells + n * 3),
              live * 8 * 13 + (n - live) * 8 * 11)
    print(f"[21] dense_grid_grad on grid {list(grid.shape)}, {n} points "
          f"({live} with a gradient): kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms, aten's grid_sampler_3d_backward {l_ms:.3f} ms; "
          f"bound {b[0]:.4f} ms by {b[1]}", flush=True)
    return dict(name="dense_grid_grad", launches=launches, max_abs_err=err,
                ms=k_ms, plain_ms=p_ms, bound_ms=b[0], bound_by=b[1],
                library_ms=l_ms, loop_launches=0)


def adam_step_cap(steps):
    """The most |m_hat| / sqrt(v_hat) reaches in any of Adam's first `steps`
    steps (Cauchy-Schwarz over the moments' weights; 1 at the first step):
    two runs' steps differ by at most twice this many learning rates."""
    from langsplat4d_torch.train.optim import BETA1, BETA2
    cap = 0.0
    for t in range(1, steps + 1):
        k = np.arange(t)[::-1]
        w = (1 - BETA1) * BETA1 ** k / (1 - BETA1 ** t)
        u = (1 - BETA2) * BETA2 ** k / (1 - BETA2 ** t)
        cap = max(cap, float(np.sqrt((w * w / u).sum())))
    return cap


def adam_allowance(grads, lrs, name, like, cap):
    """What Adam's steps let one leaf's parameters drift when every step's
    gradient may differ from `grads` (the plain run's, one dict a step) by
    delta = atol * (the leaf's largest |g|) + rtol * |g|, elementwise: with
    D the largest delta so far and a = sqrt(v_hat) of `grads`, a step's
    m_hat / sqrt(v_hat) moves by at most D (1 + c) / (a - D), and by 2c
    wherever a <= D (c = `cap`); summed over the steps in learning rates
    (`lrs`, one dict a step)."""
    from langsplat4d_torch.train.optim import BETA2
    atol, rtol = GRAD_TOL["atol"], GRAD_TOL["rtol"]
    v, d_max = torch.zeros_like(like), torch.zeros_like(like)
    allowed = torch.zeros_like(like)
    for t, (g_t, lr_t) in enumerate(zip(grads, lrs), 1):
        g = g_t.get(name)
        if g is None:
            g = torch.zeros_like(like)
        v = BETA2 * v + (1 - BETA2) * g * g
        a = (v / (1 - BETA2 ** t)).sqrt()
        d_max = torch.maximum(d_max, atol * g.abs().max() + rtol * g.abs())
        per_step = torch.where(a > d_max, (1 + cap) * d_max / (a - d_max),
                               torch.full_like(a, 2 * cap))
        allowed += lr_t[name] * torch.clamp(per_step, max=2 * cap)
    return allowed


def determinism_phase(dev, root, iters=5, hidden=None, turn_iters=10):
    """Phase 21: the first `iters` iterations of coarse-base from one
    initial state with the kernels and with their plain versions. The plain
    run holds the kernels' run as phase 9 holds a step: every step's
    gradient of every leaf, and each leaf's Adam moments, within rtol 2e-3
    / atol 2e-4 of the leaf's largest entry, and its parameters too where
    the gradient is at least a tenth of the leaf's largest (second moment
    at least 1e-2 of the largest). Below that the bound's atol is a large
    share of the gradient, and Adam, whose step is lr * m / sqrt(v)
    whatever the gradient's size, carries it into the step: there each
    parameter is held to what gradients within the bound at every step
    allow through Adam (`adam_allowance`), plus one rounding of the
    parameter a step. The worst element is printed in learning rates, with
    its gradient's share of the leaf's largest at the first step and over
    the run.

    Then two identical runs of `iters` iterations of coarse-base,
    coarse-lang and fine-base as the loop runs them (the deterministic
    algorithms on in every stage): the largest difference per leaf, which
    on the card must be 0. Last, `turn_iters` iterations of coarse-base and
    of fine-base with the deterministic algorithms on and off, in turns,
    time what they cost; and fine-base as the loop runs it against aten's
    grid_sample backward with the algorithms off (the setting before
    grid_sample_2d's own backward) and against the plane gradient through
    `index_put_` (plane_grad_index_put, both forms). Returns the largest
    run-to-run difference of coarse-base."""
    import copy
    from langsplat4d_torch.ops import composite as C
    from langsplat4d_torch.train import loop
    from langsplat4d_torch.train import step as step_mod
    from langsplat4d_torch.utils.timer import Timer
    on_card = dev.type == "cuda"
    if on_card:
        for case in plane_grad_cases():
            e_p, e_c, excess, ratio, same = compare_plane_grad_case(case,
                                                                    dev)
            print(f"[21] plane_grad {case[0]} (C={case[1]}, plane "
                  f"{case[2][0]}x{case[2][1]}, {case[3]} points): max abs "
                  f"err vs plain {e_p:.3g} (plane), {e_c:.3g} "
                  f"(coordinates), excess over the gradient bound "
                  f"{excess:.3g}; share of the rounding bound {ratio:.3g}; "
                  f"two calls bit-equal: {same}", flush=True)
            if not (excess <= 0 and ratio <= 1 and same):
                raise AssertionError(f"plane_grad {case[0]}: beyond the "
                                     f"bound or not reproducible")
    cfg = loop_config(root, "", hidden=hidden, quiet=True)
    scene = loop.Scene(root)
    state0, dcfg = loop.init_state_from_scene(cfg, scene, seed=cfg.extras.seed,
                                              device=dev)
    pairs = (("composite_tiles", "composite_tiles_plain"),
             ("composite_tiles_backward", "composite_tiles_backward_plain"))
    update = step_mod.adam_update

    def run(stage="coarse-base", plain=False, n=iters, det=True, log=None):
        """`n` iterations of `stage` from state0; `det` False turns the
        loop's deterministic algorithms off; `log`, a list, receives each
        step's (gradients of the trainable leaves, learning rates)."""
        saved = {n_: getattr(C, n_) for n_, _ in pairs}
        saved_det = loop.deterministic_on
        if plain:
            for n_, p in pairs:
                setattr(C, n_, getattr(C, p))
        if not det:
            loop.deterministic_on = lambda device: contextlib.nullcontext()
        if log is not None:
            def logged(params, grads, opt, lrs, trainable, **k):
                log.append(({k_: g.detach().clone()
                             for k_, g in grads.items()
                             if trainable[k_] and g is not None}, dict(lrs)))
                return update(params, grads, opt, lrs, trainable, **k)
            step_mod.adam_update = logged
        try:
            return loop.scene_reconstruction(
                cfg, scene, copy.deepcopy(state0), dcfg, stage, False, n,
                Timer())
        finally:
            for n_, f in saved.items():
                setattr(C, n_, f)
            loop.deterministic_on = saved_det
            step_mod.adam_update = update
    log_ker, log_ref = [], []
    ker, ref = run(log=log_ker), run(plain=True, log=log_ref)
    grads = [g for g, _ in log_ref]
    lrs = [lr for _, lr in log_ref]
    worst, fault = 0.0, None

    def hold(tag, got, want):
        nonlocal worst, fault
        e, x = scaled_errors(got, want)
        worst = max(worst, e)
        if x > 0 and fault is None:
            fault = (f"{tag}: the kernels' run beyond the gradient bound of "
                     f"the plain run (scaled error {e:.3g}, excess {x:.3g})")
    for t, ((g_k, _), g_r) in enumerate(zip(log_ker, grads), 1):
        if sorted(g_k) != sorted(g_r):
            raise AssertionError(f"step {t}: the runs train other leaves")
        for n in g_r:
            hold(f"{n} gradient at step {t}", g_k[n], g_r[n])
    cap = adam_step_cap(iters)
    n_held = n_all = 0
    loose = (0.0, "no element")     # (share of its bound, where)
    for n, p in ker.leaves().items():
        p, want, v = p.detach(), ref.leaves()[n].detach(), ref.opt.v[n]
        held = (v >= 1e-2 * v.max()) & (v > 0)
        n_held += int(held.sum())
        n_all += held.numel()
        hold(f"{n} m", ker.opt.m[n], ref.opt.m[n])
        hold(f"{n} v", ker.opt.v[n], v)
        if bool(held.any()):
            hold(f"{n} param", p[held], want[held])
        allowed = (adam_allowance(grads, lrs, n, p, cap)
                   + len(grads) * 2.0 ** -23 * torch.maximum(p.abs(),
                                                             want.abs()))
        diff = (p - want).abs()
        ratio = torch.where(held | (diff == 0), 0.0, diff / allowed)
        i = int(ratio.argmax())
        if float(ratio.flatten()[i]) >= loose[0]:
            lr_sum = sum(lr[n] for lr in lrs) or 1.0
            g1 = grads[0].get(n, torch.zeros_like(p)).abs()
            share1 = g1 / g1.max() if g1.max() > 0 else g1
            rms = (v / v.max()).sqrt() if v.max() > 0 else v
            j = int(torch.where(held, 0.0, diff).argmax())
            loose = (float(ratio.flatten()[i]),
                     f"{n}: the element nearest its bound moved "
                     f"{float(diff.flatten()[i]) / lr_sum * iters:.3g} mean "
                     f"learning rates against "
                     f"{float(allowed.flatten()[i]) / lr_sum * iters:.3g} "
                     f"allowed, its gradient "
                     f"{float(share1.flatten()[i]):.3g} of the leaf's largest "
                     f"at step 1 and {float(rms.flatten()[i]):.3g} (RMS) over "
                     f"the run; the leaf's most moved one "
                     f"{float(diff.flatten()[j]) / lr_sum * iters:.3g}, its "
                     f"gradient {float(share1.flatten()[j]):.3g} at step 1, "
                     f"{float(rms.flatten()[j]):.3g} over the run")
    print(f"[21] {iters} coarse-base iterations, kernels against plain "
          f"versions: every step's gradients and the Adam moments of every "
          f"leaf, and the parameters where the gradient is at least a "
          f"tenth of the leaf's largest ({n_held} of {n_all} elements), "
          f"within rtol {GRAD_TOL['rtol']} / atol {GRAD_TOL['atol']} of each "
          f"leaf's largest: worst scaled error {worst:.3g}", flush=True)
    print(f"[21] the other parameters, held to what that bound on every "
          f"step's gradient allows through Adam (at most {2 * cap:.4g} "
          f"learning rates a step): worst {loose[0]:.3g} of its bound, in "
          f"{loose[1]}", flush=True)
    if fault:
        raise AssertionError(fault)
    if not loose[0] <= 1.0:
        raise AssertionError(f"a parameter moved beyond what the gradient "
                             f"bound allows through Adam: {loose[1]}")
    del log_ker, log_ref, grads
    del ref

    def max_diff(a, b):
        diffs = {n: float((p.detach() - b.leaves()[n].detach()).abs().max())
                 for n, p in a.leaves().items()}
        top = sorted((d, n) for n, d in diffs.items() if d > 0)[::-1][:5]
        return max(diffs.values()), ", ".join(f"{n} {d:.3g}" for d, n in top)
    coarse_diff = None
    for stage in ("coarse-base", "coarse-lang", "fine-base"):
        first = ker if stage == "coarse-base" else run(stage)
        d, per_leaf = max_diff(first, run(stage))
        print(f"[21] two identical {stage} runs of {iters} iterations, "
              f"deterministic algorithms on (the loop's setting): largest "
              f"difference {d:.3g}"
              + (f" (largest: {per_leaf})" if per_leaf else ""), flush=True)
        if stage == "coarse-base":
            coarse_diff = d
        if on_card and d != 0:
            raise AssertionError(f"two identical {stage} runs differ")
    del ker, first

    # what the deterministic algorithms cost: `turn_iters` iterations with
    # them on and off, in turns; and fine-base as the loop runs it against
    # its run before grid_sample_2d had a backward of its own (aten's, whose
    # CUDA version adds the plane gradient with atomics, and the
    # deterministic algorithms off), and against the plane gradient through
    # PyTorch's sorting scatter on the rows with a gradient
    from langsplat4d_torch.field import hexplane
    from langsplat4d_torch.ops import grid_sample as G
    variants = {
        "kernel": {},
        "aten": dict(aten=True, det=False),
        "index_put_ nonzero": dict(backward=functools.partial(
            plane_grad_index_put, filtered=True)),
        "index_put_ keyed": dict(backward=functools.partial(
            plane_grad_index_put, filtered=False))}

    def timed(stage, det=True, aten=False, backward=None):
        saved = hexplane.grid_sample_2d, G.plane_grad
        if aten:
            hexplane.grid_sample_2d = aten_grid_sample_2d
        if backward is not None:
            G.plane_grad = backward
        try:
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(stage, n=turn_iters, det=det)
            if on_card:
                torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            hexplane.grid_sample_2d, G.plane_grad = saved
    for stage in ("coarse-base", "fine-base"):
        turns = {True: [], False: []}
        for det in (False, True, True, False, False, True):
            turns[det].append(timed(stage, det))
        print(f"[21] {turn_iters} {stage} iterations in turns, seconds: "
              f"deterministic algorithms on {spread(turns[True])}, off "
              f"{spread(turns[False])}", flush=True)
    turns = {k: [] for k in variants}
    order = list(variants) + list(variants)[::-1]
    for k in order + order[:len(variants)]:
        turns[k].append(timed("fine-base", **variants[k]))
    print(f"[21] {turn_iters} fine-base iterations in turns, seconds: the "
          f"loop's setting (grid_sample_2d's own backward, deterministic "
          f"algorithms on) {spread(turns['kernel'])}; before (aten's "
          f"backward, deterministic algorithms off) {spread(turns['aten'])}; "
          f"the plane gradient through index_put_ on the rows with a "
          f"gradient, taken out by nonzero "
          f"{spread(turns['index_put_ nonzero'])}, keyed past the plane "
          f"{spread(turns['index_put_ keyed'])}", flush=True)
    return coarse_diff


def aten_grid_sample_2d(plane, coords):
    """grid_sample_2d as it was before its backward of its own: aten's
    autograd through F.grid_sample (phase 21 times the fine stage with
    it)."""
    out = torch.nn.functional.grid_sample(
        plane[None], coords[None, :, None, :], mode="bilinear",
        padding_mode="border", align_corners=True)
    return out[0, :, :, 0].T



def once_ms(fn):
    """(ms, result) of one call of fn, the device synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


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


# --------------------------------------------------------------------------
# phases 25-27: the image codec and the scene formats

def texture(h, w, c, seed=25):
    """[h, w, c] uint8 smooth gradients with mild noise: content on which
    libpng's adaptive filter choice varies row by row."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = ((3 * xx + 5 * yy)[..., None] // 4 + 40 * np.arange(c)
           + rng.integers(0, 24, (h, w, c)))
    return (img % 256).astype(np.uint8)


def timed_ms(fn, reps):
    """Median host ms of `reps` calls of fn (the codec is host code)."""
    out, ms = None, []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), out


def codec_phase(full_hw=(1014, 1352)):
    """Phase 25: the port's image codec (csrc/imgcodec.cpp through
    data/codec.py) on this host against its numpy twins, byte for byte,
    on inputs the phase writes itself (the host has no PIL): PNGs through
    `png_bytes` with each filter on every row, a seeded per-row mix and
    libpng's adaptive choice, in grey, grey + alpha, RGB and RGBA; JPEGs
    through the port's encoder (4:4:4) at quality 75 and 95 with and
    without restart intervals, RGB and grey; PIL's resample in all four
    filters, down and up, on RGB and RGBA. Then the times per frame of
    `full_hw`, codec against twin: a PNG of Paeth rows, a PNG of adaptive
    rows, a JPEG at quality 95, and the lanczos resample of a frame at
    twice the size (2704x2028) to it. Returns the times."""
    from langsplat4d_torch.data import codec, jpeg
    from langsplat4d_torch.data import png as P
    from langsplat4d_torch.data import resample as RS
    t0 = time.perf_counter()
    lib = codec.build_library()
    codec.load_library()
    print(f"[25] codec built with {codec.compiler()} "
          f"{' '.join(codec.CXX_FLAGS)} in {time.perf_counter() - t0:.2f} s "
          f"({os.path.basename(lib)})", flush=True)
    rng = np.random.default_rng(25)
    n = 0
    for c in (1, 2, 3, 4):
        img = texture(37, 53, c, seed=c)
        for ft in (0, 1, 2, 3, 4, rng.integers(0, 5, 37),
                   P.adaptive_filters(img)):
            data = P.png_bytes(img, ft)
            got, want = codec.decode_png(data), P.decode_png(data)
            if not (np.array_equal(got, want) and np.array_equal(got, img)):
                raise AssertionError(f"PNG c={c} filters {ft}: the codec "
                                     f"differs from its twin")
            n += 1
    for c in (3, 1):
        for q in (75, 95):
            for rs in (0, 5):
                img = texture(45, 61, c, seed=q + rs)
                data = jpeg.jpeg_bytes(img, q, restart=rs)
                got, want = codec.decode_jpeg(data), jpeg.decode_jpeg(data)
                err = int(np.abs(got.astype(int) - img.reshape(
                    got.shape)).max())
                if not np.array_equal(got, want) or err > 64:
                    raise AssertionError(f"JPEG c={c} q={q} restart={rs}: "
                                         f"the codec differs from its twin")
                n += 1
    for c in (3, 4):
        img = texture(41, 57, c, seed=c + 10)
        for filt in RS.FILTERS:
            for size in ((23, 17), (90, 70), (57, 29)):
                if not np.array_equal(codec.resample(img, size, filt),
                                      RS.resample(img, size, filt)):
                    raise AssertionError(f"resample {filt} c={c} to {size}: "
                                         f"the codec differs from its twin")
                n += 1
    print(f"[25] {n} cases: PNG (5 filters, a per-row mix, adaptive rows; "
          f"grey, grey + alpha, RGB, RGBA), JPEG (q 75 and 95, restart "
          f"intervals 0 and 5, RGB and grey), resample (4 filters, down and "
          f"up, RGB and RGBA): the codec equals its numpy twins byte for "
          f"byte", flush=True)
    H, W = full_hw
    frame = texture(H, W, 3)
    times = {}
    for label, ft in (("png_paeth", 4), ("png_adaptive",
                                         P.adaptive_filters(frame))):
        data = P.png_bytes(frame, ft)
        k_ms, got = timed_ms(lambda: codec.decode_png(data), 5)
        p_ms, want = timed_ms(lambda: P.decode_png(data), 1)
        if not (np.array_equal(got, frame) and np.array_equal(want, frame)):
            raise AssertionError(f"{label}: a decode differs")
        times[label] = (k_ms, p_ms)
    data = jpeg.jpeg_bytes(frame, 95)
    k_ms, got = timed_ms(lambda: codec.decode_jpeg(data), 5)
    p_ms, want = timed_ms(lambda: jpeg.decode_jpeg(data), 1)
    if not np.array_equal(got, want):
        raise AssertionError("the JPEG frame: the codec differs from its twin")
    times["jpeg_q95"] = (k_ms, p_ms)
    big = codec.resample(frame, (2 * W, 2 * H), "bicubic")
    k_ms, got = timed_ms(lambda: codec.resample(big, (W, H), "lanczos"), 5)
    p_ms, want = timed_ms(lambda: RS.resample(big, (W, H), "lanczos"), 1)
    if not np.array_equal(got, want):
        raise AssertionError("the lanczos frame: the codec differs from its "
                             "twin")
    times["lanczos_2x"] = (k_ms, p_ms)
    k_ms, _ = timed_ms(lambda: codec.to_chw_f32(frame), 5)
    times["to_chw_f32"] = (k_ms, None)
    print(f"[25] ms per {W}x{H} frame on this host, codec (median of 5) / "
          f"numpy twin: " + "; ".join(
              f"{k} {a:.2f} / {b:.1f}" if b is not None else f"{k} {a:.2f}"
              for k, (a, b) in times.items()), flush=True)
    return times


def look_at(c):
    """World-to-camera rotation (rows: the camera's x, y, z in OpenCV's
    axes) of a camera at `c` looking at the origin, world +y down the
    image (phase 19's rig)."""
    z = -np.asarray(c, np.float64) / np.linalg.norm(c)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def render_frame(dev, workload, cam, t, bg):
    """The workload (gs, dcfg, net, aabb) rendered at fine-lang through the
    port from HostCamera `cam` at time t: (uint8 [H, W, 3], language image
    [L, H, W] on the device)."""
    from langsplat4d_torch.render.driver import to8b
    from langsplat4d_torch.render.pipeline import render
    from langsplat4d_torch.render.raster import RasterSettings
    gs, dcfg, net, aabb = workload
    settings = RasterSettings(image_height=cam.height, image_width=cam.width,
                              sh_degree=3)
    with torch.no_grad():
        out = render(settings, dcfg, "fine-lang", cam.camera_params(dev), t,
                     gs, net, aabb, bg)
    img = to8b(out["render"].cpu().numpy()).transpose(1, 2, 0)
    return np.ascontiguousarray(img), out["language_feature_image"]


def segment_language(gs, seed, n_features=N_FEATURES):
    """Give each Gaussian of `gs` one of `n_features` seeded unit 3-d
    features, that of the nearest of as many seeded positions (as phase 19
    does); returns the features [K, 3] float32."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n_features, 3)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    anchors = torch.from_numpy(rng.uniform(-1.2, 1.2, size=(
        n_features, 3)).astype(np.float32)).to(gs.xyz.device)
    near = torch.cdist(gs.xyz, anchors).argmin(1)
    f_dev = torch.from_numpy(feats).to(gs.xyz.device)
    gs.language_feature = torch.where(gs.active_mask()[:, None],
                                      f_dev[near], 0.0)
    return feats


def segments_of(lang, feats):
    """Per-pixel argmax of a language image [3, H, W] against the features
    [K, 3], -1 where the image's norm is under 0.2: [H, W] int16."""
    f = torch.from_numpy(feats).to(lang.device)
    seg = torch.einsum("chw,kc->khw", lang, f).argmax(0)
    return torch.where(lang.norm(dim=0) < 0.2, -1, seg).to(
        torch.int16).cpu().numpy()


def initial_cloud(gs, n_init, rng):
    """A seeded subset of `n_init` of the Gaussians' centres with noise,
    and their colours in 0-255 (phase 19's initial cloud)."""
    from langsplat4d_torch.core.sh import C0
    n = gs.num_active
    pick = np.sort(rng.choice(n, size=min(n_init, n), replace=False))
    xyz = gs.xyz[:n].cpu().numpy()[pick]
    xyz = xyz + rng.normal(0.0, 0.01, size=xyz.shape).astype(np.float32)
    rgb = np.clip(gs.features_dc[:n, 0].cpu().numpy()[pick] * C0 + 0.5, 0, 1)
    return xyz, np.round(rgb * 255.0)


def write_files(items):
    """Write (path, bytes-making function) pairs on a thread pool (zlib and
    the codecs' numpy release the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(item):
        os.makedirs(os.path.dirname(item[0]), exist_ok=True)
        with open(item[0], "wb") as f:
            f.write(item[1]())
    with ThreadPoolExecutor() as ex:
        list(ex.map(one, items))


NEU3D_HW = (1014, 1352)        # Neu3DDataset's fixed img_wh at downsample 1
NEU3D_FOCAL_PX = 1200.0        # the focal at 1352 px


def dynerf_cameras(cams):
    """The rig of `write_dynerf_scene`: `cams` forward-facing cameras on a
    3-wide grid in the plane z = -4.5, each looking at the origin. ->
    [(centre, world-to-camera rotation)]."""
    out = []
    for i in range(cams):
        c = np.array([(i % 3 - 1) * 0.6, (i // 3 - 0.5) * 0.4, -4.5])
        out.append((c, look_at(c)))
    return out


def write_dynerf_scene(root, dev, workload, cams=6, frames=30,
                       downsample=1.0, n_init=100_000, seed=26):
    """A Neu3D (dynerf) scene in `root`, as the reader takes it once the
    frames are extracted: `poses_bounds.npy` (LLFF: per camera the
    columns [down, right, backwards, centre, (H, W, focal at 2704 px)] and
    near, far), `cams` cameras of `dynerf_cameras` with cam00 the test
    split, `frames` frames a camera under camNN/images/ as PNGs with
    libpng's adaptive row filters, each the workload rendered at fine-lang
    (Neu3D's deformation) at the reader's size for `downsample` (1352x1014
    at 1) and its time (frame / 300); `points3D_downsample2.ply`, a seeded
    subset of `n_init` centres; 3-d language ground truth of 32 segments
    under the names the loader asks for (`language_feature_name`: the
    300-frame mapping names every training frame after cam01, ROADMAP
    queue 3), in `language_features`. The workload's language features are
    replaced by the segments'. Returns (feats, {(split, index): segments})
    for the annotations."""
    from langsplat4d_torch.core.transforms import focal2fov
    from langsplat4d_torch.data.cameras import HostCamera
    from langsplat4d_torch.data.png import adaptive_filters, png_bytes
    from langsplat4d_torch.data.readers import Neu3DDataset, store_ply
    rng = np.random.default_rng(seed)
    gs = workload[0]
    feats = segment_language(gs, seed + 1)
    w, h = int(1352 / downsample), int(1014 / downsample)
    # the reader's focal is the stored one over 2704 / w
    focal = NEU3D_FOCAL_PX * w / 1352
    rows = []
    for c, r_w2c in dynerf_cameras(cams):
        x, y, z = r_w2c                       # OpenCV axes in the world
        pose = np.stack([y, x, -z, c, [1014 * 2, 1352 * 2,
                                       NEU3D_FOCAL_PX * 2]], 1)
        rows.append(np.concatenate([pose.reshape(-1), [2.0, 8.0]]))
    os.makedirs(root, exist_ok=True)
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    bg = torch.zeros(3, device=dev)          # the neu3d preset's background
    segs, items = {}, []
    for ci, (c, r_w2c) in enumerate(dynerf_cameras(cams)):
        cam = HostCamera(R=r_w2c.T, T=-c @ r_w2c.T, fovx=focal2fov(focal, w),
                         fovy=focal2fov(focal, h), width=w, height=h)
        for f in range(frames):
            img, lang = render_frame(dev, workload, cam, f / 300, bg)
            path = os.path.join(root, f"cam{ci:02d}", "images", f"{f:04d}.png")
            segs[path] = segments_of(lang, feats)
            items.append((path, lambda img=img: png_bytes(
                img, adaptive_filters(img))))
    write_files(items)
    xyz, rgb = initial_cloud(gs, n_init, rng)
    store_ply(os.path.join(root, "points3D_downsample2.ply"), xyz, rgb)
    lf_dir = os.path.join(root, "language_features")
    os.makedirs(lf_dir, exist_ok=True)
    by_index = {}
    for split in ("train", "test"):
        ds = Neu3DDataset(root, split, downsample=downsample)
        for i, path in enumerate(ds.image_paths):
            cam = ds[i]
            cam.colmap_id = i                # as CameraDataset stamps it
            stem = cam.language_feature_name(lf_dir, split, "dynerf")
            np.save(stem + "_s.npy", np.stack([segs[path]] * 4))
            np.save(stem + "_f.npy", feats)
            by_index[(split, i)] = segs[path]
    return feats, by_index


def rotmat2qvec(r):
    """COLMAP's quaternion (w, x, y, z) of a rotation matrix."""
    m = np.asarray(r, np.float64)
    w = np.sqrt(max(1.0 + m[0, 0] + m[1, 1] + m[2, 2], 1e-12)) / 2
    return np.array([w, (m[2, 1] - m[1, 2]) / (4 * w),
                     (m[0, 2] - m[2, 0]) / (4 * w),
                     (m[1, 0] - m[0, 1]) / (4 * w)])


def write_colmap_model(sparse, cams, hw, names, points=None, text=False):
    """A COLMAP sparse model in `sparse`: one PINHOLE camera of size `hw`
    (fx != fy), an image per (centre, world-to-camera rotation) of `cams`
    named `names`, and the points (xyz, rgb 0-255) where given; binary or
    text."""
    import struct
    h, w = hw
    fx, fy = 0.9 * w, 0.85 * w
    os.makedirs(sparse, exist_ok=True)
    if text:
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write(f"# one camera\n1 PINHOLE {w} {h} {fx} {fy} {w / 2} "
                    f"{h / 2}\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            for i, ((c, r), name) in enumerate(zip(cams, names)):
                vals = [repr(float(v)) for v in (*rotmat2qvec(r), *(-r @ c))]
                # a points2D line of one point: the reader drops blank lines
                f.write(f"{i + 1} {' '.join(vals)} 1 {name}\n"
                        f"0.5 0.5 -1\n")
        if points is not None:
            with open(os.path.join(sparse, "points3D.txt"), "w") as f:
                for i, (p, col) in enumerate(zip(*points)):
                    f.write(f"{i} {float(p[0])!r} {float(p[1])!r} "
                            f"{float(p[2])!r} {int(col[0])} "
                            f"{int(col[1])} {int(col[2])} 0.5\n")
        return
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))
        f.write(struct.pack("<dddd", fx, fy, w / 2, h / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, ((c, r), name) in enumerate(zip(cams, names)):
            f.write(struct.pack("<idddddddi", i + 1, *rotmat2qvec(r),
                                *(-r @ c), 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    if points is not None:
        with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(points[0])))
            for i, (p, col) in enumerate(zip(*points)):
                f.write(struct.pack("<QdddBBBd", i, *p,
                                    *np.asarray(col, np.uint8), 0.5))
                f.write(struct.pack("<Q", 0))


def orbit(n, radius=4.5, arc=0.5):
    """`n` cameras on an arc of `arc` x pi/2 around the origin at height 0
    (phase 19's orbit): [(centre, world-to-camera rotation)]."""
    out = []
    for i in range(n):
        ang = arc * np.pi * i / max(n - 1, 1) - 0.25 * arc * np.pi
        c = np.array([radius * np.sin(ang), 0.3, -radius * np.cos(ang)])
        out.append((c, look_at(c)))
    return out


def frames_of(dev, workload, cams, hw, times, bg):
    """The workload rendered from each (centre, rotation) of `cams` at the
    matching time, fovx 1: uint8 [H, W, 3] images."""
    from langsplat4d_torch.core.transforms import focal2fov
    from langsplat4d_torch.data.cameras import HostCamera
    h, w = hw
    focal = w / 2 / np.tan(0.5)
    out = []
    for (c, r), t in zip(cams, times):
        cam = HostCamera(R=r.T, T=-c @ r.T, fovx=1.0,
                         fovy=focal2fov(focal, h), width=w, height=h)
        out.append(render_frame(dev, workload, cam, t, bg)[0])
    return out


def write_colmap_scene(root, dev, workload, n_imgs=10, hw=(48, 64),
                       n_points=300, text=False, seed=27):
    """A COLMAP scene: `n_imgs` JPEGs (the port's encoder, quality 90) of
    the workload on `orbit`, their model under sparse/0 (binary, or text),
    `n_points` seeded points."""
    from langsplat4d_torch.data.jpeg import jpeg_bytes
    cams = orbit(n_imgs)
    names = [f"frame_{i:03d}.jpg" for i in range(n_imgs)]
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(-1.2, 1.2, (n_points, 3)),
           rng.integers(0, 256, (n_points, 3)))
    write_colmap_model(os.path.join(root, "sparse", "0"), cams, hw, names,
                       pts, text=text)
    imgs = frames_of(dev, workload, cams, hw, [0.0] * n_imgs,
                     torch.zeros(3, device=dev))
    write_files([(os.path.join(root, "images", n),
                  lambda im=im: jpeg_bytes(im, 90))
                 for n, im in zip(names, imgs)])


def write_blender_scene(root, dev, workload, n_train=4, n_test=2,
                        hw=(40, 48), fused=True, seed=27):
    """A D-NeRF (Blender) scene: transforms_train.json and
    transforms_test.json (camera_angle_x, per frame its time and its
    camera-to-world matrix in Blender's axes), RGBA PNGs of the workload on
    `orbit` with a seeded alpha, and fused.ply where `fused`."""
    from langsplat4d_torch.data.png import png_bytes
    from langsplat4d_torch.data.readers import store_ply
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    cams = orbit(n)
    times = [i / (n - 1) for i in range(n)]
    imgs = frames_of(dev, workload, cams, hw, times,
                     torch.ones(3, device=dev))
    items = []
    for split, idx in (("train", range(n_train)),
                       ("test", range(n_train, n))):
        frames = []
        for i in idx:
            c, r = cams[i]
            c2w = np.eye(4)
            c2w[:3, :3] = r.T * np.array([1.0, -1.0, -1.0])  # OpenGL axes
            c2w[:3, 3] = c
            frames.append({"file_path": f"./{split}/r_{i:03d}",
                           "time": times[i],
                           "transform_matrix": c2w.tolist()})
            alpha = rng.integers(0, 256, hw + (1,), dtype=np.uint8)
            alpha[hw[0] // 3:, :] = 255
            rgba = np.concatenate([imgs[i], alpha], 2)
            items.append((os.path.join(root, split, f"r_{i:03d}.png"),
                          lambda im=rgba: png_bytes(im, 4)))
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 1.0, "frames": frames}, f)
    write_files(items)
    if fused:
        store_ply(os.path.join(root, "fused.ply"),
                  rng.uniform(-1.2, 1.2, (300, 3)),
                  rng.integers(0, 256, (300, 3)).astype(np.float64))


def write_multipleview_scene(root, dev, workload, n_cams=3, frames=4,
                             hw=(40, 48), seed=27):
    """A MultipleView scene: camNN/frames/ of `frames` PNGs per camera
    (the workload at time frame / frames), one COLMAP image per camera in
    sparse_/, and points3D_multipleview.ply."""
    from langsplat4d_torch.data.png import png_bytes
    from langsplat4d_torch.data.readers import store_ply
    rng = np.random.default_rng(seed)
    cams = orbit(n_cams)
    write_colmap_model(os.path.join(root, "sparse_"), cams, hw,
                       [f"cam{i:02d}.png" for i in range(n_cams)])
    items = []
    for ci, cam in enumerate(cams):
        imgs = frames_of(dev, workload, [cam] * frames, hw,
                         [f / frames for f in range(frames)],
                         torch.ones(3, device=dev))
        items += [(os.path.join(root, f"cam{ci:02d}", "frames",
                                f"{f:04d}.png"), lambda im=im: png_bytes(im))
                  for f, im in enumerate(imgs)]
    write_files(items)
    store_ply(os.path.join(root, "points3D_multipleview.ply"),
              rng.uniform(-1.2, 1.2, (300, 3)),
              rng.integers(0, 256, (300, 3)).astype(np.float64))


def write_panoptic_scene(root, dev, workload, n_cams=4, frames=2,
                         hw=(40, 48), seed=27):
    """A PanopticSports scene: train_meta.json and test_meta.json (the
    first camera is the test split) with per frame and camera K (a
    principal point off the centre), the world-to-camera matrix and the
    file under ims/, written as JPEGs (quality 90) of the workload; the
    initial cloud in init_pt_cld.npz."""
    from langsplat4d_torch.core.transforms import focal2fov
    from langsplat4d_torch.data.cameras import HostCamera
    from langsplat4d_torch.data.jpeg import jpeg_bytes
    rng = np.random.default_rng(seed)
    h, w = hw
    cams = orbit(n_cams)
    fx = fy = w / 2 / np.tan(0.5)
    K = [[fx, 0.0, w / 2 + 1.5], [0.0, fy, h / 2 - 1.0], [0.0, 0.0, 1.0]]
    items = []
    metas = {s: {"w": w, "h": h, "k": [], "w2c": [], "fn": []}
             for s in ("train", "test")}
    for f in range(frames):
        for s in metas.values():
            for key in ("k", "w2c", "fn"):
                s[key].append([])
        for ci, (c, r) in enumerate(cams):
            m = metas["test" if ci == 0 else "train"]
            w2c = np.eye(4)
            w2c[:3, :3], w2c[:3, 3] = r, -r @ c
            fn = f"{ci}/{f:06d}.jpg"
            m["k"][-1].append(K)
            m["w2c"][-1].append(w2c.tolist())
            m["fn"][-1].append(fn)
            cam = HostCamera(R=r.T, T=-c @ r.T, fovx=focal2fov(fx, w),
                             fovy=focal2fov(fy, h), width=w, height=h)
            img = render_frame(dev, workload, cam, f / frames,
                               torch.zeros(3, device=dev))[0]
            items.append((os.path.join(root, "ims", fn),
                          lambda im=img: jpeg_bytes(im, 90)))
    write_files(items)
    for s, m in metas.items():
        with open(os.path.join(root, f"{s}_meta.json"), "w") as fh:
            json.dump(m, fh)
    pts = np.concatenate([rng.uniform(-1.2, 1.2, (300, 3)),
                          rng.uniform(0, 1, (300, 3)), np.ones((300, 1))], 1)
    np.savez(os.path.join(root, "init_pt_cld.npz"), data=pts)


# phase 26: Neu3D at full width through the CLIs
# phase 20's stage budgets cut to 200/60/200/60 and 20 frames a camera (30
# until phase 28 came: the script needed its time); densify, prune and the
# opacity reset still fire at 200 in both base stages
NEU3D_CAMS, NEU3D_FRAMES = 6, 20
NEU3D_STAGE_ITERS = (200, 60, 200, 60)
CACHE_TURNS_MB = (4096, 256, 256, 4096)   # the default, and ~60 of 180 frames
# 70 / 25 until phase 28 came: the script needed its time
CACHE_TURN_ITERS, CACHE_TURN_TIMED = 40, 15


class DecodeTimer:
    """Host seconds of every `readers.load_image` call while entered (the
    lazy decode of a camera's image; no device synchronisation)."""

    def __enter__(self):
        from langsplat4d_torch.data import readers
        self.readers, self.fn, self.calls = readers, readers.load_image, []

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = self.fn(*a, **k)
            self.calls.append(time.perf_counter() - t0)
            return out
        readers.load_image = timed
        return self

    def __exit__(self, *exc):
        self.readers.load_image = self.fn


class StepStamps:
    """The host clock at every call of the loop's train_step_packed while
    entered: it/s over the last iterations of a stage."""

    def __enter__(self):
        from langsplat4d_torch.train import loop
        self.loop, self.fn, self.t = loop, loop.train_step_packed, []

        def stamped(*a, **k):
            self.t.append(time.perf_counter())
            return self.fn(*a, **k)
        loop.train_step_packed = stamped
        return self

    def __exit__(self, *exc):
        self.loop.train_step_packed = self.fn

    def rate(self, last):
        return (last - 1) / (self.t[-1] - self.t[-last])


def neu3d_config_file(root, hidden=None):
    """configs/neu3d/default.py through `_base_`, the watchdog's re-exec
    off (a trip fails the run), `hidden` overriding deformation fields (a
    CPU rehearsal narrows the network; the card runs the preset's)."""
    path = os.path.join(root, "neu3d_config.py")
    with open(path, "w") as f:
        f.write(f"_base_ = "
                f"{os.path.join(REPO, 'configs', 'neu3d', 'default.py')!r}"
                "\nwatchdog_execv = False\n"
                + (f"ModelHiddenParams = {hidden!r}\n" if hidden else ""))
    return path


def neu3d_phase(dev, root, ae_ckpt, workload=None, downsample=1.0,
                cams=NEU3D_CAMS, frames=NEU3D_FRAMES, n_init=100_000,
                iters=NEU3D_STAGE_ITERS, cuts=LOOP_CUTS, hidden=None,
                turn_iters=CACHE_TURN_ITERS, turn_timed=CACHE_TURN_TIMED):
    """Phase 26: Neu3D through the port's CLIs. `write_dynerf_scene` in
    `root` from phase 3's 200k seeded Gaussians with Neu3D's deformation
    (`workload`, else bench_workload's), NEU3D_CAMS x NEU3D_FRAMES at the
    reader's fixed 1352x1014; read back through the port's Scene by a path
    relative to the checkout (the reader cuts the image directory at the
    path's first dot, queue 3). `python -m langsplat4d_torch.train` with
    configs/neu3d/default.py at full width (batch 4), NEU3D_STAGE_ITERS
    with phase 20's densification cuts: it/s per stage, the decode ms a frame (load_image) and the batch
    build's ms an image on the first epoch's misses against cached hits.
    `.render --mode lang` over the test split, frame 0 held against the
    plain kernel on its rows; `.eval --dataset_type neu3d` on test_lang
    with annotations of the test frames' 6 largest segments and a text
    cache of their features decoded by phase 22's autoencoder (`ae_ckpt`).
    Last, fine-base from the initial state in turns at the default
    4096 MB GT cache and at 256 MB (CACHE_TURNS_MB, `turn_iters`
    iterations each, it/s over the last `turn_timed`). Returns the
    kernels' launches in the CLIs' runs. `downsample` and the sizes are
    for a rehearsal on the CPU."""
    from langsplat4d_torch.data import readers
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    if workload is None:
        workload = bench_workload(dev, frames=1)[:4]
    whole = readers.SCENE_LOAD_CALLBACKS["dynerf"]
    if downsample != 1.0:
        # a CPU rehearsal reads the scene at the size it was written at, as
        # tests/test_torch_neu3d_slice.py does (the reader's is 1352x1014)
        def small(datadir):
            info = whole(datadir)
            train, test = (readers.Neu3DDataset(datadir, s, downsample)
                           for s in ("train", "test"))
            return readers.SceneInfo(
                info.point_cloud, train, test, test.video_cam_infos(),
                readers.get_nerfpp_norm(train.cam_infos()), info.ply_path,
                maxtime=300)
        readers.SCENE_LOAD_CALLBACKS["dynerf"] = small
    try:
        return _neu3d_phase(dev, root, ae_ckpt, workload, downsample, cams,
                            frames, n_init, iters, cuts, hidden, turn_iters,
                            turn_timed, t0)
    finally:
        readers.SCENE_LOAD_CALLBACKS["dynerf"] = whole


def _neu3d_phase(dev, root, ae_ckpt, workload, downsample, cams, frames,
                 n_init, iters, cuts, hidden, turn_iters, turn_timed, t0):
    from langsplat4d_torch.ae.model import load_ckpt
    from langsplat4d_torch.config import (Config, apply_overrides,
                                          load_py_config)
    from langsplat4d_torch.data import gt_cache
    from langsplat4d_torch.ops import composite as C
    from langsplat4d_torch.ops import grid_sample as G
    from langsplat4d_torch.render import __main__ as render_cli
    from langsplat4d_torch.train import __main__ as train_cli
    from langsplat4d_torch.train import loop
    from langsplat4d_torch.utils.timer import Timer
    on_card = dev.type == "cuda"
    write_dynerf_scene(root, dev, workload, cams=cams, frames=frames,
                       downsample=downsample, n_init=n_init)
    del workload
    if on_card:
        torch.cuda.empty_cache()
    write_s = time.perf_counter() - t0
    rel = os.path.relpath(root)
    if "." in rel:
        raise AssertionError(f"the scene's path {rel!r} holds a dot: the "
                             f"Neu3D reader would cut it there (queue 3)")
    scene = loop.Scene(rel)
    train, test = scene.getTrainCameras(), scene.getTestCameras()
    first = train[0]
    print(f"[26] dynerf scene written in {write_s:.1f} s: {cams} cameras x "
          f"{frames} frames at {first.width}x{first.height} (adaptive-filter "
          f"PNGs), {len(scene.point_cloud.points)} initial points; splits "
          f"train {len(train)} / test {len(test)} / video "
          f"{len(scene.getVideoCameras())}; the training frames' language "
          f"files are named after {first.cam_name} (the 300-frame mapping)",
          flush=True)
    cfg_file = neu3d_config_file(root, hidden)
    model_path = os.path.join(root, "model")
    names = ("composite_tiles", "composite_tiles_backward",
             "composite_stream", "composite_stream_chunks",
             "composite_stream_chunks_backward")
    for n in names:
        getattr(C, n).launches = 0
    G.plane_grad.launches = 0
    device = [] if on_card else ["--device", str(dev)]
    flags = dict(zip(("coarse_base_iterations", "coarse_lang_iterations",
                      "fine_base_iterations", "fine_lang_iterations"),
                     iters), **cuts)
    flags = [a for k, v in flags.items() for a in (f"--{k}", str(v))]
    print("[26] depth cuts: " + " ".join(flags), flush=True)
    argv = ["--source_path", rel, "--model_path", model_path,
            "--expname", "smoke_neu3d", "--configs", cfg_file,
            "--language_features_name", "language_features",
            "--feature_level", "1", "--port", "-1",
            "--save_iterations", str(iters[3])] + flags + device
    saved = os.environ.get("ExpsDir")
    os.environ["ExpsDir"] = os.path.join(root, "exps")
    try:
        with LoopProbe(dev) as probe, DecodeTimer() as dec:
            t0 = time.perf_counter()
            state = train_cli.main(argv)
            train_s = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("ExpsDir", None)
        else:
            os.environ["ExpsDir"] = saved
    for stage, n_it, secs in probe.stages:
        ms = probe.step_ms(stage)
        print(f"[26] {stage}: {n_it} iterations in {secs:.2f} s, "
              f"{n_it / secs:.3f} it/s through the train CLI; CUDA-event "
              f"step median {np.median(ms) if ms else float('nan'):.3f} ms",
              flush=True)
        if not np.isfinite(probe.losses(stage)).all():
            raise AssertionError(f"a {stage} loss is not finite")
    miss = [s for s, m in probe.builds if m]
    hit = [s for s, m in probe.builds if not m]
    print(f"[26] train CLI {train_s:.1f} s, final num_active "
          f"{state.num_active}; decode (load_image, {first.width}x"
          f"{first.height} PNG) {len(dec.calls)} calls, "
          f"{np.mean(dec.calls) * 1e3:.2f} ms each (median "
          f"{np.median(dec.calls) * 1e3:.2f}; the misses of a batch on the "
          f"loop's pool); batch build on the producer thread: {len(miss)} "
          f"builds with a GT-cache miss, {np.mean(miss) * 1e3:.2f} ms each, "
          f"{len(hit)} all cached, {np.mean(hit) * 1e3:.2f} ms each; "
          f"events: "
          + ", ".join(f"{s}@{i} {w} -> {n}" for s, i, w, n in probe.events),
          flush=True)
    del state
    # the render CLI over the test split, lang mode
    argv_r = ["--model_path", model_path, "--source_path", rel,
              "--configs", cfg_file, "--mode", "lang",
              "--load_stage", "fine-lang", "--skip_train", "--skip_video",
              "--novideo", "1", "--noimage", "1"] + device
    before = C.composite_stream.launches
    with FirstComposite() as first_c:
        fps = render_cli.main(argv_r)["test"]
    render_launches = C.composite_stream.launches - before
    first_c.hold(26, "the render CLI's test frame 0 at fine-lang")
    out = os.path.join(model_path, "test_lang", f"ours_{iters[3]}")
    maps = sorted(os.listdir(os.path.join(out, "renders_npy")))
    m0 = np.load(os.path.join(out, "renders_npy", maps[0]))
    print(f"[26] render CLI: {len(maps)} test frames in lang mode, FPS "
          f"{fps:.3f}, composite_stream launches {render_launches}",
          flush=True)
    if (len(maps) != len(test) or m0.shape != (first.height, first.width,
                                               AE_ENC[-1])
            or not np.isfinite(m0).all()):
        raise AssertionError("the render CLI wrote bad maps")
    if on_card and render_launches < len(test):
        raise AssertionError("the render kernel did not launch per frame")
    launches = {n: getattr(C, n).launches for n in names}
    launches["plane_grad"] = G.plane_grad.launches
    # the eval CLI on those renders; the prompts' embeddings are their
    # features through the autoencoder's decoder, as the renders' are
    ae = load_ckpt(ae_ckpt, AE_ENC, AE_DEC, device="cpu")

    def decoded(table):
        with torch.no_grad():
            return ae.decode(torch.from_numpy(table).float()).numpy()
    miou, probe_e, *_ = annotate_and_eval(
        dev, rel, ae_ckpt, out, list(test), iters[3],
        os.path.join(root, "eval"), 26, dataset_type="neu3d",
        embed=decoded)
    if not (len(probe_e.results) == len(test) and miou is not None
            and 0.0 <= miou <= 1.0):
        raise AssertionError(f"the eval gave Mean IoU {miou}")
    if on_card:
        for k in ("composite_tiles", "composite_tiles_backward",
                  "composite_stream", "plane_grad"):
            if not launches[k]:
                raise AssertionError(f"{k} never launched in phase 26")
    print("[26] launches in the CLIs' runs: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()), flush=True)
    # fine-base in turns at two GT-cache sizes
    cfg = Config()
    apply_overrides(cfg, load_py_config(cfg_file))
    cfg.model.source_path = rel
    cfg.model.model_path = os.path.join(root, "turns")
    cfg.extras.test_iterations, cfg.extras.save_iterations = [], []
    cfg.extras.checkpoint_iterations = []
    rates = []
    for mb in CACHE_TURNS_MB:
        cfg.runtime.gt_cache_mb = mb
        cache = gt_cache.get_cache(mb, dev)
        cache.clear()
        hits, misses = cache.hits, cache.misses
        st, dcfg = loop.init_state_from_scene(cfg, scene, seed=0, device=dev)
        with StepStamps() as stamps:
            loop.scene_reconstruction(cfg, scene, st, dcfg, "fine-base",
                                      False, turn_iters, Timer())
        if on_card:
            torch.cuda.synchronize()
        rates.append(stamps.rate(turn_timed))
        print(f"[26] fine-base at gt_cache_mb {mb}: {turn_iters} iterations, "
              f"{rates[-1]:.3f} it/s over the last {turn_timed}; cache "
              f"{cache.hits - hits} hits, {cache.misses - misses} misses",
              flush=True)
        del st
    big = [r for mb, r in zip(CACHE_TURNS_MB, rates) if mb == 4096]
    small = [r for mb, r in zip(CACHE_TURNS_MB, rates) if mb != 4096]
    print(f"[26] fine-base it/s in turns (4096, 256, 256, 4096 MB): "
          + ", ".join(f"{r:.3f}" for r in rates)
          + f"; 256 MB / 4096 MB {np.mean(small) / np.mean(big):.4f}",
          flush=True)
    gt_cache.get_cache(cfg.runtime.gt_cache_mb, dev).clear()
    return launches


def formats_phase(dev, root, iters=5, hw=(48, 64), n=20_000, net_width=None):
    """Phase 27: the other formats, each a tiny scene the phase writes from
    `n` seeded Gaussians (bench_workload's kind). Blender (configs/dnerf's
    preset; RGBA frames composited and resized to 800x800), COLMAP (JPEG
    frames from the port's encoder) and MultipleView (its preset):
    `training(cfg)` for `iters` iterations of coarse-base and of fine-base,
    which must launch kernels 1 and 2 and keep the loss finite.
    PanopticSports (JPEG ims/, a principal point off the centre): the
    reader and render_set of its test cameras through kernel 3, frame 0
    held against the plain version on its rows. `net_width` narrows the
    presets' networks for a CPU rehearsal."""
    from langsplat4d_torch.checkpoint import TrainedModel
    from langsplat4d_torch.config import (Config, apply_overrides,
                                          load_py_config)
    from langsplat4d_torch.ops import composite as C
    from langsplat4d_torch.render.driver import render_set
    from langsplat4d_torch.train import loop
    on_card = dev.type == "cuda"
    shutil.rmtree(root, ignore_errors=True)
    gs, dcfg, net, aabb, _ = bench_workload(dev, frames=1, n=n, hw=hw)
    workload = (gs, dcfg, net, aabb)
    for kind, writer, preset in (
            ("blender", write_blender_scene, ("dnerf", "dnerf_default.py")),
            ("colmap", write_colmap_scene, None),
            ("multipleview", write_multipleview_scene,
             ("multipleview", "default.py"))):
        d = os.path.join(root, kind)
        writer(d, dev, workload)
        cfg = Config()
        if preset:
            apply_overrides(cfg, load_py_config(os.path.join(
                REPO, "configs", *preset)))
        if net_width:
            cfg.hidden.net_width = net_width
        cfg.model.source_path = d
        cfg.model.model_path = os.path.join(d, "model")
        cfg.runtime.watchdog_execv = False
        cfg.extras.test_iterations, cfg.extras.save_iterations = [], []
        cfg.extras.checkpoint_iterations = []
        for k, v in zip(("coarse_base_iterations", "coarse_lang_iterations",
                         "fine_base_iterations", "fine_lang_iterations"),
                        (iters, 0, iters, 0)):
            setattr(cfg.optim, k, v)
        before = {k: getattr(C, k).launches for k in (
            "composite_tiles", "composite_tiles_backward")}
        with LoopProbe(dev) as probe:
            t0 = time.perf_counter()
            state = loop.training(cfg, device=dev)
            secs = time.perf_counter() - t0
        got = {k: getattr(C, k).launches - v for k, v in before.items()}
        losses = probe.losses("coarse-base") + probe.losses("fine-base")
        scene = loop.Scene(d)
        cam = scene.getTrainCameras()[0]
        print(f"[27] {kind}: {len(scene.getTrainCameras())} train / "
              f"{len(scene.getTestCameras())} test cameras at "
              f"{cam.width}x{cam.height}; training(cfg) {iters} coarse-base "
              f"+ {iters} fine-base iterations in {secs:.1f} s, "
              f"{state.num_active} Gaussians, loss first {losses[0]:.4f} "
              f"last {losses[-1]:.4f}; launches "
              + ", ".join(f"{k} {v}" for k, v in got.items()), flush=True)
        if len(losses) != 2 * iters or not np.isfinite(losses).all():
            raise AssertionError(f"{kind}: a loss is not finite")
        if on_card and not all(got.values()):
            raise AssertionError(f"{kind}: kernels 1 and 2 did not launch")
        del state
    d = os.path.join(root, "panoptic")
    write_panoptic_scene(d, dev, workload)
    scene = loop.Scene(d)
    views = list(scene.getTestCameras())
    cfg = Config()
    cfg.model.model_path = os.path.join(d, "model")
    cfg.model.white_background = False
    cfg.runtime.nonormalized = False
    model = TrainedModel(gaussians=gs, deform=net, aabb=aabb,
                         active_sh_degree=3)
    before = C.composite_stream.launches
    with FirstComposite() as first_c:
        fps = render_set(cfg, model, dcfg, scene, "test", 0, views,
                         mode="rgb", load_stage="fine-lang", novideo=True)
    launches = C.composite_stream.launches - before
    first_c.hold(27, "PanopticSports test frame 0")
    cam = views[0]
    print(f"[27] PanopticSports: {len(scene.getTrainCameras())} train / "
          f"{len(views)} test cameras at {cam.width}x{cam.height}, K "
          f"principal point ({cam.K[0, 2]:.1f}, {cam.K[1, 2]:.1f}); "
          f"render_set FPS {fps:.3f}, composite_stream launches {launches}",
          flush=True)
    if on_card and launches < len(views):
        raise AssertionError("PanopticSports: the render kernel did not "
                             "launch per frame")
    return launches


# --------------------------------------------------------------------------
# phase 28: the multi-rank path (langsplat4d_torch/parallel/): tile-band
# rendering in both exchanges and the data x gauss-sharded step, the ranks
# spawned on the one card with gloo (NCCL refuses two ranks on one device);
# the ranks take turns on the card, so no number here is a speed-up

BAND_SHARDS = (2, 3)        # 32 tile rows at 32 px: 16 + 16, 11 + 11 + 10
BAND_FRAMES = 10
BAND_TIMED = 3              # frames timed stage by stage after render_set
MESH_SHAPE = (2, 2)         # data x gauss
MESH_STEPS = 20
# the train CLI on two ranks: a further cut of phase 24's depth (at
# 60/20/60/20 it took a third of the phase); densify and prune fire at 10
# and 20 and the opacity reset at 15 in both base stages
MESH_CLI_ITERS = (20, 10, 20, 10)
MESH_CLI_CUTS = dict(densify_from_iter=5, densification_interval=10,
                     pruning_from_iter=5, pruning_interval=10,
                     min_points_for_prune=50_000, opacity_reset_interval=15)
RANK_TIMEOUT = 600          # seconds a spawned group or a collective waits


def band_cases():
    """(tile_size, hard_cutoffs, height, width, pw, bands) cases of kernel
    3 in bands: even and uneven splits, a last band cut by the image's edge
    and, at 5 tile rows over 4 bands, an empty band."""
    return [(32, True, 100, 150, 16, 2), (32, True, 100, 150, 16, 3),
            (16, True, 80, 64, 16, 4), (16, False, 100, 150, 24, 3),
            (32, False, 72, 110, 32, 2)]


def compare_band_case(ts, hard, h, w, pw, bands, device, seed=0):
    """Kernel 3 on each band of a synthetic stream (`tile_row0`) against its
    plain version on the band, and against the same rows of the kernel's
    whole-image launch -> (max abs error vs plain, whether every band is
    bit-equal to the whole image's rows)."""
    from langsplat4d_torch.ops.composite import (composite_stream,
                                                 composite_stream_plain)
    g = torch.Generator().manual_seed(seed)
    tx, ty = -(-w // ts), -(-h // ts)
    rows, starts = synthetic_stream(tx, ty, ts, case_segments(tx * ty, g), g,
                                    pw=pw)
    rows, starts = rows.to(device), starts.to(device)
    bg = torch.tensor([0.2, 0.5, 0.8], device=device)
    whole = composite_stream(rows, starts, bg, tiles_x=tx, tiles_y=ty,
                             tile_size=ts, height=h, width=w,
                             hard_cutoffs=hard)
    band_rows = -(-ty // bands)
    err, equal = 0.0, True
    for b in range(bands):
        ty0 = b * band_rows
        height = max(0, min(band_rows * ts, h - ty0 * ts))
        t0, t1 = min(ty0, ty) * tx, min(ty0 + band_rows, ty) * tx
        seg = starts[t0:t1 + 1].long()
        # the band's tiles past the image's last row have empty segments
        st = torch.cat([seg, seg[-1:].expand(band_rows * tx - (t1 - t0))])
        lo = int(seg[0])
        kw = dict(tiles_x=tx, tiles_y=band_rows, tile_size=ts, height=height,
                  width=w, hard_cutoffs=hard, tile_row0=ty0)
        band_rows_t = rows[lo:max(int(seg[-1]), lo)].contiguous()
        st = (st - lo).to(torch.int32)
        out = composite_stream(band_rows_t, st, bg, **kw)
        ref = composite_stream_plain(band_rows_t, st, bg, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize()
        if out.shape != (pw - 7, height, w):
            raise AssertionError(f"bad band output {tuple(out.shape)}")
        if height:
            err = max(err, float((out - ref).abs().max()))
        equal &= torch.equal(out, whole[:, ty0 * ts:ty0 * ts + height])
    return err, equal


class KeepFirst:
    """Keeps the arguments and the result of the first call of a module's
    function while entered. A kernel wrapper counts its launches on the
    name it is bound to in its own module, so where that is the name
    replaced here, the count moves on the stand-in while entered and is
    carried back to the wrapper after."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.own = (module.__name__ == self.fn.__module__
                    and hasattr(self.fn, "launches"))
        self.first = None

    def __enter__(self):
        def kept(*a, **k):
            out = self.fn(*a, **k)
            if self.first is None:
                self.first = (a, k, out)
            return out
        if self.own:
            kept.launches = self.fn.launches
        self.kept = kept
        setattr(self.module, self.name, kept)
        return self

    def __exit__(self, *exc):
        if self.own:
            self.fn.launches = self.kept.launches
        setattr(self.module, self.name, self.fn)


def spawn_ranks(fn, world, root, *args, backend="gloo"):
    """fn(rank, world, *args) in `world` processes (spawned) of one process
    group over a file:// store in `root`; raises where a rank raised or the
    group outlasted RANK_TIMEOUT, and leaves no process behind."""
    import torch.multiprocessing as mp
    store = os.path.join(root, f"store_{fn.__name__}_{time.time_ns()}")
    ctx = mp.start_processes(_rank_entry,
                             args=(fn, world, store, backend, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks "
                                   f"outlasted {RANK_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


def _rank_entry(rank, fn, world, store, backend, args):
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    logging.basicConfig(level=logging.WARNING, format="%(message)s")
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
    else:                                   # a rehearsal on the CPU
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def band_config(model_path, shards):
    from langsplat4d_torch.config import Config
    cfg = Config()
    cfg.model.model_path = model_path
    cfg.model.white_background = False
    cfg.runtime.render_tile_size = RENDER_TILE_SIZE
    cfg.runtime.nonormalized = False
    cfg.runtime.gaussian_shards = shards
    return cfg


class StageClock:
    """Marks between the stages of a pass: CUDA events on the card (read
    after a synchronize), the host's clock on the CPU."""

    def __init__(self, dev):
        self.on_card = dev.type == "cuda"
        self.names, self.stamps = [], []

    def __call__(self, name):
        if self.on_card:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
        else:
            e = time.perf_counter()
        self.names.append(name)
        self.stamps.append(e)

    def ms(self):
        """{stage: ms from the mark before}."""
        if self.on_card:
            torch.cuda.synchronize()
        return {self.names[j]: (
            self.stamps[j - 1].elapsed_time(self.stamps[j]) if self.on_card
            else 1e3 * (self.stamps[j] - self.stamps[j - 1]))
            for j in range(1, len(self.names))}


def _peak_memory(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _rank_device():
    return (torch.device("cuda", 0) if torch.cuda.is_available()
            else torch.device("cpu"))


def band_stage_ms(mesh, settings, dcfg, gs, net, aabb, views, exchange):
    """ms a frame by stage (CUDA events on this rank's stream, mean of
    BAND_TIMED frames after a warm-up one; a collective's stage holds its
    host copies and its wait for the other ranks) and the bytes this rank
    sends a frame."""
    from langsplat4d_torch.field.deformation import make_grid_spatial_cache
    from langsplat4d_torch.parallel.render import (gather_bands,
                                                   render_frame_banded)
    dev = gs.device
    bg = torch.zeros(3, device=dev)
    grid_spatial = make_grid_spatial_cache(net, dcfg, aabb, gs.xyz)
    tot, stats = {}, {}
    timed = min(BAND_TIMED, len(views) - 1)
    for i in range(timed + 1):
        clock = StageClock(dev)
        clock("start")
        cam = views[i].camera_params(dev)
        frame_stats = {}
        out = render_frame_banded(
            settings, dcfg, "fine-lang", cam, views[i].time, gs, net, aabb,
            bg, mesh, grid_spatial=grid_spatial, exchange=exchange,
            stats=frame_stats, timer=clock)
        gather_bands(out["language_feature_image"], settings, mesh)
        clock("stitch")
        if i:                                    # frame 0 warms up
            for k, v in clock.ms().items():
                tot[k] = tot.get(k, 0.0) + v / timed
            stats = frame_stats
    return tot, stats.get("bytes", 0)


def band_rank(rank, world, root, frames, workload_kw, t_spawn):
    """One rank of the band render: the bench workload, render_set with
    gaussian_shards = world in both exchanges (rank 0 writes the frames),
    kernel 3's first band held against its plain version, then the stage
    times; saves its numbers to root/band{world}.{rank}."""
    from langsplat4d_torch.checkpoint import TrainedModel
    from langsplat4d_torch.ops import composite as C
    from langsplat4d_torch.parallel import render as PR
    from langsplat4d_torch.parallel.mesh import make_mesh, shard_gaussians
    from langsplat4d_torch.render.driver import render_set
    from langsplat4d_torch.render.raster import RasterSettings
    dev = _rank_device()
    gs, dcfg, net, aabb, views = bench_workload(dev, frames=frames,
                                                **workload_kw)
    model = TrainedModel(gaussians=gs, deform=net, aabb=aabb,
                         active_sh_degree=3)
    mesh = make_mesh(1, world)
    settings = RasterSettings(image_height=views[0].height,
                              image_width=views[0].width, sh_degree=3,
                              tile_size=RENDER_TILE_SIZE)
    res = dict(ready=time.time() - t_spawn)
    for exchange in ("allgather", "alltoall"):
        os.environ["LS4D_BAND_EXCHANGE"] = exchange
        cfg = band_config(os.path.join(root, f"band{world}_{exchange}"),
                          world)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        C.composite_stream.launches = 0
        t0 = time.perf_counter()
        with KeepFirst(PR, "composite_stream") as first, torch.no_grad():
            fps = render_set(cfg, model, dcfg, None, "video", 0, views,
                             mode="lang", load_stage="fine-lang",
                             noimage=True, nonpy=False, novideo=True)
        secs = time.perf_counter() - t0
        launches = C.composite_stream.launches
        (rows, starts, bg), kw, img = first.first
        err = 0.0
        if exchange == "allgather":      # the band's rows are the same in
            with torch.no_grad():        # both exchanges: held once
                ref = C.composite_stream_plain(rows, starts, bg, **kw)
            err = float((img - ref).abs().max()) if img.numel() else 0.0
        with torch.no_grad():
            stage_ms, sent = band_stage_ms(
                mesh, settings, dcfg, shard_gaussians(gs, mesh), net, aabb,
                views, exchange)
        res[exchange] = dict(
            fps=fps, secs=secs, launches=launches, err=err,
            pairs=int(starts[-1]), tile_row0=kw["tile_row0"],
            band_rows=kw["tiles_y"], stage_ms=stage_ms, bytes=sent,
            max_mem=_peak_memory(dev))
    torch.save(res, os.path.join(root, f"band{world}.{rank}"))


def two_camera_batch(batch, dev):
    """The training workload's batch with a second camera (the same view
    at time 0.7, its own seeded ground truth), so that the data axis
    splits it."""
    from langsplat4d_torch.render.raster import CameraParams
    from langsplat4d_torch.train.step import Batch
    rng = np.random.default_rng(2)
    _, lang_dim, H, W = batch.gt_lang.shape

    def up(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)
    return Batch(
        cams=CameraParams(*[torch.cat([t, t]) for t in batch.cams]),
        times=torch.tensor([0.3, 0.7], device=dev),
        gt_images=torch.cat([batch.gt_images,
                             up(rng.uniform(size=(1, 3, H, W)))]),
        gt_lang=torch.cat([batch.gt_lang,
                           up(rng.normal(size=(1, lang_dim, H, W)))]),
        lang_mask=torch.cat([batch.lang_mask, batch.lang_mask]))


def _excess(got, want):
    """The gradient bound relative to the leaf's largest entry: max of
    |got - want| - (2e-4 scale + 2e-3 |want|), <= 0 within it."""
    return scaled_errors(got.float(), want.float())[1]


def mesh_train_rank(rank, world, root, steps, workload_kw, t_spawn):
    """One rank of the sharded step: phase 8's workload with a batch of two
    cameras on the MESH_SHAPE mesh, `steps` train_steps; after each, the
    whole state gathered and, on rank 0, held against the one-rank step on
    the same batch (parameters and Adam moments, the gradient bound of
    each leaf's largest entry); then densify and prune under the mesh
    against one rank. Kernels 1 and 2 of the first mesh step are held
    against their plain versions on their inputs. Saves its numbers to
    root/mesh.{rank}."""
    from langsplat4d_torch.ops import composite as C
    from langsplat4d_torch.parallel.mesh import (apply_unsharded, make_mesh,
                                                 shard_batch, shard_state,
                                                 unshard_state)
    from langsplat4d_torch.train import densify as D
    from langsplat4d_torch.train.step import train_step
    from langsplat4d_torch.train.trainstate import GAUSSIAN_KEYS
    dev = _rank_device()
    torch.use_deterministic_algorithms(True, warn_only=True)
    state, cfg, batch, bg = train_workload(dev, **workload_kw)
    batch = two_camera_batch(batch, dev)
    mesh = make_mesh(*MESH_SHAPE)
    mcfg = cfg._replace(mesh=mesh)
    ref = copy.deepcopy(state) if rank == 0 else None
    sharded = shard_state(state, mesh)
    local = shard_batch(batch, mesh)
    ready = time.time() - t_spawn
    names = ("composite_tiles", "composite_tiles_backward")
    launches = dict.fromkeys(names, 0)
    worst, step_ms, losses = {}, [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for it in range(1, steps + 1):
        before = {n: getattr(C, n).launches for n in names}
        clock = StageClock(dev)
        with KeepFirst(C, names[0]) as fwd, KeepFirst(C, names[1]) as bwd:
            clock("start")
            sharded, metrics, vs, vis, rmax = train_step(
                mcfg, sharded, local, bg, it, 3)
            clock("step")
        D.update_max_radii(sharded, rmax, vis)
        D.add_densification_stats(sharded, vs, vis)
        for n in names:
            launches[n] += getattr(C, n).launches - before[n]
        step_ms.append(clock.ms()["step"])
        if it == 1:
            (a, k, out) = fwd.first
            with torch.no_grad():
                f_err = float((out - C.composite_tiles_plain(*a, **k))
                              .abs().max())
                (ab, kb, outb) = bwd.first
                b_excess = max(scaled_errors(
                    outb[..., j], C.composite_tiles_backward_plain(
                        *ab, **kb)[..., j])[1]
                    for j in range(outb.shape[-1]))
            shapes = (tuple(a[0].shape), int(a[1].sum()))
        whole = unshard_state(sharded, mesh)
        if rank == 0:
            counts = {n: getattr(C, n).launches for n in names}
            ref, rmetrics, rvs, rvis, rrmax = train_step(cfg, ref, batch, bg,
                                                         it, 3)
            D.update_max_radii(ref, rrmax, rvis)
            D.add_densification_stats(ref, rvs, rvis)
            for n in names:                  # the reference's launches
                getattr(C, n).launches = counts[n]
            losses.append((float(metrics["loss"]), float(rmetrics["loss"])))
            got, want = whole.leaves(), ref.leaves()
            for tree, gt, wt in (("param", got, want),
                                 ("m", whole.opt.m, ref.opt.m),
                                 ("v", whole.opt.v, ref.opt.v)):
                for k in want:
                    key = f"{tree} {k}" if k in GAUSSIAN_KEYS else \
                        f"{tree} deform"
                    worst[key] = max(worst.get(key, -np.inf),
                                     _excess(gt[k].detach(), wt[k].detach()))
    # densify and prune: on the whole state on every rank, as the loop
    # runs them, against one rank
    dens = dict(max_grad=1e-5, extent=1.6, percent_dense=0.01)
    sharded = apply_unsharded(sharded, mesh, functools.partial(
        D.densify, **dens, generator=torch.Generator(dev).manual_seed(7)))
    sharded = apply_unsharded(sharded, mesh, functools.partial(
        D.prune, min_opacity=0.005, scene_extent=1.6, max_screen_size=20.0))
    whole = unshard_state(sharded, mesh)
    res = dict(ready=ready, step_ms=step_ms, launches=launches, f_err=f_err,
               b_excess=b_excess, shapes=shapes, max_mem=_peak_memory(dev),
               local_rows=sharded.params["xyz"].shape[0])
    if rank == 0:
        n0 = ref.num_active
        ref = D.densify(ref, **dens,
                        generator=torch.Generator(dev).manual_seed(7))
        n1 = ref.num_active
        ref = D.prune(ref, 0.005, 1.6, 20.0)
        n = ref.num_active
        dens_excess = (max(_excess(whole.params[k][:n], ref.params[k][:n])
                           for k in GAUSSIAN_KEYS)
                       if whole.num_active == n else float("inf"))
        res.update(worst=worst, losses=losses,
                   densify=(n0, n1, n, whole.num_active, dens_excess))
    torch.save(res, os.path.join(root, f"mesh.{rank}"))


def nccl_one_rank(dev, gs, dcfg, net, aabb, views, ref_dir, root):
    """render_frame_banded on a world of one rank under NCCL (its
    collectives go through NCCL on the one group), both exchanges, each
    frame bit-equal to the one-process render's -> frames rendered."""
    import datetime
    import torch.distributed as dist
    from langsplat4d_torch.field.deformation import make_grid_spatial_cache
    from langsplat4d_torch.parallel.mesh import make_mesh
    from langsplat4d_torch.parallel.render import render_frame_banded
    from langsplat4d_torch.render.raster import RasterSettings
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(root, 'store_nccl')}",
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    try:
        mesh = make_mesh(1, 1)
        settings = RasterSettings(image_height=views[0].height,
                                  image_width=views[0].width, sh_degree=3,
                                  tile_size=RENDER_TILE_SIZE)
        bg = torch.zeros(3, device=dev)
        with torch.no_grad():
            grid = make_grid_spatial_cache(net, dcfg, aabb, gs.xyz)
            for i, view in enumerate(views):
                want = np.load(os.path.join(ref_dir, f"{i:05d}.npy"))
                for ex in ("allgather", "alltoall"):
                    out = render_frame_banded(
                        settings, dcfg, "fine-lang",
                        view.camera_params(dev), view.time, gs, net, aabb,
                        bg, mesh, grid_spatial=grid, exchange=ex)
                    got = out["language_feature_image"].permute(1, 2, 0)
                    if not np.array_equal(got.cpu().numpy(), want):
                        raise AssertionError(
                            f"NCCL one-rank {ex} frame {i} differs from "
                            "the one-process render")
        return len(views)
    finally:
        dist.destroy_process_group()


def mesh_cli_phase(dev, root, timeout=900, iters=MESH_CLI_ITERS,
                   cuts=MESH_CLI_CUTS, hidden=None):
    """The CLIs on two ranks: `python -m torch.distributed.run
    --standalone --nproc_per_node 2 -m langsplat4d_torch.train` with
    gaussian_shards = 2 on phase 19's scene (phase 22's export) at
    MESH_CLI_ITERS, then `.render --mode lang` of the test split on two
    ranks, and the one-process render CLI on a copy of the same model:
    every frame bit-equal. Prints the seconds of each."""
    from langsplat4d_torch.render import __main__ as render_cli
    model = os.path.join(root, "mesh_cli_model")
    cfg_files = {}
    for shards in (1, 2):
        cfg_files[shards] = os.path.join(root, f"mesh_cli_config{shards}.py")
        with open(cfg_files[shards], "w") as f:
            f.write("_base_ = " + repr(os.path.join(
                REPO, "configs", "hypernerf", "default.py"))
                + f"\nwatchdog_execv = False\ngaussian_shards = {shards}\n"
                + (f"ModelHiddenParams = {hidden!r}\n" if hidden else ""))
    cfg_file = cfg_files[2]
    flags = dict(zip(("coarse_base_iterations", "coarse_lang_iterations",
                      "fine_base_iterations", "fine_lang_iterations"),
                     iters), **cuts)
    argv = (["--source_path", root, "--model_path", model, "--expname",
             "smoke_mesh", "--configs", cfg_file, "--language_features_name",
             f"language_features_dim{AE_ENC[-1]}", "--feature_level", "1",
             "--save_iterations", str(iters[3]), "--port", "-1",
             "--no_dlang", "0", "--dist_backend", "gloo"]
            + [a for k, v in flags.items() for a in (f"--{k}", str(v))])
    env = dict(os.environ, ExpsDir=os.path.join(root, "exps_mesh"))
    device = [] if dev.type == "cuda" else ["--device", "cpu"]
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m"]
    argv += device
    print("[28] train CLI on 2 ranks (gloo, one card): depth "
          + " ".join(f"{k} {v}" for k, v in flags.items()), flush=True)
    secs = {}
    for what, cmd in (
            ("train", run + ["langsplat4d_torch.train"] + argv),
            ("render", run + ["langsplat4d_torch.render", "--model_path",
                              model, "--source_path", root, "--configs",
                              cfg_file, "--mode", "lang", "--load_stage",
                              "fine-lang", "--skip_train", "--skip_video",
                              "--novideo", "1", "--dist_backend", "gloo"]
             + device)):
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True)
        try:
            text, _ = p.communicate(timeout=timeout)
        finally:
            if p.poll() is None:             # its ranks go with it
                os.killpg(p.pid, 9)
                p.wait()
        secs[what] = time.perf_counter() - t0
        tail = "\n".join(text.strip().splitlines()[-8:])
        print(f"[28] {what} CLI on 2 ranks: exit {p.returncode} in "
              f"{secs[what]:.1f} s; its last lines:\n{tail}", flush=True)
        if p.returncode != 0:
            raise AssertionError(f"the {what} CLI on 2 ranks failed")
    one = model + "_one"
    shutil.copytree(model, one, ignore=shutil.ignore_patterns("test_lang"))
    t0 = time.perf_counter()
    render_cli.main(["--model_path", one, "--source_path", root,
                     "--configs", cfg_files[1],
                     "--mode", "lang", "--load_stage", "fine-lang",
                     "--skip_train", "--skip_video", "--novideo", "1"]
                    + device)
    secs["render one"] = time.perf_counter() - t0
    it = iters[3]
    a = sorted(os.listdir(os.path.join(model, "test_lang", f"ours_{it}",
                                       "renders_npy")))
    b = sorted(os.listdir(os.path.join(one, "test_lang", f"ours_{it}",
                                       "renders_npy")))
    if not a or a != b:
        raise AssertionError(f"render CLIs wrote {len(a)} and {len(b)} "
                             "frames")
    worst = 0.0
    for name in a:
        x = np.load(os.path.join(model, "test_lang", f"ours_{it}",
                                 "renders_npy", name))
        y = np.load(os.path.join(one, "test_lang", f"ours_{it}",
                                 "renders_npy", name))
        worst = max(worst, float(np.abs(x - y).max()))
    print(f"[28] render CLI: {len(a)} test frames on 2 ranks against one "
          f"process ({secs['render one']:.1f} s): max abs difference "
          f"{worst:.3g} (frame 0 and every other must be equal)", flush=True)
    if worst != 0.0:
        raise AssertionError("the 2-rank render CLI's frames differ from "
                             "the one-process CLI's")
    return secs


def mesh_phase(dev, scene_root, smi, band_kw=None, train_kw=None,
               cli_kw=None):
    """Phase 28 (see the module's docstring) -> (kernel 3's launches in the
    bands, {kernel: launches in the sharded steps}, kernel 3's worst band
    error, kernel 1's error in the sharded step), launches summed over the
    ranks. `band_kw`, `train_kw` and `cli_kw` size the workloads down for a
    rehearsal on the CPU (bench_workload's, train_workload's and
    mesh_cli_phase's keywords); the card runs the full ones."""
    band_kw, train_kw = band_kw or {}, train_kw or {}
    on_card = dev.type == "cuda"      # the plain versions count nothing
    from langsplat4d_torch.checkpoint import TrainedModel
    from langsplat4d_torch.render.driver import render_set
    root = os.path.join(REPO, "langsplat4d_torch", "_build", "mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    print(f"[28] multi-rank path on {smi}: ranks are processes on this one "
          "card under gloo (NCCL refuses two ranks on one device), taking "
          "turns on it; no number of this phase is a scaling claim",
          flush=True)
    t_phase = time.perf_counter()
    # kernel 3 in bands on synthetic streams
    band_err = 0.0
    for case in band_cases():
        err, equal = compare_band_case(*case, device=dev)
        band_err = max(band_err, err)
        print(f"[28] kernel 3 in {case[5]} bands, ts={case[0]} "
              f"hard={case[1]} {case[2]}x{case[3]} pw={case[4]}: max abs "
              f"err vs plain {err:.3g}, bit-equal to the whole image's "
              f"launch: {equal}", flush=True)
        if not (err <= TOL and equal):
            raise AssertionError("kernel 3 in bands")
    # the one-process render of the frames: the reference
    gs, dcfg, net, aabb, views = bench_workload(dev, frames=BAND_FRAMES,
                                                **band_kw)
    model = TrainedModel(gaussians=gs, deform=net, aabb=aabb,
                         active_sh_degree=3)
    ref_cfg = band_config(os.path.join(root, "band1"), 1)
    with torch.no_grad():
        fps1 = render_set(ref_cfg, model, dcfg, None, "video", 0, views,
                          mode="lang", load_stage="fine-lang", noimage=True,
                          nonpy=False, novideo=True)
    ref_dir = os.path.join(root, "band1", "video_lang", "ours_0",
                           "renders_npy")
    print(f"[28] one process: render_set of {BAND_FRAMES} lang frames of the "
          f"bench workload, FPS {fps1:.3f}", flush=True)
    band_launches = 0
    for world in BAND_SHARDS:
        t0 = time.perf_counter()
        spawn_ranks(band_rank, world, root, root, BAND_FRAMES, band_kw,
                    time.time())
        res = [torch.load(os.path.join(root, f"band{world}.{r}"),
                          weights_only=False) for r in range(world)]
        print(f"[28] gaussian_shards {world}: {world} spawned ranks in "
              f"{time.perf_counter() - t0:.1f} s, each ready (started, "
              f"imported, its workload built) after "
              + ", ".join(f"{r['ready']:.1f}" for r in res) + " s",
              flush=True)
        for ex in ("allgather", "alltoall"):
            out_dir = os.path.join(root, f"band{world}_{ex}", "video_lang",
                                   "ours_0", "renders_npy")
            for i in range(BAND_FRAMES):
                a = np.load(os.path.join(out_dir, f"{i:05d}.npy"))
                b = np.load(os.path.join(ref_dir, f"{i:05d}.npy"))
                if not np.array_equal(a, b):
                    raise AssertionError(
                        f"{ex} on {world} ranks: frame {i} differs from the "
                        f"one-process render by {np.abs(a - b).max()}")
            for r, rr in enumerate(res):
                x = rr[ex]
                band_launches += x["launches"]
                band_err = max(band_err, x["err"])
                print(f"[28] {ex} x{world} rank {r}: band of {x['band_rows']} "
                      f"tile rows from {x['tile_row0']}; render_set FPS "
                      f"{x['fps']:.3f} ({x['secs']:.1f} s with the writes); "
                      f"kernel 3 launches {x['launches']} for "
                      f"{BAND_FRAMES} frames and the warm-up, its first band "
                      f"({x['pairs']} pairs) vs plain max abs err "
                      f"{x['err']:.3g}; ms a frame by stage: "
                      + ", ".join(f"{k} {v:.3f}"
                                  for k, v in x["stage_ms"].items())
                      + f"; sends {x['bytes'] / 1e6:.3f} MB a frame; "
                      f"max_memory_allocated {x['max_mem'] / 2**30:.2f} GiB",
                      flush=True)
                if ((on_card and x["launches"] != BAND_FRAMES + 1)
                        or not x["err"] <= TOL):
                    raise AssertionError(f"{ex} x{world} rank {r}: kernel 3 "
                                         "launches or its error")
            print(f"[28] {ex} x{world}: rank 0's {BAND_FRAMES} stitched "
                  "frames bit-equal to the one-process render; dropped 0",
                  flush=True)
    n = (nccl_one_rank(dev, gs, dcfg, net, aabb, views, ref_dir, root)
         if dev.type == "cuda" else 0)
    print(f"[28] NCCL, a world of one rank: render_frame_banded in both "
          f"exchanges, {n} frames each bit-equal to the one-process render",
          flush=True)
    del gs, net, model
    torch.cuda.empty_cache()
    # the sharded step
    t0 = time.perf_counter()
    spawn_ranks(mesh_train_rank, MESH_SHAPE[0] * MESH_SHAPE[1], root, root,
                MESH_STEPS, train_kw, time.time())
    res = [torch.load(os.path.join(root, f"mesh.{r}"), weights_only=False)
           for r in range(MESH_SHAPE[0] * MESH_SHAPE[1])]
    mesh_launches = {k: sum(r["launches"][k] for r in res)
                     for k in res[0]["launches"]}
    r0 = res[0]
    print(f"[28] sharded step: data {MESH_SHAPE[0]} x gauss {MESH_SHAPE[1]} "
          f"= {len(res)} spawned ranks, phase 8's workload with a batch of "
          f"2 cameras (one per data rank), {MESH_STEPS} steps in "
          f"{time.perf_counter() - t0:.1f} s; kernel 1 on the first step's "
          f"lists {r0['shapes']} vs plain max abs err {r0['f_err']:.3g}, "
          f"kernel 2 excess over the gradient bound {r0['b_excess']:.3g}",
          flush=True)
    for r, x in enumerate(res):
        print(f"[28] rank {r}: ready after {x['ready']:.1f} s; "
              f"{x['local_rows']} rows; ms a step median "
              f"{np.median(x['step_ms']):.3f} (CUDA events; the rank's "
              f"collectives included); launches "
              + ", ".join(f"{k} {v}" for k, v in x["launches"].items())
              + f"; max_memory_allocated {x['max_mem'] / 2**30:.2f} GiB",
              flush=True)
        if on_card and min(x["launches"].values()) < MESH_STEPS:
            raise AssertionError(f"rank {r}: kernels 1-2 did not launch "
                                 "every step")
    print("[28] loss (mesh, one rank): " + ", ".join(
        f"{a:.6f}/{b:.6f}" for a, b in r0["losses"][::5]), flush=True)
    print("[28] after each step, the gathered state against one rank's, "
          "worst excess over rtol 2e-3 / atol 2e-4 of the leaf's largest "
          "entry (<= 0 holds): " + ", ".join(
              f"{k} {v:.3g}" for k, v in r0["worst"].items()), flush=True)
    n0, n1, n, nm, dx = r0["densify"]
    print(f"[28] densify + prune under the mesh: num_active {n0} -> {n1} -> "
          f"{n} (mesh {nm}); rows' excess {dx:.3g}", flush=True)
    if (r0["f_err"] > TOL or r0["b_excess"] > 0
            or max(r0["worst"].values()) > 0 or nm != n or dx > 0
            or any(abs(a - b) > 1e-5 * abs(b) for a, b in r0["losses"])):
        raise AssertionError("the sharded step differs from one rank's")
    secs = mesh_cli_phase(dev, scene_root, **(cli_kw or {}))
    print(f"[28] phase 28 took {time.perf_counter() - t_phase:.1f} s "
          f"(CLIs: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + ")", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return band_launches, mesh_launches, band_err, r0["f_err"]


# phase 29: the offline preprocessing on HyperNeRF's rgb/2x frames
PRE_FRAMES = 8
PRE_HW = (536, 960)
PRE_LEVELS = (100, 75, 50, 30)     # segments a level: default, s, m, l
PRE_CANDIDATES = 100               # SAM-style candidates a level and frame
PRE_BACKGROUND = 8                 # level-l segments that the id maps zero
PRE_AE_EPOCHS = 5
PRE_EMBED_DIM = 4096               # an e5-mistral-7b-instruct embedding's
PRE_FEATURE_TOL = 1e-3             # fp16 features, card against CPU
PRE_CHECK_FRAMES = 2               # frames run again on the CPU


def preprocess_scene(dev, root, frames=PRE_FRAMES, hw=PRE_HW,
                     levels=PRE_LEVELS, seed=29):
    """Phase 29's inputs, written under `root`: frames rgb/2x/{i:06}.png
    (seeded texture), masks/{i:06}.npy (a [4, H, W] int32 stack a frame:
    nearest-seed segments, `levels` of them a level, the seeds drifting
    from frame to frame) and objects/{i:06}.npy (the id map of the
    prompts: level l's labels, the first PRE_BACKGROUND of them zeroed as
    background)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    seeds = [rng.random((n, 2)) * (h, w) for n in levels]
    drift = [rng.normal(0, 4, (n, 2)) for n in levels]
    yy, xx = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    pix = torch.stack([yy.reshape(-1), xx.reshape(-1)], 1).float()
    items = []
    from langsplat4d_torch.data.png import png_bytes
    for i in range(1, frames + 1):
        img = texture(h, w, 3, seed=seed + i)
        items.append((os.path.join(root, "rgb", "2x", f"{i:06}.png"),
                      functools.partial(png_bytes, img)))
        stack = []
        for s, d in zip(seeds, drift):
            c = torch.from_numpy(s + i * d).float().to(dev)
            stack.append(torch.cdist(pix, c).argmin(1).reshape(h, w) + 1)
        stack = torch.stack(stack).to(torch.int32).cpu().numpy()
        ids = np.where(stack[3] <= PRE_BACKGROUND, 0, stack[3])
        for sub, arr in (("masks", stack), ("objects", ids)):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            np.save(os.path.join(root, sub, f"{i:06}.npy"), arr)
    write_files(items)


def sam_candidates(labels, n, cap, rng):
    """~`cap` SAM-style candidate dicts from one level's [H, W] labels 1..n
    on its device: segments, near-duplicates (shifted 1 and 2 px), contained
    masks (eroded by 2 px) and unions of neighbouring labels, with seeded
    stability and predicted-IoU scores (a twentieth below the 0.1 floor)."""
    dev = labels.device
    segs = labels[None] == torch.arange(1, n + 1, device=dev)[:, None, None]
    m = min(n, cap // 2)
    eroded = 1 - torch.nn.functional.max_pool2d(
        1 - segs[m // 2:m, None].float(), 5, 1, 2)[:, 0]
    j = torch.arange(cap - 2 * m, device=dev) % (n - 1)
    cand = torch.cat([segs[:m], torch.roll(segs[:m // 2], (1, 2), (1, 2)),
                      eroded > 0, segs[j] | segs[j + 1]])
    stab = rng.uniform(0.6, 1.0, len(cand))
    stab[rng.random(len(cand)) < 0.05] = 0.05
    piou = rng.uniform(0.5, 1.0, len(cand))
    return [{"segmentation": c, "stability_score": float(a),
             "predicted_iou": float(b), "id": k}
            for k, (c, a, b) in enumerate(zip(cand, stab, piou))]


class StandInEncoder:
    """The CLIP image tower's seeded stand-in: a fixed linear map of the
    tiles (a 14x14 average pool to [3, 16, 16], then a [768, 512] matrix),
    in fp32 with TF32 off. With `record`, keeps a hash of the bytes of each
    batch of tiles it is given."""

    def __init__(self, dev, record=False, seed=29):
        w = np.random.default_rng(seed).standard_normal((768, CLIP_DIM))
        self.w = torch.from_numpy((w / np.sqrt(768)).astype(np.float32)
                                  ).to(dev)
        self.record, self.hashes = record, []

    def __call__(self, tiles):
        from langsplat4d_torch.core.device import fp32_matmul
        if self.record:
            self.hashes.append(hashlib.sha1(
                (tiles * 255).round().to(torch.uint8).cpu().numpy()
                .tobytes()).hexdigest())
        with fp32_matmul():
            return (torch.nn.functional.avg_pool2d(tiles, 14).flatten(1)
                    @ self.w)


class StandInCaptioner:
    """Qwen2-VL's stand-in: captions made from the frames' names."""

    def caption_video(self, frame_paths, prompt):
        return (f"object {os.path.basename(os.path.dirname(frame_paths[0]))}"
                f" over {len(frame_paths)} frames")

    def caption_frames(self, frame_paths, prompt):
        return "state at " + " ".join(os.path.basename(p)[:6]
                                      for p in frame_paths)


def stand_in_embedding(text):
    """e5-mistral-7b-instruct's stand-in: a seeded 4096-d float32 vector
    from the text's CRC, made on the host (the same on every device)."""
    import zlib
    return np.random.default_rng(zlib.crc32(text.encode())).standard_normal(
        PRE_EMBED_DIM).astype(np.float32)


def same_files(a, b):
    """Relative paths of the files under `a` whose bytes differ from (or
    are missing under) `b`."""
    from pathlib import Path
    bad = []
    for f in sorted(Path(a).rglob("*")):
        other = Path(b) / f.relative_to(a)
        if f.is_file() and (not other.is_file()
                            or other.read_bytes() != f.read_bytes()):
            bad.append(str(f.relative_to(a)))
    return bad


def preprocess_phase(dev, root, frames=PRE_FRAMES, hw=PRE_HW,
                     levels=PRE_LEVELS, cap=PRE_CANDIDATES,
                     epochs=PRE_AE_EPOCHS, check=PRE_CHECK_FRAMES, smi=""):
    """Phase 29 (see the module's docstring). Every stage runs on `dev`
    over all frames, and again with device="cpu" in this process over the
    first `check` frames (the video features over all): NMS indices, tiles,
    seg maps, prompt PNGs and the video-feature files must be equal, the
    fp16 CLIP features within PRE_FEATURE_TOL. Returns the per-stage ms a
    frame, taken on `dev` after a first run (warm)."""
    from langsplat4d_torch.ae import test as ae_test
    from langsplat4d_torch.ae import train as ae_train
    from langsplat4d_torch.data.codec import read_image
    from langsplat4d_torch.preprocess import clip_features as CF
    from langsplat4d_torch.preprocess import image_prompt as IP
    from langsplat4d_torch.preprocess import mask_nms as MN
    from langsplat4d_torch.preprocess import video_captions as VC
    from langsplat4d_torch.preprocess import video_features as VF
    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    preprocess_scene(dev, root, frames, hw, levels)
    images = sorted(os.path.join(root, "rgb", "2x", f)
                    for f in os.listdir(os.path.join(root, "rgb", "2x")))
    stacks = sorted(os.path.join(root, "masks", f)
                    for f in os.listdir(os.path.join(root, "masks")))
    objects = os.path.join(root, "objects")
    print(f"[29] preprocessing on {smi or dev}: {frames} frames at "
          f"{hw[1]}x{hw[0]} (HyperNeRF's rgb/2x), {len(levels)}-level stacks "
          f"of {'/'.join(map(str, levels))} segments; the encoder, captioner "
          f"and embedder are seeded stand-ins (a fixed linear map of the "
          f"tiles to {CLIP_DIM}-d, captions from the frame names, "
          f"{PRE_EMBED_DIM}-d vectors from the text's CRC): no number here "
          f"is a CLIP, Qwen2-VL or e5 time; frames 1-{check} again on the "
          f"CPU", flush=True)
    ms, cpu_s = {}, {}

    def clock():
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    # masks_update on SAM-style candidates, every level of every frame
    def nms_run(side, n_frames):
        out, secs = [], []
        for fi, path in enumerate(stacks[:n_frames]):
            stack = torch.from_numpy(np.load(path)).to(dev)
            for lvl, n in enumerate(levels):
                cands = sam_candidates(stack[lvl], n, cap,
                                       np.random.default_rng(fi * 7 + lvl))
                for c in cands:
                    c["segmentation"] = c["segmentation"].to(side)
                t0 = clock()
                (got,) = MN.masks_update(cands, device=side)
                secs.append(clock() - t0)
                out.append([c["id"] for c in got])
        return out, sum(secs)
    nms_run(dev, 1)                                           # warm-up
    kept, t_nms = nms_run(dev, frames)
    t0 = clock()
    kept_cpu, _ = nms_run(cpu, check)
    cpu_s["masks_update"] = clock() - t0
    ms["masks_update"] = t_nms * 1e3 / frames
    diff = sum(a != b for a, b in zip(kept, kept_cpu))
    print(f"[29] masks_update: {frames * len(levels)} calls of "
          f"{cap} candidates, {sum(map(len, kept))} kept; "
          f"{ms['masks_update']:.3f} ms a frame ({len(levels)} calls; wall "
          f"clock, synchronised); against the CPU: {diff} of "
          f"{len(kept_cpu)} calls keep other masks", flush=True)
    if diff:
        raise AssertionError("masks_update: the card keeps other masks "
                             "than the CPU")

    # process_sequence: tiles, seg maps, features on disk; against the CPU
    lf, lf_cpu = (os.path.join(root, sub, "language_features")
                  for sub in ("", "cpu"))
    enc = StandInEncoder(dev, record=True)
    CF.process_sequence(images, stacks, lf, enc, device=dev)
    enc_cpu = StandInEncoder(cpu, record=True)
    t0 = clock()
    CF.process_sequence(images[:check], stacks[:check], lf_cpu, enc_cpu,
                        device=cpu)
    cpu_s["process_sequence"] = clock() - t0
    checked = sorted(os.listdir(lf_cpu))
    seg_bad = [f for f in same_files(lf_cpu, lf) if f.endswith("_s.npy")]
    f_err = max(float(np.abs(
        np.load(os.path.join(lf, f)).astype(np.float32)
        - np.load(os.path.join(lf_cpu, f)).astype(np.float32)).max())
        for f in checked if f.endswith("_f.npy"))
    tiles_equal = enc.hashes[:len(enc_cpu.hashes)] == enc_cpu.hashes
    print(f"[29] process_sequence against the CPU: the tiles of "
          f"{len(enc_cpu.hashes)} encoder calls byte-equal: {tiles_equal}; "
          f"{len(seg_bad)} of {len(checked) // 2} seg maps differ; fp16 "
          f"features max abs err {f_err:.3g} (<= {PRE_FEATURE_TOL}: the "
          f"stand-in's products summed in another order)", flush=True)
    if not tiles_equal or seg_bad or not f_err <= PRE_FEATURE_TOL:
        raise AssertionError(f"process_sequence: {seg_bad}, {f_err}")
    enc = StandInEncoder(dev)
    t0 = clock()
    CF.process_sequence(images, stacks, lf, enc, device=dev)
    ms["process_sequence"] = (clock() - t0) * 1e3 / frames
    stage = dict.fromkeys(("decode", "masks_from_stack", "mask2segmap",
                           "encoder"), 0.0)
    for img_path, seg_path in zip(images, stacks):
        t0 = clock()
        image = CF.rgb(torch.from_numpy(read_image(img_path)).to(dev))
        stack = torch.from_numpy(np.load(seg_path)).to(dev)
        t1 = clock()
        lv = CF.masks_from_stack(stack, dev)
        t2 = clock()
        tiles = [CF.mask2segmap(m, image, dev)[0] for m in lv]
        t3 = clock()
        [enc(t) for t in tiles]
        t4 = clock()
        for k, dt in zip(stage, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stage[k] += dt * 1e3 / frames
    ms.update(stage)
    feats = sorted(f for f in os.listdir(lf) if f.endswith("_f.npy"))
    rows = sum(len(np.load(os.path.join(lf, f))) for f in feats)
    print(f"[29] process_sequence: {frames} frames, {rows} segment features "
          f"of {CLIP_DIM}-d, {ms['process_sequence']:.3f} ms a frame "
          f"(warm) with the writes; apart: decode + upload {ms['decode']:.3f}, "
          f"masks_from_stack {ms['masks_from_stack']:.3f}, mask2segmap "
          f"(tiles and seg maps, {len(levels)} levels) "
          f"{ms['mask2segmap']:.3f}, stand-in encoder {ms['encoder']:.3f} "
          f"(wall clock, synchronised)", flush=True)

    # process_frames: the prompts of every object id; against the CPU
    ids = IP.collect_unique_ids(objects, frames, device=dev)
    prompts, prompts_cpu = (os.path.join(root, sub, "prompts")
                            for sub in ("", "cpu"))
    IP.process_frames(ids, 1, objects, os.path.dirname(images[0]),
                      os.path.join(root, "warm"), device=dev)
    t0 = clock()
    IP.process_frames(ids, frames, objects, os.path.dirname(images[0]),
                      prompts, device=dev)
    ms["process_frames"] = (clock() - t0) * 1e3 / frames
    t0 = clock()
    IP.process_frames(ids, check, objects, os.path.dirname(images[0]),
                      prompts_cpu, device=cpu)
    cpu_s["process_frames"] = clock() - t0
    n_png = sum(len(f) for _, _, f in os.walk(prompts))
    n_cpu = sum(len(f) for _, _, f in os.walk(prompts_cpu))
    bad = same_files(prompts_cpu, prompts)
    image = IP.rgba(torch.from_numpy(read_image(images[0])).to(dev))
    mask = torch.from_numpy(np.load(os.path.join(objects, "000001.npy"))
                            ).to(dev)
    t0 = clock()
    bw = IP.grey_rgba(IP.gaussian_blur(image))
    t1 = clock()
    finals = [IP.highlight(image, bw, (mask == k)[None])[0]
              for k in sorted(ids)]
    t2 = clock()
    [IP.pillow_rows(f).cpu() for f in finals]
    t3 = clock()
    ms["blur"] = (t1 - t0) * 1e3
    ms["highlight"] = (t2 - t1) * 1e3 / len(finals)
    ms["pillow_rows"] = (t3 - t2) * 1e3 / len(finals)
    print(f"[29] process_frames: {len(ids)} ids, {n_png} RGBA PNGs, "
          f"{ms['process_frames']:.3f} ms a frame with decode, PNG deflate "
          f"({IP.PNG_WORKERS} threads) and writes; frame 1 apart: blur + "
          f"grey {ms['blur']:.3f} ms, {ms['highlight']:.3f} ms an object's "
          f"composite and outline, {ms['pillow_rows']:.3f} ms its PNG filter "
          f"choice and copy to the host (wall clock, synchronised); against "
          f"the CPU: {len(bad)} of {n_cpu} PNGs differ", flush=True)
    if bad:
        raise AssertionError(f"process_frames: {bad[:5]}")

    # captions (stand-in), then the video features from them; against the
    # CPU on every frame
    captions = os.path.join(root, "captions")
    VC.generate_captions(prompts, captions, StandInCaptioner())
    shutil.copytree(captions, os.path.join(root, "cpu", "captions"))
    for side, sub in ((dev, ""), (cpu, "cpu")):
        cap_dir = os.path.join(root, sub, "captions")
        t0 = clock()
        VF.encode_feature(cap_dir, "features", objects, stand_in_embedding,
                          embed_dim=PRE_EMBED_DIM, device=side)
        t1 = clock()
        VF.assemble_final_features(os.path.join(cap_dir, "features"),
                                   objects,
                                   os.path.join(cap_dir, "final_features"),
                                   device=side)
        if not sub:
            ms["encode_feature"] = (t1 - t0) * 1e3 / frames
            ms["assemble_final_features"] = (clock() - t1) * 1e3 / frames
        else:
            cpu_s["video_features"] = clock() - t0
    final = np.load(os.path.join(captions, "final_features", "000001_f.npy"))
    bad = same_files(os.path.join(root, "cpu", "captions"), captions)
    print(f"[29] encode_feature {ms['encode_feature']:.3f} ms a frame "
          f"({len(ids)} caption files, float64 tables [{final.shape[0] + 1}, "
          f"{PRE_EMBED_DIM}]), assemble_final_features "
          f"{ms['assemble_final_features']:.3f} (wall clock); against the "
          f"CPU: {len(bad)} files differ", flush=True)
    if bad:
        raise AssertionError(f"video features: {bad[:5]}")

    # the written features into the port's autoencoder
    argv = ae_argv(root, dev)
    t0 = clock()
    best = ae_train.main(argv + ["--num_epochs", str(epochs),
                                 "--eval_from_epoch", "-1"])
    out_dir = ae_test.main(argv)
    ae_s = clock() - t0
    first = np.load(os.path.join(lf, feats[0]))
    codes = np.load(os.path.join(out_dir, feats[0]))
    print(f"[29] ae.train {epochs} epochs on the {rows} features (best eval "
          f"loss {best:.6f}) and ae.test: {ae_s:.1f} s; {feats[0]}: "
          f"{first.shape} -> {codes.shape}", flush=True)
    if (not best < 100.0 or codes.shape != (len(first), AE_ENC[-1])
            or not np.allclose(np.linalg.norm(codes, axis=1), 1, atol=1e-5)):
        raise AssertionError("the AE does not take the written features")
    print("[29] ms a frame: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in ms.items())
          + f"; phase {time.perf_counter() - t_phase:.1f} s, of which the "
          f"CPU's runs " + ", ".join(f"{k} {v:.2f} s"
                                     for k, v in cpu_s.items())
          + f"; {smi}", flush=True)
    return ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", action="append", default=[],
                    metavar="NAME=TREE")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", default="", metavar="25,26,27,28,29",
                    help="run the build and only these of phases 25-29 (26 "
                         "and 28 with 19 and 22, whose scene and "
                         "autoencoder they use), without the kernels line")
    args = ap.parse_args()
    # warnings only, as before the CLIs of phases 22-23 (which add an INFO
    # handler to stdout where there is none): the output keeps its phases
    logging.basicConfig(level=logging.WARNING, format="%(message)s")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not all(os.path.isfile(os.path.join(REPO, src))
               for src, _ in KERNELS.values()):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from langsplat4d_torch.checkpoint import TrainedModel
    from langsplat4d_torch.config import Config
    from langsplat4d_torch.ops import composite
    from langsplat4d_torch.field.deformation import make_grid_spatial_cache
    from langsplat4d_torch.render.driver import render_set
    from langsplat4d_torch.render.pipeline import binning_report
    from langsplat4d_torch.render.raster import RasterSettings
    from langsplat4d_torch.train.loop import maybe_stream_switch
    from langsplat4d_torch.train.step import train_step

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def stamp(phases):
        secs = time.perf_counter() - t_start
        print(f"[t] phases {phases} done at {secs:.1f} s", flush=True)
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

    # 1. build: the kernels (one nvcc each) and the host image codec (c++)
    # together
    from concurrent.futures import ThreadPoolExecutor
    from langsplat4d_torch.data import codec
    every = tuple(composite.ENTRY_POINTS)
    with ThreadPoolExecutor(1) as ex:
        host = ex.submit(codec.build_library)
        secs = composite.build_seconds(every)
        host.result()
    print(f"[1] build+load of {len(every)} kernels, in parallel: "
          f"{secs:.2f} s; the image codec beside them", flush=True)
    scene_root = os.path.join(REPO, "langsplat4d_torch", "_build", "scene")
    neu3d_root = os.path.join(REPO, "langsplat4d_torch", "_build", "neu3d")
    formats_root = os.path.join(REPO, "langsplat4d_torch", "_build",
                                "formats")
    preprocess_root = os.path.join(REPO, "langsplat4d_torch", "_build",
                                   "preprocess")
    if args.only:
        only = {int(p) for p in args.only.split(",")}
        if not only <= {25, 26, 27, 28, 29}:
            raise SystemExit("--only takes phases among 25, 26, 27, 28, 29")
        if 25 in only:
            codec_phase()
        if only & {26, 28}:
            shutil.rmtree(scene_root, ignore_errors=True)
            scene_phase(dev, scene_root)
            ae = ae_phase(dev, scene_root)
        if 26 in only:
            neu3d_phase(dev, neu3d_root, ae)
        if 28 in only:
            mesh_phase(dev, scene_root, smi)
        if 27 in only:
            formats_phase(dev, formats_root)
        if 29 in only:
            preprocess_phase(dev, preprocess_root, smi=smi)
        print(smi)
        return 0

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
    cfg = Config()
    cfg.model.model_path = out_root
    cfg.model.white_background = False
    cfg.runtime.render_tile_size = RENDER_TILE_SIZE
    cfg.runtime.nonormalized = False
    model = TrainedModel(gaussians=gs, deform=net, aabb=aabb,
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

    stamp("1-3")
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
            p_ms, ref = once_ms(lambda: composite.composite_stream_plain(
                rows, starts, bg, stats=stats, **kw))
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

    stamp("4-5")
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
    res = function_resources(composite.ptxas_report("plane_grad"))
    for fn, (regs, stack, spill) in res.items():
        print(f"[6] plane_grad: {fn}: {regs} registers, {stack} bytes stack "
              f"frame, {spill} bytes spilled", flush=True)
    if len(res) != 8:         # corners, dense_corners, chunk_sums and
        # merge_runs at 8/16/32
        raise AssertionError(f"plane_grad: ptxas figures of {sorted(res)}")
    if any(stack or spill for _, stack, spill in res.values()):
        raise AssertionError("plane_grad: a stack frame or a spill")

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

    stamp("6-11")
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

    stamp("12-15")
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

    stamp("16-18")
    # 19. a HyperNeRF scene on disk, read back through the port's Scene
    shutil.rmtree(scene_root, ignore_errors=True)
    scene_phase(dev, scene_root)

    # 22. the language autoencoder on its 512-d features: train, export
    # (phase 20 trains on the export)
    ae_ckpt = ae_phase(dev, scene_root)

    stamp("19, 22")
    # 20. training(cfg) from that scene at full width, and the saved model
    loop_launches, render_launches, plane_inputs, loop_rates = loop_phase(
        dev, scene_root, step_ms=list_ms)
    loop_launches["composite_stream"] = render_launches
    for e in entries:
        e["loop_launches"] = loop_launches.get(e["name"], 0)

    stamp("20")
    # 21. the loop's kernels against their plain versions; determinism,
    # with the plane-gradient kernel held against its plain version
    determinism_phase(dev, scene_root)
    entries.append(plane_grad_entry(plane_inputs[0],
                                    loop_launches["plane_grad"]))
    entries.append(dense_grid_phase(dev, scene_root))
    del plane_inputs
    torch.cuda.empty_cache()

    stamp("21")
    # 23. evaluation of the saved model: lang render, AE decode, relevancy,
    # mIoU; the video helpers
    eval_launches = eval_phase(dev, scene_root, ae_ckpt)
    for e in entries:
        e["eval_launches"] = (eval_launches if e["name"] == "composite_stream"
                              else 0)
    torch.cuda.empty_cache()

    stamp("23")
    # 24. scripts/train_eval.sh through the port's CLIs: train (phase A and
    # the discrete phase B), render, eval; the discrete stage's K-Means
    cli_launches = cli_phase(dev, scene_root, ae_ckpt, loop_rates,
                             iters=CLI_STAGE_ITERS)
    for e in entries:
        e["cli_launches"] = cli_launches.get(e["name"], 0)
    torch.cuda.empty_cache()

    stamp("24")
    # 28. the multi-rank path on the card: bands in both exchanges, the
    # sharded step, the CLIs on two ranks (phase 19's scene, 22's export)
    band_launches, mesh_launches, band_err, mesh_err = mesh_phase(
        dev, scene_root, smi)
    for e in entries:
        e["band_launches"] = (band_launches
                              if e["name"] == "composite_stream" else 0)
        e["mesh_launches"] = mesh_launches.get(e["name"], 0)
        if e["name"] == "composite_stream":
            e["max_abs_err"] = max(e["max_abs_err"], band_err)
        if e["name"] == "composite_tiles":
            e["max_abs_err"] = max(e["max_abs_err"], mesh_err)
    torch.cuda.empty_cache()

    stamp("28")
    # 25. the image codec on this host against its numpy twins
    codec_phase()

    stamp("25")
    # 26. Neu3D at full width through the CLIs: train, render, eval; the
    # GT cache's size in turns
    neu3d_launches = neu3d_phase(dev, neu3d_root, ae_ckpt)
    for e in entries:
        e["neu3d_launches"] = neu3d_launches.get(e["name"], 0)
    shutil.rmtree(neu3d_root, ignore_errors=True)
    shutil.rmtree(scene_root, ignore_errors=True)
    torch.cuda.empty_cache()

    stamp("26")
    # 27. the Blender, COLMAP, MultipleView and PanopticSports readers on
    # the card
    formats_phase(dev, formats_root)
    shutil.rmtree(formats_root, ignore_errors=True)
    torch.cuda.empty_cache()

    stamp("27")
    # 29. the offline preprocessing on the card, against the CPU, into the
    # autoencoder
    preprocess_phase(dev, preprocess_root, smi=smi)
    shutil.rmtree(preprocess_root, ignore_errors=True)
    torch.cuda.empty_cache()

    stamp("29")
    # 11, and 15's: the profiles of the two training steps
    for stream, ms_step, phase in ((False, list_ms, 11),
                                   (True, stream_ms, 15)):
        state, cfg, batch, bg = train_workload(dev, stream=stream)
        train_step(cfg, state, batch, bg, 1, 3)                 # warm-up
        profile_steps(cfg, state, batch, bg, ms_step, phase=phase)
    print(json.dumps({"kernels": [
        dict({"library_ms": None}, **e, route="cuda",
             source=KERNELS[e["name"]][0], replaces=KERNELS[e["name"]][1])
        for e in entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
