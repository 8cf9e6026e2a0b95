#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (langsplat4d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA GPU and nvcc.
Phases, each failing the run on error:
  1. build the stream compositor kernel from csrc/ with nvcc;
  2. compare it with its plain PyTorch version on synthetic segments (16-
     and 32-px tiles, hard cutoffs on and off, empty and long segments,
     ragged image edges), max abs error <= 3e-5;
  3. render the bench workload (200k realistic Gaussians at 1352x1014, the
     Neu3D-preset deformation at full width with seeded random weights, a
     60-frame orbit, lang mode, fine-lang) through
     langsplat4d_torch.render.driver.render_set, and count the kernel's
     launches in that run;
  4. per-stage device times over a few frames;
  5. frame 0 composited by the kernel vs the plain version, and vs what
     render_set wrote; kernel and plain times at 32- and 16-px tiles.
Prints the card's name and power limit, one JSON line describing the
kernels, and as the last line {"ok": true, "device": {...}}. Imports nothing
of JAX or of the JAX package.
"""
import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 3e-5          # the repo's kernel bound (tests/test_pallas_composite.py)
KERNEL_SOURCE = "langsplat4d_torch/csrc/composite_stream.cu"
REPLACES = "langsplat4d/ops/tile_composite.py:452"   # _stream_kernel
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


def kernel_cases():
    """(tile_size, hard_cutoffs, height, width, pw) cases of phase 2; both
    image edges are ragged at both tile sizes."""
    cases = [(ts, hard, 100, 150, 16) for ts in (16, 32)
             for hard in (True, False)]
    return cases + [(16, True, 100, 150, 24)]


def case_segments(tiles, generator):
    """Segment lengths: a third empty, two long ones spanning many staging
    batches, the rest short."""
    seg = torch.randint(1, 200, (tiles,), generator=generator)
    seg[torch.randperm(tiles, generator=generator)[: tiles // 3]] = 0
    seg[1] = 2500
    seg[tiles - 2] = 1100
    return seg


def compare_case(ts, hard, h, w, pw, device, seed=0):
    """Kernel and plain version on one synthetic case -> max abs error."""
    from langsplat4d_torch.ops.composite import (composite_stream,
                                                 composite_stream_plain)
    g = torch.Generator().manual_seed(seed)
    tx, ty = -(-w // ts), -(-h // ts)
    rows, starts = synthetic_stream(tx, ty, ts, case_segments(tx * ty, g), g,
                                    pw=pw)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(REPO, KERNEL_SOURCE)):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from langsplat4d_torch.ops import composite
    from langsplat4d_torch.render.driver import render_set
    from langsplat4d_torch.render.raster import RasterSettings
    from langsplat4d_torch.field.deformation import make_grid_spatial_cache

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 1. build
    print(f"[1] kernel build+load: {composite.build_seconds():.2f} s",
          flush=True)

    # 2. kernel vs plain on synthetic segments
    errs = []
    for case in kernel_cases():
        err = compare_case(*case, device=dev)
        errs.append(err)
        print(f"[2] ts={case[0]} hard={case[1]} {case[2]}x{case[3]} "
              f"pw={case[4]}: max abs err {err:.3g}", flush=True)
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
            ref = composite.composite_stream_plain(rows, starts, bg, **kw)
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
            timing[ts] = (k_ms, p_ms)
            print(f"[5] ts={ts}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms",
                  flush=True)
    shutil.rmtree(out_root, ignore_errors=True)

    k_ms, p_ms = timing[RENDER_TILE_SIZE]
    print(json.dumps({"kernels": [{
        "name": "composite_stream", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(errs), "ms": k_ms, "plain_ms": p_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
