"""Render driver: render one split in rgb or lang mode, print the FPS line,
save raw npy maps and PNGs (port of langsplat4d/render/driver.py; reference
render.py:67-161).

Each frame is one `render` call; the Gaussians are fixed over the
trajectory, so the HexPlane's spatial-plane products are computed once.
Frames stay on the device inside the timed loop and are copied out after it,
as the reference does. In lang mode each view's ground-truth language map
is read from the scene's `language_features_name` directory at the
configured feature level (`HostCamera.get_language_feature`) and saved raw
into `gt_npy`, where `eval --use_gt_feat 1` reads it; unless ONLY_EVAL is set
or the scene is not given. A map wider than three channels is shown through
its top three principal components (`eval/colormaps.pca3`).

With `runtime.gaussian_shards` > 1 the frames are rendered by tile-row
bands on that many ranks (parallel/render.py, the exchange from
`LS4D_BAND_EXCHANGE`, "allgather" by default or "alltoall"): each rank keeps
its block of the model's rows, renders its band, and the bands of each frame
are gathered to rank 0, which alone writes the files. Where the process
group has another number of ranks, it raises: the JAX driver renders on one
chip instead, with a warning.
"""
from __future__ import annotations

import os
import time as time_mod
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from langsplat4d_torch.data.png import png_bytes
from langsplat4d_torch.eval.colormaps import pca3
from langsplat4d_torch.field.deformation import make_grid_spatial_cache
from langsplat4d_torch.parallel.mesh import make_mesh, shard_gaussians
from langsplat4d_torch.parallel.render import (gather_bands,
                                               render_frame_banded)
from langsplat4d_torch.render.pipeline import render
from langsplat4d_torch.render.raster import RasterSettings


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def pca_compress(feature_map: np.ndarray) -> np.ndarray:
    """[C > 3, H, W] -> [3, H, W] visualization: projection on the top three
    principal components, scaled to [0, 1] (reference render.py:52-65)."""
    c, h, w = feature_map.shape
    flat = torch.from_numpy(np.ascontiguousarray(
        feature_map.transpose(1, 2, 0).reshape(-1, c)))
    out = pca3(flat).numpy().reshape(h, w, 3)
    out = (out - out.min()) / (out.max() - out.min())
    return out.transpose(2, 0, 1).astype(np.float32)


def _write_images(images: List[np.ndarray], path: str) -> None:
    def write_one(i, img):
        arr = to8b(img).transpose(1, 2, 0)
        if arr.shape[2] == 1:
            arr = arr[:, :, 0]
        with open(os.path.join(path, f"{i:05d}.png"), "wb") as f:
            f.write(png_bytes(np.ascontiguousarray(arr)))

    with ThreadPoolExecutor() as ex:
        list(ex.map(lambda t: write_one(*t), enumerate(images)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def render_set(cfg, model, dcfg, scene, name: str, iteration: int, views,
               mode: str = "rgb", load_stage: str = "fine-lang",
               noimage: bool = False, nonpy: bool = False,
               novideo: bool = False) -> float:
    """Renders one split of `views` (HostCameras) from `model`
    (checkpoint.TrainedModel) on the model's device; returns the FPS,
    (len(views) - 1) / seconds of the frame loop (reference render.py:95,
    133-134). `scene` gives the dataset type that the ground-truth
    language maps are read for (lang mode; None reads none). Under
    `runtime.gaussian_shards` > 1, every rank of the process group calls
    it (see the module's docstring); rank 0 writes the files."""
    lf_path = None if cfg.runtime.only_eval else cfg.model.lf_path
    data_type = getattr(scene, "dataset_type", None)
    mesh = make_mesh(1, cfg.runtime.gaussian_shards)
    base = os.path.join(cfg.model.model_path, f"{name}_{mode}",
                        f"ours_{iteration}")
    render_path = os.path.join(base, "renders")
    gts_path = os.path.join(base, "gt")
    render_npy_path = os.path.join(base, "renders_npy")
    gts_npy_path = os.path.join(base, "gt_npy")
    if mesh.is_root:
        for p in (render_path, gts_path, render_npy_path, gts_npy_path):
            os.makedirs(p, exist_ok=True)

    gs, net, aabb = model.gaussians, model.deform, model.aabb
    if mesh.gauss > 1:
        gs = shard_gaussians(gs, mesh)
    dev = gs.device
    first = views[0]
    settings = RasterSettings(
        image_height=first.height, image_width=first.width,
        sh_degree=model.active_sh_degree,
        include_feature="base" not in load_stage,
        tile_size=cfg.runtime.render_tile_size)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=dev)
    grid_spatial = (make_grid_spatial_cache(net, dcfg, aabb, gs.xyz)
                    if load_stage.startswith("fine") else None)
    key = "render" if mode == "rgb" else "language_feature_image"
    cams = [v.camera_params(dev) for v in views]

    exchange = os.environ.get("LS4D_BAND_EXCHANGE", "allgather")

    def render_one(i):
        if mesh.gauss == 1:
            return render(settings, dcfg, load_stage, cams[i], views[i].time,
                          gs, net, aabb, bg,
                          nonormalized=cfg.runtime.nonormalized,
                          grid_spatial=grid_spatial)[key]
        band = render_frame_banded(
            settings, dcfg, load_stage, cams[i], views[i].time, gs, net,
            aabb, bg, mesh, nonormalized=cfg.runtime.nonormalized,
            grid_spatial=grid_spatial, exchange=exchange)[key]
        return gather_bands(band, settings, mesh)

    render_one(0)                      # warm-up: kernel build, allocator
    frames = []
    _sync(dev)
    time1 = time_mod.perf_counter()
    for i in range(len(views)):
        frames.append(render_one(i))
    _sync(dev)
    time2 = time_mod.perf_counter()
    fps = (len(views) - 1) / max(time2 - time1, 1e-9)
    if not mesh.is_root:
        return fps
    print("FPS:", fps)

    render_list = [f.cpu().numpy() for f in frames]
    del frames
    gt_list: List[Optional[np.ndarray]] = []
    gt_raw: List[Optional[np.ndarray]] = []       # saved to gt_npy as read
    tosave: List[np.ndarray] = []
    for idx, view in enumerate(views):
        rendering = render_list[idx]
        gt = None
        if mode == "rgb":
            gt = view.image[:3] if view.image is not None else None
            gt_raw.append(gt)
        else:
            if lf_path is not None and data_type is not None:
                gt, _ = view.get_language_feature(
                    lf_path, cfg.model.feature_level, split=name,
                    data_type=data_type)
            gt_raw.append(gt)
            if gt is not None and (data_type != "dynerf" or name != "video"):
                gt = (gt + 1.0) / 2
            rendering = (rendering + 1.0) / 2
            if rendering.shape[0] > 3:
                rendering = pca_compress(rendering)
                gt = pca_compress(gt) if gt is not None else None
        gt_list.append(gt)
        tosave.append(rendering)

    if not noimage:
        gts = [g for g in gt_list if g is not None]
        if gts:
            _write_images(gts, gts_path)
        _write_images(tosave, render_path)
    if not nonpy:
        for idx, rendering in enumerate(render_list):
            np.save(os.path.join(render_npy_path, f"{idx:05d}.npy"),
                    rendering.transpose(1, 2, 0))
            if gt_raw[idx] is not None:
                np.save(os.path.join(gts_npy_path, f"{idx:05d}.npy"),
                        gt_raw[idx].transpose(1, 2, 0))
    if not novideo:
        try:
            import imageio
            imageio.mimwrite(os.path.join(base, f"video_{mode}.mp4"),
                             [to8b(r).transpose(1, 2, 0) for r in tosave],
                             fps=30)
        except (ValueError, ImportError) as e:
            print(f"[render] skipping video_{mode}.mp4 (no mp4 backend: {e})")
    return fps
