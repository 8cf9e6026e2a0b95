"""Training drivers: the per-stage `scene_reconstruction` loop, the
four-stage curriculum `training` and its resume into the discrete
`fine-lang-discrete` stage (port of langsplat4d/train/loop.py; reference
train.py:98-466).

Host control between steps: the viewer bridge's poll, camera sampling, the
batch build (on a producer thread, with each camera's ground truth kept on
the device after its first upload), the loss drain and NaN watchdog every 10
iterations (with `LS4D_NAN_FORENSICS`, a window of the last 12 steps'
inputs), the rgb|gt|lang|gt_lang grid at log cadence, the render-process
snapshots, densification, the switch to the stream layout, reports and
saving. The step itself is `train_step_packed` (train/step.py).

On a mesh (`runtime.data_parallel` x `runtime.gaussian_shards` ranks,
parallel/mesh.py; the JAX package's loop.py:606-630): every rank runs the
same sampler and seed and holds its block of the Gaussian rows; the batch
is split over the data axis where the stage's batch size divides over it,
and replicated otherwise (the batch-1 language stages). Densify, prune,
point growing and the opacity reset run on the whole state on every rank
(`apply_unsharded`); rank 0 alone writes (the scene, checkpoints, the log,
the snapshots, the debug grid, the viewer), from the whole state, so the
files are the single-rank format; the stream switch is decided once for
all ranks.

Checkpoints: the port writes torch files, and `load_checkpoint` reads those
and the JAX package's pickle checkpoints (train/ckpt_jax.py), so phase B
resumes from a phase A that either package trained.

Intended removals: orbax checkpoints (an orbax directory raises) and the
JAX package's stream tuning and audit (the port's stream has no static
size).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import multiprocessing
import os
import pickle
import random
import sys
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from langsplat4d_torch.config import Config, save_cfg_args
from langsplat4d_torch.core import plyio
from langsplat4d_torch.core import state as statelib
from langsplat4d_torch.core.device import resolve_device
from langsplat4d_torch.data.gt_cache import get_cache, image_fingerprint
from langsplat4d_torch.data.png import png_bytes
from langsplat4d_torch.data.prefetch import prefetch
from langsplat4d_torch.data.scene import BatchLoader, FineSampler, Scene
from langsplat4d_torch.eval.colormaps import pca3
from langsplat4d_torch.field.deformation import (DeformConfig, DeformNetwork,
                                                 deform_forward)
from langsplat4d_torch.interop import save_deformation
from langsplat4d_torch.ops.kmeans import kmeans
from langsplat4d_torch.parallel.mesh import (Mesh, apply_unsharded,
                                             make_mesh, shard_batch,
                                             shard_state, unshard_state)
from langsplat4d_torch.render.pipeline import binning_report, render
from langsplat4d_torch.render.raster import CameraParams, RasterSettings
from langsplat4d_torch.train import densify as D
from langsplat4d_torch.train.ckpt_jax import (checkpoint_format,
                                             load_jax_checkpoint)
from langsplat4d_torch.train.optim import AdamState, LRConfig
from langsplat4d_torch.train.step import (Batch, StepConfig, eval_step,
                                          materialize_batch, pack_cam_rows,
                                          packed_batch, train_step_packed)
from langsplat4d_torch.train.trainstate import (GAUSSIAN_KEYS, TrainState,
                                                make_train_state,
                                                one_up_sh_degree)
from langsplat4d_torch.utils import network_gui
from langsplat4d_torch.utils.scene_vis import render_training_image
from langsplat4d_torch.utils.telemetry import Telemetry
from langsplat4d_torch.utils.timer import Timer

logger = logging.getLogger(__name__)

STAGE_ORDER = ("coarse-base", "coarse-lang", "fine-base", "fine-lang")

#: above this share of full tile lists the loop trains on the stream layout
FULL_LIST_LIMIT = 0.05


class PackedPayload(NamedTuple):
    """One iteration's batch as `train_step_packed` takes it: one packed
    host row per camera ([B, 39] float32, `pack_cam_rows`) and per-camera
    ground-truth tensors on the device (uint8 or float32 images [3, H, W];
    in language stages segment maps [H, W] and feature tables [S, L])."""
    packed: np.ndarray
    imgs: Tuple[torch.Tensor, ...]
    segs: Optional[Tuple[torch.Tensor, ...]]
    tables: Optional[Tuple[torch.Tensor, ...]]


def _watchdog_restart(cfg: Config, reason: str) -> None:
    """NaN / explosion recovery: re-execute the process with the same argv
    (reference train.py:341-351), at most LS4D_WATCHDOG_MAX_RESTARTS times
    (default 3), since a deterministic fault comes back on every restart.
    With `runtime.watchdog_execv=False`, or past the cap, raise."""
    if getattr(cfg.runtime, "watchdog_execv", True):
        n = int(os.environ.get("LS4D_WATCHDOG_RESTART_COUNT", "0"))
        cap = int(os.environ.get("LS4D_WATCHDOG_MAX_RESTARTS", "3"))
        if n < cap:
            os.environ["LS4D_WATCHDOG_RESTART_COUNT"] = str(n + 1)
            os.execv(sys.executable, [sys.executable] + sys.argv)
        logger.error("watchdog restart cap reached (%d/%d); raising", n, cap)
    raise RuntimeError(f"training watchdog tripped: {reason}")


def _encode_image(img: np.ndarray) -> np.ndarray:
    """uint8 where that is lossless (always for images decoded from 8-bit
    files, the reference's only sources), else float32."""
    q = np.rint(img * np.float32(255.0)).astype(np.uint8)
    if np.array_equal(q.astype(np.float32) / np.float32(255.0), img):
        return q
    return np.asarray(img, np.float32)


def build_batch(cams: Sequence, cfg: Config, scene: Scene, iteration: int,
                device, split: str = "train",
                need_lang: bool = True) -> PackedPayload:
    """The cameras of one iteration as a PackedPayload (the JAX package's
    packed, compact form: `runtime.compact_batch` and `runtime.packed_step`
    change nothing that the step sees, so the port always builds this one).

    With `runtime.gt_cache_mb > 0` each camera's ground truth stays on the
    device after its first upload (data/gt_cache.py): a file-backed image is
    keyed by the file's identity, so a revisit does not decode it again;
    any other by a fingerprint of its pixels; the language pair by (feature
    dir, split, level, camera name). Base stages read no language ground
    truth (train.py:283-285)."""
    device = torch.device(device)
    cache = (get_cache(cfg.runtime.gt_cache_mb, device)
             if cfg.runtime.gt_cache_mb > 0 else None)
    packed = pack_cam_rows([c.camera_params_np() for c in cams],
                           [c.time for c in cams], iteration)

    def image_key(c):
        if getattr(c, "image_file_backed", False):
            st = os.stat(c.image_path)
            return ("img", c.image_name, split, c.image_path,
                    st.st_mtime_ns, st.st_size, c.image_resize, c.image_filt)
        return ("img", c.image_name, split, image_fingerprint(c.image))

    img_jobs = [(image_key(c), lambda c=c: (_encode_image(c.image),))
                for c in cams]
    if not need_lang:
        imgs = _mixed_as_float(
            [t[0] for t in _cached_or_made(img_jobs, cache, device)])
        return PackedPayload(packed, tuple(imgs), None, None)

    lf_path = cfg.model.lf_path
    lang_dim = cfg.runtime.language_feature_hiddendim
    have_lang = lf_path is not None and os.path.isdir(lf_path)

    def lang_host(c):
        s, t = (c.get_language_feature_compact(
                    lf_path, cfg.model.feature_level, split,
                    scene.dataset_type)
                if have_lang else (None, None))
        if s is None:
            # zeros make the language loss a silent no-op: say so once
            if not getattr(build_batch, "_warned_missing_lang", False):
                build_batch._warned_missing_lang = True
                logger.warning("no ground-truth language features under %r "
                               "(camera %s); language losses see zeros",
                               lf_path, c.image_name)
            return (np.full((c.height, c.width), -1, np.int16),
                    np.zeros((64, lang_dim), np.float32))
        # the table's rows rounded up to 64, so that few shapes occur
        s_pad = -(-t.shape[0] // 64) * 64
        return s, np.pad(t, ((0, s_pad - t.shape[0]), (0, 0)))

    lang_key = ("lang", lf_path, split, cfg.model.feature_level, True)
    got = _cached_or_made(
        img_jobs + [(lang_key + (c.image_name,), lambda c=c: lang_host(c))
                    for c in cams], cache, device)
    imgs = _mixed_as_float([t[0] for t in got[:len(cams)]])
    pairs = got[len(cams):]
    segs = [p[0] for p in pairs]
    if any(s.dtype != torch.int16 for s in segs):
        segs = [s.to(torch.int32) for s in segs]   # >32k-segment frames
    return PackedPayload(packed, tuple(imgs), tuple(segs),
                         tuple(p[1] for p in pairs))


def _cached_or_made(jobs, cache, device) -> List[Tuple[torch.Tensor, ...]]:
    """The device tensors of each (key, make) job: the GT cache's entry
    under `key`, else `make()`'s host arrays uploaded (and put, where there
    is a cache). A hit makes nothing; several misses are made together on a
    pool of up to 4 threads (the image codec, zlib and .npy reads release
    the interpreter lock), so a batch's image decodes and language loads
    overlap."""
    out = [cache.peek(key) if cache is not None else None for key, _ in jobs]
    miss = [i for i, hit in enumerate(out) if hit is None]
    if len(miss) > 1:
        with ThreadPoolExecutor(max_workers=min(4, len(miss))) as ex:
            made = list(ex.map(lambda i: jobs[i][1](), miss))
    else:
        made = [jobs[i][1]() for i in miss]
    for i, arrays in zip(miss, made):
        out[i] = (cache.put(jobs[i][0], arrays) if cache is not None else
                  tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in arrays))
    return out


def _mixed_as_float(imgs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Mixed encodings in one batch: the uint8 ones decoded (exactly) to
    float32."""
    if any(t.dtype == torch.uint8 for t in imgs) and any(
            t.dtype != torch.uint8 for t in imgs):
        return [t.to(torch.float32) / 255.0 if t.dtype == torch.uint8
                else t for t in imgs]
    return imgs


def init_state_from_scene(cfg: Config, scene: Scene, seed: int = 0,
                          device=None) -> Tuple[TrainState, DeformConfig]:
    """The initial TrainState from the scene's point cloud
    (GaussianModel + create_from_pcd): capacity 1.2 x optim.max_points (or
    the cloud, if larger) rounded up to runtime.capacity_granule, and the
    deformation network initialised from `seed`. `device=None` is the
    current CUDA device (an error where there is none)."""
    device = resolve_device(device)
    dcfg = DeformConfig.from_config(cfg.hidden, cfg.runtime,
                                    max_sh_degree=cfg.model.sh_degree)
    net = DeformNetwork(dcfg, torch.Generator().manual_seed(seed))
    pcd = scene.point_cloud
    capacity = statelib.round_capacity(
        max(int(cfg.optim.max_points * 1.2), len(pcd.points)),
        cfg.runtime.capacity_granule)
    gs = statelib.create_from_pcd(
        pcd.points, pcd.colors, max_sh_degree=cfg.model.sh_degree,
        lang_dim=cfg.runtime.language_feature_hiddendim, capacity=capacity,
        device=device)
    logger.info("Number of points at initialisation: %d (capacity %d)",
                len(pcd.points), capacity)
    return make_train_state(gs, net.to(device), scene.aabb), dcfg


def save_scene(cfg: Config, state: TrainState, iteration: int, stage: str,
               model_path: str) -> None:
    """Scene.save (scene/__init__.py:98-101): the live rows as
    point_cloud.ply and the deformation files, in
    point_cloud/{stage}_iteration_{iteration}/."""
    del cfg
    out_dir = os.path.join(model_path, "point_cloud",
                           f"{stage}_iteration_{iteration}")
    os.makedirs(out_dir, exist_ok=True)
    n = state.num_active
    p = {k: state.params[k][:n].detach().cpu().numpy() for k in GAUSSIAN_KEYS}
    plyio.write_ply(
        os.path.join(out_dir, "point_cloud.ply"),
        plyio.gaussians_to_ply_arrays(
            xyz=p["xyz"], features_dc=p["f_dc"], features_rest=p["f_rest"],
            language_feature=p["language_feature"], opacity=p["opacity"],
            scaling=p["scaling"], rotation=p["rotation"]))
    save_deformation(out_dir, state.deform, state)


_BUFFERS = ("max_radii2d", "xyz_gradient_accum", "denom",
            "deformation_table", "deformation_accum", "aabb")


def save_checkpoint(state: TrainState, iteration: int, stage: str,
                    model_path: str, dcfg: DeformConfig) -> str:
    """The whole training state (the reference's capture(),
    gaussian_model.py:71-109) as one torch file,
    chkpnt_{stage}_{iteration}.pth; returns its path."""
    def cpu(tree):
        return {k: v.detach().cpu().clone() for k, v in tree.items()}
    path = os.path.join(model_path, f"chkpnt_{stage}_{iteration}.pth")
    torch.save(dict(
        iteration=iteration, stage=stage, dcfg=dataclasses.asdict(dcfg),
        params=cpu(state.params), deform=cpu(state.deform.state_dict()),
        opt_m=cpu(state.opt.m), opt_v=cpu(state.opt.v),
        opt_step=state.opt.step, num_active=state.num_active,
        active_sh_degree=state.active_sh_degree,
        **{k: getattr(state, k).detach().cpu().clone() for k in _BUFFERS}),
        path)
    logger.info("[ITER %d] Saved checkpoint %s", iteration, path)
    return path


def load_checkpoint(path: str, device=None,
                    dcfg: Optional[DeformConfig] = None
                    ) -> Tuple[TrainState, dict]:
    """A checkpoint -> (TrainState on `device`, the payload), whichever
    package wrote it: the port's `save_checkpoint` file (a zip, read as
    torch.save wrote it, its DeformConfig from the file) or the JAX
    package's pickle (train/ckpt_jax.py; it holds no DeformConfig, so
    `dcfg` is required there: the config's, from DeformConfig.from_config,
    whose SH degree, language width and centres the file's leaves must
    fit). The JAX package's orbax directories, and
    anything else, raise naming the path. `device=None` is the current CUDA
    device (an error where there is none)."""
    device = resolve_device(device)
    if checkpoint_format(path) == "jax":
        if dcfg is None:
            raise ValueError(f"{path}: the JAX package's checkpoint holds no "
                             f"DeformConfig; pass the config's as dcfg")
        return load_jax_checkpoint(path, dcfg, device=device)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    dcfg = DeformConfig(**payload["dcfg"])
    net = DeformNetwork(dcfg)
    net.load_state_dict(payload["deform"], strict=True)
    net = net.to(device)
    state = TrainState(
        params={k: v.to(device) for k, v in payload["params"].items()},
        deform=net, opt=AdamState({}, {}),
        num_active=int(payload["num_active"]),
        active_sh_degree=int(payload["active_sh_degree"]),
        **{k: payload[k].to(device) for k in _BUFFERS})
    names = list(state.leaves())
    state.opt = AdamState(
        m={k: payload["opt_m"][k].to(device) for k in names},
        v={k: payload["opt_v"][k].to(device) for k in names},
        step=int(payload["opt_step"]))
    return state, payload


def maybe_stream_switch(settings: RasterSettings, state: TrainState,
                        train_cams: Sequence, iteration: int = 0
                        ) -> Optional[RasterSettings]:
    """Probe the tile lists' truncation on the first training camera and
    decide the switch to the stream layout: returns `settings` with
    `stream_train` on when more than 5% of the tile lists are full (the
    only case in which a list may have dropped Gaussians), else None. The
    CUDA reference's duplicate-and-sort buffers never truncate, so neither
    may training here. `train_cams[0].camera_params(device)` gives the
    probe's camera.

    The JAX package's `maybe_stream_switch` also sizes span tiers and a slot
    budget and returns an audit that re-sizes them after densification; the
    port's stream has no static shape, so there is nothing to size."""
    stats = binning_report(settings,
                           train_cams[0].camera_params(state.device),
                           state.gaussians())
    if stats["tile_full_frac"] <= FULL_LIST_LIMIT:
        return None
    logger.warning(
        "[ITER %d] tile lists saturated (full frac %.1f%%, longest list %d "
        "of capacity %d): switching to the stream-layout training composite",
        iteration, 100.0 * stats["tile_full_frac"],
        int(stats["tile_max_count"]), settings.tile_capacity)
    return dataclasses.replace(settings, stream_train=True)


class HostWriter:
    """The loop's image outputs (the render-process snapshots, the debug
    grid) encoded and written in WORKERS processes: on threads of the
    training process, the numpy encoders would hold the GIL that the
    training thread needs to launch its kernels. The training thread
    renders and starts the copies to the host without waiting; a waiter
    thread waits for the copies and hands the arrays to a process. At most
    MAX_PENDING jobs wait, and a job's failure is raised on the training
    thread at the next `submit` or at the stage's end. The processes are
    spawned at the first job, with one OpenMP and one BLAS thread each
    (their default pools would take the cores the training thread needs),
    and serve the whole training process; a script that trains guards its
    entry with `if __name__ == "__main__"`, as spawned processes import
    the main module."""
    WORKERS, MAX_PENDING = 4, 8
    WORKER_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
                  "MKL_NUM_THREADS": "1"}
    _processes: Optional[ProcessPoolExecutor] = None

    def __init__(self):
        self._waiters = ThreadPoolExecutor(max_workers=self.WORKERS,
                                           thread_name_prefix="image-writer")
        self._jobs: deque = deque()

    @classmethod
    def _pool(cls) -> ProcessPoolExecutor:
        if cls._processes is None:
            saved = {k: os.environ.get(k) for k in cls.WORKER_ENV}
            os.environ.update(cls.WORKER_ENV)
            try:
                pool = ProcessPoolExecutor(
                    cls.WORKERS,
                    mp_context=multiprocessing.get_context("spawn"))
                for _ in range(cls.WORKERS):   # each starts a process now,
                    pool.submit(int)           # in this environment
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k)
                    else:
                        os.environ[k] = v
            cls._processes = pool
        return cls._processes

    def submit(self, tensors: Sequence[torch.Tensor], write) -> None:
        """`write(*arrays)` in a worker process, with copies of `tensors`
        (their values now) as host numpy arrays; `write` must pickle (a
        module-level function or a functools.partial of one)."""
        host = [t.detach().to("cpu", non_blocking=True, copy=True)
                for t in tensors]
        copied = None
        if any(t.is_cuda for t in tensors):
            copied = torch.cuda.Event()
            copied.record()
        while self._jobs and (self._jobs[0].done()
                              or len(self._jobs) >= self.MAX_PENDING):
            self._jobs.popleft().result()
        pool = self._pool()

        def job():
            if copied is not None:
                copied.synchronize()
            return pool.submit(write, *[h.numpy() for h in host]).result()
        self._jobs.append(self._waiters.submit(job))

    def __enter__(self) -> "HostWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        try:
            while self._jobs and exc_type is None:
                self._jobs.popleft().result()
        finally:
            self._waiters.shutdown(wait=True, cancel_futures=True)


def _image2save(arr: np.ndarray, mode: str) -> np.ndarray:
    """[C, H, W] float -> [H, W, 3] uint8 (reference image2save,
    train.py:74-96): a language map is taken to (x + 1) / 2 and, when wider
    than 3 channels, to its top three principal components scaled to
    [0, 1] (`eval/colormaps.pca3`, scikit-learn's PCA)."""
    if mode == "lang":
        arr = (arr + 1.0) / 2.0
        if arr.shape[0] > 3:
            c, h, w = arr.shape
            flat = pca3(torch.from_numpy(np.ascontiguousarray(
                arr.reshape(c, -1).T))).numpy()
            fmap = (flat - flat.min()) / (flat.max() - flat.min() + 1e-12)
            return (fmap.reshape(h, w, 3) * 255).astype(np.uint8)
    img = np.clip(arr[:3].transpose(1, 2, 0), 0, 1)
    return (img * 255).astype(np.uint8)


def _debug_image_dump(model_path: str, stage: str, iteration: int,
                      render_img, gt_img, lang_img, gt_lang_img) -> str:
    """The rgb|gt|lang|gt_lang grid (reference train.py:314-327) as
    training_output_img/output_{stage}_{iteration}.png; returns its
    path."""
    images = [_image2save(np.asarray(render_img), "rgb"),
              _image2save(np.asarray(gt_img), "rgb"),
              _image2save(np.asarray(lang_img), "lang"),
              _image2save(np.asarray(gt_lang_img), "lang")]
    h = max(im.shape[0] for im in images)
    grid = np.zeros((h, sum(im.shape[1] for im in images), 3), np.uint8)
    x = 0
    for im in images:
        grid[:im.shape[0], x:x + im.shape[1]] = im
        x += im.shape[1]
    save_dir = os.path.join(model_path, "training_output_img")
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"output_{stage}_{iteration}.png")
    with open(path, "wb") as f:
        f.write(png_bytes(grid))
    return path


def _payload_batch(batch: PackedPayload, device) -> Batch:
    """The PackedPayload as a full Batch (its ground truth decoded on the
    device), for the debug grid and the forensics dump."""
    rows = torch.as_tensor(np.asarray(batch.packed, np.float32)).to(device)
    return materialize_batch(packed_batch(rows, batch.imgs, batch.segs,
                                          batch.tables))


def _debug_grid(cfg: Config, state: TrainState, step_cfg: StepConfig,
                stage: str, iteration: int, cams, batch: PackedPayload,
                bg, writer: HostWriter) -> None:
    """One extra forward of the iteration's first camera at log cadence
    (the step keeps its images on the device) and the grid of it, its
    ground truth, its language map and the language ground truth (zeros
    where the stage has none), written by `writer`."""
    out = eval_step(step_cfg, state, cams[0].camera_params(state.device),
                    cams[0].time, bg, state.active_sh_degree)
    full = _payload_batch(batch, state.device)
    gt_lang = (full.gt_lang[0] if full.gt_lang is not None
               else torch.zeros((cfg.runtime.language_feature_hiddendim,)
                                + tuple(full.gt_images.shape[2:]),
                                device=state.device))
    lang = out["language_feature_image"]
    if lang is None or lang.shape[0] == 0:
        lang = torch.zeros_like(gt_lang)
    writer.submit([out["render"], full.gt_images[0], lang, gt_lang],
                  functools.partial(_debug_image_dump, cfg.model.model_path,
                                    stage, iteration))


def _gui_poll(cfg: Config, scene: Scene, state: TrainState,
              step_cfg: StepConfig, stage: str, iteration: int,
              final_iter: int, bg, gui_ctx: dict) -> None:
    """The viewer bridge, once a training iteration (reference
    train.py:166-191): accept a pending viewer, render each camera it asks
    for at the cycled video-camera time through `render/pipeline.render`,
    and send the frame's RGB bytes back. Without a listener, nothing; with
    no viewer, one non-blocking accept. A viewer that hangs up or sends a
    bad message is dropped, and training goes on."""
    if network_gui.listener is None:
        return
    if network_gui.conn is None:
        network_gui.try_connect()
    while network_gui.conn is not None:
        try:
            (custom_cam, do_training, _shs, _cov, keep_alive,
             scaling_mod) = network_gui.receive()
        except (OSError, ValueError, KeyError) as e:
            logger.warning("viewer dropped: %s", e)
            network_gui.drop()
            return
        frame = None
        if custom_cam is not None:
            if "video_cams" not in gui_ctx:
                gui_ctx["video_cams"] = list(scene.getVideoCameras())
            video_cams = gui_ctx["video_cams"]
            gui_ctx["count"] = count = gui_ctx.get("count", 0) + 1
            t = 0.0
            if video_cams:
                vi = count % len(video_cams)
                if (count // len(video_cams)) % 2 != 0:
                    vi = len(video_cams) - vi - 1
                t = float(video_cams[vi].time)
            dev = state.device

            def f32(a):
                return torch.as_tensor(np.asarray(a, np.float32),
                                       device=dev)
            cam = CameraParams(
                viewmatrix=f32(custom_cam.world_view_transform),
                projmatrix=f32(custom_cam.full_proj_transform),
                campos=f32(custom_cam.camera_center),
                tanfovx=f32(np.tan(custom_cam.fovx * 0.5)),
                tanfovy=f32(np.tan(custom_cam.fovy * 0.5)))
            settings = dataclasses.replace(
                step_cfg.settings, image_height=custom_cam.height,
                image_width=custom_cam.width,
                sh_degree=int(state.active_sh_degree))
            with torch.no_grad():
                out = render(settings, step_cfg.dcfg, stage, cam, t,
                             state.gaussians(), state.deform, state.aabb, bg,
                             scaling_modifier=float(scaling_mod or 1.0),
                             nonormalized=step_cfg.nonormalized)
            img = torch.clamp(out["render"], 0.0, 1.0).cpu().numpy()
            frame = memoryview(np.ascontiguousarray(
                (img * 255).astype(np.uint8).transpose(1, 2, 0)))
        try:
            network_gui.send(frame, cfg.model.source_path or "")
        except OSError as e:
            logger.warning("viewer dropped: %s", e)
            network_gui.drop()
            return
        if do_training and (iteration < final_iter or not keep_alive):
            break


def _snapshot_state(state: TrainState) -> dict:
    """A copy of what a step reads and writes, on the device (the step
    updates the state in place, so a reference would not keep it)."""
    return dict(
        params={k: v.detach().clone() for k, v in state.params.items()},
        deform={k: v.detach().clone()
                for k, v in state.deform.state_dict().items()},
        opt_m={k: v.clone() for k, v in state.opt.m.items()},
        opt_v={k: v.clone() for k, v in state.opt.v.items()},
        opt_step=state.opt.step, num_active=state.num_active,
        active_sh_degree=state.active_sh_degree,
        **{k: getattr(state, k).clone() for k in _BUFFERS})


def _to_numpy(tree):
    """Tensors as numpy arrays, named tuples as dicts, in nested dicts,
    lists and tuples."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _params_finite(state: TrainState) -> bool:
    return bool(torch.stack([torch.isfinite(v).all() for v in
                             state.leaves().values()]).all())


def _nan_forensics_dump(cfg: Config, stage: str, iteration: int, window,
                        bg, state: TrainState, step_cfg: StepConfig) -> str:
    """The window of (iteration, state before the step, batch) as numpy
    arrays in one pickle, nan_forensics_{stage}_{iteration}.pkl in the
    model path; returns its path."""
    dump = os.path.join(cfg.model.model_path or ".",
                        f"nan_forensics_{stage}_{iteration}.pkl")
    with open(dump, "wb") as fh:
        pickle.dump(dict(
            stage=stage,
            window=[(it, _to_numpy(snap), _to_numpy(b))
                    for it, snap, b in window],
            bg=_to_numpy(bg), active_sh_degree=int(state.active_sh_degree),
            step_cfg=step_cfg), fh)
    return dump


def render_process_snapshot(cfg: Config, scene: Scene, state: TrainState,
                            step_cfg: StepConfig, stage: str, iteration: int,
                            bg, elapsed: float, writer: HostWriter) -> None:
    """The GT | render | depth triptych of one test and one train camera
    (train.py:376-382 render_process) in model_path/render_process, as
    `{stage}{split}_{iteration}.jpg`, written by `writer`."""
    out_dir = os.path.join(cfg.model.model_path, "render_process")
    for split_name, cams in (("test", scene.getTestCameras()),
                             ("train", scene.getTrainCameras())):
        if len(cams) == 0:
            continue
        cam = cams[iteration % len(cams)]
        out = eval_step(step_cfg, state, cam.camera_params(state.device),
                        cam.time, bg, state.active_sh_degree)
        writer.submit([out["render"], out["depth"]], functools.partial(
            render_training_image, out_dir, stage + split_name, iteration,
            elapsed, cam.image[:3], point_count=state.num_active))


def render_process_due(iteration: int) -> bool:
    """The snapshots' cadence (train.py:376-382)."""
    return ((iteration < 1000 and iteration % 10 == 9)
            or (iteration < 3000 and iteration % 50 == 49)
            or (iteration < 60000 and iteration % 100 == 99))


@contextlib.contextmanager
def deterministic_on(device: torch.device):
    """PyTorch's deterministic algorithms for the duration, on a GPU, in
    every stage: the gradient rows reach the Gaussians through `index_add_`,
    whose CUDA version adds with atomics unless the switch is on, and the
    HexPlane's plane gradient (`ops/grid_sample.py`) sums each cell in a
    fixed order, so two identical runs of any stage are bit-equal
    (chip_smoke.py phase 21). warn_only: an operation without a
    deterministic version warns and runs. Uninitialized memory is not
    filled (every kernel writes its whole output)."""
    if device.type != "cuda":
        yield
        return
    import torch.utils.deterministic as det
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        det.fill_uninitialized_memory = saved[2]


def _viewer_connected() -> bool:
    """Whether a viewer is connected, after one non-blocking accept."""
    if network_gui.listener is None:
        return False
    if network_gui.conn is None:
        network_gui.try_connect()
    return network_gui.conn is not None


def _mesh_decides(mesh: Optional[Mesh], flag: bool) -> bool:
    """One decision for every rank: whether any rank's `flag` is set."""
    if mesh is None:
        return flag
    return bool(mesh.all_reduce(torch.tensor([int(flag)]),
                                torch.distributed.ReduceOp.MAX,
                                axis="world")[0])


def scene_reconstruction(cfg: Config, scene: Scene, state: TrainState,
                         dcfg: DeformConfig, stage: str, joint_train: bool,
                         train_iter: int, timer: Timer,
                         rng_seed: int = 0,
                         mesh: Optional[Mesh] = None) -> TrainState:
    """One curriculum stage (reference scene_reconstruction,
    train.py:98-427), on the state's device; with a `mesh`, this rank's
    part of it on its share of the state (`shard_state`)."""
    opt, ex = cfg.optim, cfg.extras
    device = state.device
    root = mesh is None or mesh.is_root
    if mesh is not None and os.getenv("LS4D_NAN_FORENSICS"):
        raise ValueError("LS4D_NAN_FORENSICS keeps a window of whole "
                         "states: run it on one rank")

    whole_at: dict = {}

    def whole() -> TrainState:
        """The whole state, gathered on every rank (a collective) once until
        the state next changes, when `whole_at` is cleared."""
        if mesh is None:
            return state
        if "state" not in whole_at:
            whole_at["state"] = unshard_state(state, mesh)
        return whole_at["state"]
    rng = random.Random(rng_seed)
    split_gen = torch.Generator(device=device).manual_seed(rng_seed + 7)
    logger.info("stage:%s begin... train_iter:%d, joint_train:%s", stage,
                train_iter, joint_train)
    telemetry = Telemetry((cfg.model.model_path or None) if root else None,
                          wandb_name=cfg.extras.expname)
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.model.white_background
                      else [0.0, 0.0, 0.0], device=device)
    train_cams = scene.getTrainCameras()
    batch_size = opt.batch_size if "base" in stage else 1
    first = train_cams[0]
    settings = RasterSettings(
        image_height=first.height, image_width=first.width, sh_degree=0,
        include_feature="base" not in stage, tile_size=cfg.runtime.tile_size,
        tile_capacity=cfg.runtime.tile_capacity, analytic_vjp=True,
        stream_train=bool(cfg.runtime.stream_train))
    step_cfg = StepConfig(
        settings=settings, dcfg=dcfg,
        lr_cfg=LRConfig.from_optim(opt, scene.cameras_extent), stage=stage,
        joint_train=joint_train, no_dlang=bool(cfg.hidden.no_dlang),
        lam=ex.lam, beta=ex.beta, addcosloss=cfg.runtime.addcosloss,
        lambda_dssim=opt.lambda_dssim, nonormalized=cfg.runtime.nonormalized,
        # the reference's plane-regularizer guard (`stage == "fine"`) never
        # matches its stage names (train.py:331); runtime.plane_reg applies
        # the presets' weights in fine stages, as the JAX package does
        time_smoothness_weight=(cfg.hidden.time_smoothness_weight
                                if (cfg.runtime.plane_reg
                                    and stage.startswith("fine")) else 0.0),
        l1_time_planes=cfg.hidden.l1_time_planes,
        plane_tv_weight=cfg.hidden.plane_tv_weight, batch_size=batch_size,
        mesh=mesh)
    # the batch splits over the data axis where its size divides over it
    data_split = (mesh is not None and mesh.data > 1
                  and batch_size % mesh.data == 0)
    split = "train"
    gui_ctx: dict = {}
    forensics = (deque(maxlen=12) if os.getenv("LS4D_NAN_FORENSICS")
                 else None)

    def batch_source():
        """Camera sampling and the batch build, run ahead of the step on the
        producer thread (data/prefetch.py)."""
        if opt.dataloader:
            sampler = (FineSampler(train_cams)
                       if opt.custom_sampler is not None else None)
            loader = iter(BatchLoader(train_cams, batch_size, sampler=sampler,
                                      seed=rng_seed))
        else:
            loader = None
            viewpoint_stack = list(range(len(train_cams)))
            temp_list = list(viewpoint_stack)
        for it in range(1, train_iter + 1):
            if loader is not None:
                try:
                    cams = next(loader)
                except StopIteration:
                    loader = iter(BatchLoader(train_cams, batch_size,
                                              seed=rng_seed + it))
                    cams = next(loader)
            else:
                cams = []
                for _ in range(batch_size):
                    idx = viewpoint_stack.pop(
                        rng.randrange(len(viewpoint_stack)))
                    if not viewpoint_stack:
                        viewpoint_stack.extend(temp_list)
                    cams.append(train_cams[idx])
            mine = shard_batch(cams, mesh) if data_split else cams
            yield cams, build_batch(mine, cfg, scene, it, device, split,
                                    need_lang="base" not in stage)

    batch_iter = prefetch(batch_source(), depth=cfg.runtime.prefetch_depth)
    ema_loss = 0.0
    # The losses stay on the device and are read in one copy every 10
    # iterations; the watchdog then fires at most 9 iterations late.
    pending: List[tuple] = []
    grow_ctx = {"density_threshold": 5.0, "displacement_scale": 5.0}

    def drain_losses() -> float:
        nonlocal ema_loss
        if not pending:
            return ema_loss
        vals = torch.stack([d for _, d in pending]).cpu().numpy()
        for (it, _), v in zip(pending, vals):
            v = float(v)
            if not np.isfinite(v):
                logger.info("loss is nan, end training, reexecv program now.")
                _watchdog_restart(cfg, f"loss is nan at iteration {it}")
            if v > 0.5 and it > 100 and "coarse-lang" not in stage:
                logger.info("loss bigger than 0.5, end training, "
                            "reexecv program now.")
                _watchdog_restart(cfg, f"loss {v} > 0.5 at iteration {it}")
            ema_loss = 0.4 * v + 0.6 * ema_loss
        pending.clear()
        return float(vals[-1])

    with deterministic_on(device), HostWriter() as writer:
        for iteration in range(1, train_iter + 1):
            if mesh is None:
                _gui_poll(cfg, scene, state, step_cfg, stage, iteration,
                          train_iter, bg, gui_ctx)
            elif cfg.extras.port >= 0 and _mesh_decides(
                    mesh, root and _viewer_connected()):
                # rank 0 serves the viewer from the whole state
                full = whole()
                if root:
                    _gui_poll(cfg, scene, full, step_cfg._replace(mesh=None),
                              stage, iteration, train_iter, bg, gui_ctx)
            if iteration % 1000 == 0:
                one_up_sh_degree(state, cfg.model.sh_degree)
            cams, batch = next(batch_iter)
            if forensics is not None:
                # debug mode: the last 12 steps' inputs, copied (the step
                # updates the state in place), and a finite check of the
                # parameters at the loss drain; a trip dumps the window
                forensics.append((iteration, _snapshot_state(state),
                                  _payload_batch(batch, device)))
            state, metrics, vs_grad, visibility, radii_max = train_step_packed(
                step_cfg, state, batch.packed, batch.imgs, batch.segs,
                batch.tables, bg, state.active_sh_degree)
            pending.append((iteration, metrics["loss"]))
            whole_at.clear()                 # the step changed the state
            if (forensics is not None and iteration % 10 == 0
                    and not _params_finite(state)):
                dump = _nan_forensics_dump(cfg, stage, iteration, forensics,
                                           bg, state, step_cfg)
                logger.error("NaN window dumped to %s", dump)
                _watchdog_restart(cfg, f"params non-finite at iteration "
                                       f"{iteration} (forensics dumped)")

            if iteration % 10 == 0 or iteration == train_iter:
                loss = drain_losses()
                telemetry.scalars(
                    {f"{stage}/train_loss_patches/l1_loss": loss,
                     f"{stage}/train_loss_patchestotal_loss": loss,
                     f"{stage}/total_points": state.num_active}, iteration)
            # rank 0 writes, from the whole state, with the one-rank step
            one_cfg = step_cfg._replace(mesh=None)
            if iteration % 100 == 0:
                logger.info("[%s] iter %d/%d loss %.6f points %d", stage,
                            iteration, train_iter, ema_loss, state.num_active)
                if cfg.model.model_path:
                    full = whole()
                    if root:
                        _debug_grid(cfg, full, one_cfg, stage, iteration,
                                    cams, batch, bg, writer)

            timer.pause()
            if iteration in ex.test_iterations:
                full = whole()
                if root:
                    training_report(cfg, scene, full, one_cfg, stage,
                                    iteration, bg, telemetry=telemetry)
            if iteration in ex.save_iterations and "coarse-base" not in stage:
                logger.info("[ITER %d] Saving Gaussians", iteration)
                full = whole()
                if root:
                    save_scene(cfg, full, iteration, stage,
                               cfg.model.model_path)
            if cfg.model.render_process and render_process_due(iteration):
                full = whole()
                if root:
                    render_process_snapshot(cfg, scene, full, one_cfg, stage,
                                            iteration, bg,
                                            timer.get_elapsed_time(), writer)
            whole_at.clear()             # densification changes the state
            timer.start()

            # densification (base stages only, train.py:388-414)
            if iteration < opt.densify_until_iter and "base" in stage:
                D.update_max_radii(state, radii_max, visibility)
                D.add_densification_stats(state, vs_grad, visibility)
                if "coarse" in stage:
                    opacity_threshold = opt.opacity_threshold_coarse
                    densify_threshold = opt.densify_grad_threshold_coarse
                else:
                    opacity_threshold = opt.opacity_threshold_fine_init \
                        - iteration * (opt.opacity_threshold_fine_init
                                       - opt.opacity_threshold_fine_after) \
                        / opt.densify_until_iter
                    densify_threshold = opt.densify_grad_threshold_fine_init \
                        - iteration * (opt.densify_grad_threshold_fine_init
                                       - opt.densify_grad_threshold_after) \
                        / opt.densify_until_iter
                if (iteration > opt.densify_from_iter
                        and iteration % opt.densification_interval == 0
                        and state.num_active < opt.max_points):
                    state = apply_unsharded(state, mesh, functools.partial(
                        D.densify, max_grad=densify_threshold,
                        extent=scene.cameras_extent,
                        percent_dense=opt.percent_dense,
                        generator=split_gen))
                    capacity = state.full_capacity or state.capacity
                    if state.num_active >= capacity:
                        logger.warning(
                            "Gaussian capacity %d saturated; further "
                            "densification drops new points. Raise "
                            "runtime.capacity_granule / optim.max_points.",
                            capacity)
                if (iteration > opt.pruning_from_iter
                        and iteration % opt.pruning_interval == 0
                        and state.num_active > opt.min_points_for_prune):
                    size_threshold = (
                        20.0 if iteration > opt.opacity_reset_interval
                        else 0.0)
                    state = apply_unsharded(state, mesh, functools.partial(
                        D.prune, min_opacity=opacity_threshold,
                        scene_extent=scene.cameras_extent,
                        max_screen_size=size_threshold))
                if (opt.add_point
                        and iteration % opt.densification_interval == 0
                        and state.num_active < opt.max_points):
                    # the thresholds halve after a round that adds < 100
                    # points, as the reference's state does
                    # (gaussian_model.py:694-697)
                    state, added = apply_unsharded(
                        state, mesh, functools.partial(
                            D.grow,
                            density_threshold=grow_ctx["density_threshold"],
                            displacement_scale=grow_ctx["displacement_scale"],
                            seed=iteration))
                    if added < 100:
                        grow_ctx["density_threshold"] /= 2
                        grow_ctx["displacement_scale"] /= 2
                    logger.info("point growing, add point num:%d", added)
                if iteration % opt.opacity_reset_interval == 0:
                    logger.info("reset opacity")
                    state = apply_unsharded(state, mesh, D.reset_opacity)
                # The switch to the stream layout when the tile lists
                # truncate, at densify cadence, on the GPU only: the CPU
                # keeps the lists, as the JAX package keeps them off the TPU.
                # Under a mesh every rank probes the whole state and the
                # ranks take one decision, or they would diverge onto
                # different layouts and deadlock in the next collective.
                if (cfg.runtime.stream_train_auto
                        and not step_cfg.settings.stream_train
                        and device.type == "cuda"
                        and iteration % opt.densification_interval == 0):
                    switched = maybe_stream_switch(
                        step_cfg.settings, unshard_state(state, mesh)
                        if mesh is not None else state, train_cams,
                        iteration)
                    if _mesh_decides(mesh, switched is not None):
                        step_cfg = step_cfg._replace(
                            settings=dataclasses.replace(
                                step_cfg.settings, stream_train=True))

            if iteration in ex.checkpoint_iterations and "fine" in stage:
                full = whole()
                whole_at.clear()
                if root:
                    save_checkpoint(full, iteration, stage,
                                    cfg.model.model_path, dcfg)

    telemetry.close()
    return state


@torch.no_grad()
def training_report(cfg: Config, scene: Scene, state: TrainState,
                    step_cfg: StepConfig, stage: str, iteration: int, bg,
                    telemetry: Optional[Telemetry] = None) -> dict:
    """Held-out L1 / PSNR at the test iterations (reference training_report,
    train.py:487-539): a sparse sweep of the test and train cameras, the
    first 5 views' renders (and the ground truth at the first test
    iteration), the opacity and motion histograms, total_points,
    deformation_rate, and the tile lists' truncation. Returns
    {split: (l1, psnr)}."""
    from langsplat4d_torch.train.losses import l1_loss, psnr

    first_test_iter = (min(cfg.extras.test_iterations)
                       if cfg.extras.test_iterations else iteration)
    result = {}
    for name, cams in (("test", scene.getTestCameras()),
                       ("train", scene.getTrainCameras())):
        if len(cams) == 0:
            continue
        idxs = [i % len(cams) for i in range(10, 5000, 299)]
        l1_total = psnr_total = 0.0
        for k, i in enumerate(idxs):
            cam = cams[i]
            out = eval_step(step_cfg, state, cam.camera_params(state.device),
                            cam.time, bg, state.active_sh_degree)
            img = torch.clamp(out["render"], 0.0, 1.0)
            gt = torch.clamp(torch.from_numpy(cam.image[:3]).to(
                state.device), 0.0, 1.0)
            if telemetry is not None and k < 5:
                telemetry.image(f"{stage}/{name}_view_{cam.image_name}/render",
                                img.cpu().numpy(), iteration)
                if iteration == first_test_iter:
                    telemetry.image(
                        f"{stage}/{name}_view_{cam.image_name}/ground_truth",
                        gt.cpu().numpy(), iteration)
            l1_total += float(l1_loss(img, gt))
            psnr_total += float(psnr(img, gt))
        n = len(idxs)
        result[name] = (l1_total / n, psnr_total / n)
        logger.info("[ITER %d] Evaluating %s: L1 %s PSNR %s", iteration,
                    name, l1_total / n, psnr_total / n)
        if telemetry is not None:
            telemetry.scalars(
                {f"{stage}/{name}/loss_viewpoint - l1_loss": l1_total / n,
                 f"{stage}/{name}/loss_viewpoint - psnr": psnr_total / n},
                iteration)
    n_act = state.num_active
    if telemetry is not None:
        logit_op = state.params["opacity"][:n_act].cpu().numpy()
        telemetry.histogram(f"{stage}/scene/opacity_histogram",
                            1.0 / (1.0 + np.exp(-logit_op)), iteration)
        telemetry.scalars(
            {f"{stage}/total_points": n_act,
             f"{stage}/deformation_rate":
                 float(state.deformation_table[:n_act].sum()) / max(n_act, 1)},
            iteration)
        telemetry.histogram(
            f"{stage}/scene/motion_histogram",
            state.deformation_accum[:n_act].mean(-1).cpu().numpy() / 100.0,
            iteration)
    # the binning truncation probe: a full list may have dropped Gaussians
    test_cams = scene.getTestCameras()
    if len(test_cams) == 0:
        test_cams = scene.getTrainCameras()
    if len(test_cams) > 0:
        stats = binning_report(step_cfg.settings,
                               test_cams[0].camera_params(state.device),
                               state.gaussians())
        result["tile_full_frac"] = stats["tile_full_frac"]
        msg = (f"[ITER {iteration}] binning: full tile lists "
               f"{stats['tile_full_frac']:.1%}, longest "
               f"{int(stats['tile_max_count'])} of "
               f"{step_cfg.settings.tile_capacity}")
        if stats["tile_full_frac"] > FULL_LIST_LIMIT:
            logger.warning(msg + " — capacity saturated; raise "
                           "tile_capacity or train on the stream layout.")
        else:
            logger.info(msg)
    return result


def training(cfg: Config, device=None) -> TrainState:
    """The curriculum (reference training(), train.py:428-466): the scene
    from cfg.model.source_path, the initial state, then coarse-base,
    coarse-lang, fine-base and fine-lang, each for its iteration budget.
    With `extras.resume_from_final_stage == 1` (phase B of
    scripts/train_eval.sh, train.py:436-441): the `start_checkpoint` state,
    its language features expanded into discrete centres
    (`prepare_discrete_stage`), and `fine-lang-discrete` for
    fine_lang_iterations + 10000 iterations; the DeformConfig comes from the
    config (`use_discrete_lang_f` from the environment), not from the
    checkpoint. `device=None` is the current CUDA device (an error where
    there is none).

    With `runtime.data_parallel` x `runtime.gaussian_shards` > 1, each of
    that many ranks (a torch.distributed process group, which the train
    CLI starts under torchrun) trains its share of the state on that mesh
    and returns it (`unshard_state` gives the whole); a world of another
    size raises."""
    device = resolve_device(device)
    mesh = training_mesh(cfg)
    root = mesh is None or mesh.is_root
    model_path = cfg.model.model_path
    if not model_path:
        model_path = os.path.join(cfg.runtime.exps_dir, cfg.extras.expname)
        cfg.model.model_path = model_path
    if root:
        os.makedirs(model_path, exist_ok=True)
        save_cfg_args(cfg, model_path)
    scene = Scene(cfg.model.source_path, images=cfg.model.images,
                  eval_split=cfg.model.eval, llffhold=cfg.model.llffhold,
                  white_background=cfg.model.white_background,
                  extension=cfg.model.extension,
                  add_random_points=cfg.model.add_points,
                  model_path=model_path)
    timer = Timer()
    timer.start()
    opt, ex = cfg.optim, cfg.extras
    if ex.resume_from_final_stage == 1:
        dcfg = DeformConfig.from_config(cfg.hidden, cfg.runtime,
                                        max_sh_degree=cfg.model.sh_degree)
        state, _ = load_checkpoint(ex.start_checkpoint, device=device,
                                   dcfg=dcfg)
        state = prepare_discrete_stage(cfg, state, dcfg,
                                       init_from_stage=ex.init_from_stage)
        return scene_reconstruction(cfg, scene, _shard(state, mesh), dcfg,
                                    "fine-lang-discrete", ex.joint_fine,
                                    opt.fine_lang_iterations + 10000, timer,
                                    mesh=mesh)
    state, dcfg = init_state_from_scene(cfg, scene, seed=ex.seed,
                                        device=device)
    state = _shard(state, mesh)
    stages = [("coarse-base", False, opt.coarse_base_iterations),
              ("coarse-lang", ex.joint_coarse, opt.coarse_lang_iterations),
              ("fine-base", False, opt.fine_base_iterations),
              ("fine-lang", ex.joint_fine, opt.fine_lang_iterations)]
    for stage, joint, iters in stages:
        if iters > 0:
            state = scene_reconstruction(cfg, scene, state, dcfg, stage,
                                         joint, iters, timer, mesh=mesh)
    return state


def training_mesh(cfg: Config) -> Optional[Mesh]:
    """The mesh of `runtime.data_parallel` x `runtime.gaussian_shards`
    ranks, or None for one rank (raises where the process group's world
    has another size: no config trains on fewer ranks than it names)."""
    mesh = make_mesh(cfg.runtime.data_parallel, cfg.runtime.gaussian_shards)
    if mesh.size == 1:
        return None
    logger.info("mesh: data%d x gauss%d, rank %d", mesh.data, mesh.gauss,
                mesh.rank)
    return mesh


def _shard(state: TrainState, mesh: Optional[Mesh]) -> TrainState:
    return state if mesh is None else shard_state(state, mesh)


@torch.no_grad()
def deformed_lang_samples(state: TrainState, dcfg: DeformConfig,
                          lang: torch.Tensor,
                          sample_num: int = 100) -> torch.Tensor:
    """[cap, sample_num, L]: each Gaussian's deformed language feature at
    `sample_num` times, the times of sample s drawn per Gaussian from
    np.random.default_rng(0) as the JAX package draws them, through
    `deform_forward(..., init_centers=True)` with the language MLP on."""
    sample_cfg = dataclasses.replace(dcfg, no_dlang=False,
                                     use_discrete_lang_f=False)
    gs = state.gaussians()
    cap, dev = state.capacity, state.device
    rng = np.random.default_rng(0)
    feats = gs.get_features()
    samples = []
    for _ in range(sample_num):
        t = torch.from_numpy(rng.random((cap, 1)).astype(np.float32)).to(dev)
        out = deform_forward(state.deform, sample_cfg, state.aabb, gs.xyz,
                             gs.scaling, gs.rotation, gs.opacity, feats,
                             lang, t, init_centers=True)
        samples.append(out[5])
    return torch.stack(samples, dim=1)


def prepare_discrete_stage(cfg: Config, state: TrainState,
                           dcfg: DeformConfig,
                           init_from_stage: str = "fine-base",
                           sample_num: int = 100) -> TrainState:
    """Per-Gaussian discrete language centres (the reference's
    generate_multi_feature_centers, gaussian_model.py:804-845; JAX
    langsplat4d/train/loop.py:1123-1177), in place: `language_feature`
    becomes [cap, centers_num * L] in the reference's layout ([cap,
    centers, L] permuted to [cap, L, centers] and flattened,
    gaussian_model.py:230) with fresh Adam moments. From `fine-base`: each
    centre is the normalised feature plus N(0, 0.05) noise from
    np.random.default_rng(0), drawn on the host as the JAX package draws
    it. Otherwise: `sample_num` deformed samples of each live Gaussian
    (`deformed_lang_samples`) clustered into centres by the batched
    K-Means of ops/kmeans.py on the device, seeded from the uniforms
    scikit-learn's KMeans(random_state=0, n_init=10) draws for every
    Gaussian in the JAX package. Features already expanded are left as
    they are."""
    lang_dim = cfg.runtime.language_feature_hiddendim
    centers_num = cfg.runtime.centers_num
    lf = state.params["language_feature"]
    cap, n, dev = lf.shape[0], state.num_active, lf.device
    if lf.shape[1] != lang_dim:
        return state
    lf_np = lf.detach().cpu().numpy()
    lf_n = lf_np / (np.linalg.norm(lf_np, axis=-1, keepdims=True) + 1e-9)
    if init_from_stage == "fine-base":
        rng = np.random.default_rng(0)
        multi = torch.from_numpy(np.stack(
            [rng.normal(loc=lf_n, scale=0.05).astype(np.float32)
             for _ in range(centers_num)], axis=1)).to(dev)
    else:
        res = deformed_lang_samples(state, dcfg, torch.from_numpy(lf_n).to(
            dev), sample_num)
        centers, _ = kmeans(res[:n], centers_num)
        multi = torch.zeros((cap, centers_num, lang_dim), device=dev)
        multi[:n] = centers
    flat = multi.permute(0, 2, 1).reshape(cap, -1).contiguous()
    state.params["language_feature"] = flat
    state.opt.m["language_feature"] = torch.zeros_like(flat)
    state.opt.v["language_feature"] = torch.zeros_like(flat)
    return state
