"""Synthetic scenes.

`realistic_gaussians`: trained-checkpoint-like Gaussian states (numpy port
of langsplat4d/utils/synth.py; see its docstring for the distributions).
Gives the same arrays as the JAX package from the same seed: the random
draws happen in the same order, and the k-nearest-neighbour log-scales that
the JAX version computes through `create_from_pcd` are overwritten there
anyway, so they are not computed here.

`make_structured_scene`: the structured moving-ball HyperNeRF scene on
disk (port of tests/scene_fixture.py's), written with the port's own
writers, byte for byte the fixture's files.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from langsplat4d_torch.core import state as statelib
from langsplat4d_torch.core.device import resolve_device
from langsplat4d_torch.core.sh import rgb_to_sh
from langsplat4d_torch.data.png import png_from_rows
from langsplat4d_torch.data.readers import store_ply
from langsplat4d_torch.preprocess.image_prompt import pillow_rows


def realistic_gaussians(n: int, *, lang_dim: int = 3, seed: int = 0,
                        extent: float = 1.2, base_scale: float = 0.008,
                        scale_sigma: float = 0.9, capacity: int | None = None,
                        cameras_extent: float = 5.0,
                        percent_dense: float = 0.01,
                        straggler_frac: float = 0.015, device=None
                        ) -> statelib.GaussianState:
    """GaussianState with `n` active rows of trained-checkpoint-like
    statistics: clustered positions, log-normal scales softly capped at the
    densify-split invariant, broad opacities, random rotations. `device=None`
    is the current CUDA device (an error where there is none)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    # positions: clusters flattened onto planes + a background shell
    n_clusters = 48
    n_bg = int(n * 0.15)
    n_fg = n - n_bg
    centers = rng.uniform(-extent, extent, size=(n_clusters, 3))
    weights = rng.dirichlet(np.full(n_clusters, 0.5))
    sigmas = np.exp(rng.normal(np.log(0.12 * extent), 0.6, n_clusters))
    assign = rng.choice(n_clusters, size=n_fg, p=weights)
    pts_fg = centers[assign] + rng.normal(size=(n_fg, 3)) * sigmas[assign, None]
    squash_axis = rng.integers(0, 3, n_clusters)
    for c in range(n_clusters):
        m = assign == c
        a = squash_axis[c]
        pts_fg[m, a] = centers[c, a] + (pts_fg[m, a] - centers[c, a]) * 0.1
    pts_bg = rng.uniform(-2.0 * extent, 2.0 * extent, size=(n_bg, 3))
    pts = np.concatenate([pts_fg, pts_bg]).astype(np.float32)
    pts = np.clip(pts, -2.0 * extent, 2.0 * extent)

    # scales: log-normal x anisotropy, tanh-capped at the split invariant,
    # plus stragglers up to 4x past it
    base = rng.normal(np.log(base_scale), scale_sigma, size=(n, 1))
    aniso = rng.normal(0.0, 0.5, size=(n, 3))
    base[n_fg:] += np.log(3.0)
    scales = np.exp(base + aniso)
    split_cap = percent_dense * cameras_extent
    scales = split_cap * np.tanh(scales / split_cap)
    n_strag = int(n * straggler_frac)
    strag = rng.choice(n, size=n_strag, replace=False)
    scales[strag] *= rng.uniform(1.0, 4.0, size=(n_strag, 1))
    log_scales = np.log(np.maximum(scales, 1e-9)).astype(np.float32)

    # opacity: broad in logit space, floored at the prune threshold
    op = 1.0 / (1.0 + np.exp(-rng.normal(0.5, 2.0, size=(n, 1))))
    op = np.clip(op, 0.006, 0.995).astype(np.float32)
    logit_op = np.log(op / (1.0 - op)).astype(np.float32)

    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    cap = capacity or statelib.round_capacity(n)

    lang = rng.normal(size=(n, lang_dim)).astype(np.float32)
    lang /= np.linalg.norm(lang, axis=1, keepdims=True) + 1e-9
    f_rest = rng.normal(0.0, 0.02, size=(cap, 15, 3)).astype(np.float32)

    def pad(a, fill=0.0):
        out = np.full((cap,) + a.shape[1:], fill, np.float32)
        out[:n] = a
        return out

    arrays = dict(
        xyz=pad(pts),
        features_dc=pad(rgb_to_sh(cols)[:, None, :]),
        features_rest=f_rest,
        scaling=pad(log_scales, fill=-10.0),
        rotation=pad(q),
        opacity=pad(logit_op, fill=-10.0),
        language_feature=pad(lang),
    )
    return statelib.GaussianState(
        **{k: torch.from_numpy(v).to(device) for k, v in arrays.items()},
        num_active=n)


def make_structured_scene(root, n_imgs=16, hw=64, lang_dim=3, clip_dim=16,
                          seed=0, n_obj_points=600, n_bg_points=900):
    """A 3D-consistent nerfies scene in `root` with a moving ball whose
    language features are spatially coherent: an orange ball of radius 0.8
    at [0.4 sin(2 pi t), 0, 0] before a grey backdrop plane at z = 2.5,
    `n_imgs` cameras on an arc of radius 5, rgb/2x frames of hw x hw
    rendered analytically with seeded noise (PNGs as PIL writes them),
    `points3D_downsample2.ply` (ball surface and wall), and
    language_features/ with the raw `clip_dim`-wide features of two
    segments, ball and background, at all four levels (the AE's input).
    The same files as tests/scene_fixture.make_structured_scene from the
    same arguments (`lang_dim` is unused there too). -> (root, info): info
    holds f_obj, f_bg, the ball masks {frame: uint8 [hw, hw]} and
    clip_dim."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    ids = [f"{i:06d}" for i in range(n_imgs)]
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"ids": ids, "val_ids": [], "train_ids": ids}, f)
    meta = {iid: {"camera_id": 0, "warp_id": int(i), "appearance_id": 0}
            for i, iid in enumerate(ids)}
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(root, "scene.json"), "w") as f:
        json.dump({"near": 0.1, "far": 10.0, "scale": 1.0,
                   "center": [0.0, 0.0, 0.0]}, f)

    os.makedirs(os.path.join(root, "camera"), exist_ok=True)
    os.makedirs(os.path.join(root, "rgb", "2x"), exist_ok=True)
    focal = 2.0 * hw
    radius_ball = 0.8
    bg_z = 2.5
    obj_color = np.array([0.9, 0.45, 0.1])
    bg_color = np.array([0.35, 0.38, 0.42])
    masks = {}
    for i, iid in enumerate(ids):
        angle = 0.12 * (i - n_imgs / 2)
        c = np.array([5 * np.sin(angle), 0.0, -5 * np.cos(angle)])
        z = -c / np.linalg.norm(c)
        x = np.cross(np.array([0, 1.0, 0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_w2c = np.stack([x, y, z])
        cam = {
            "orientation": R_w2c.tolist(), "position": c.tolist(),
            "focal_length": focal, "principal_point": [hw, hw],
            "skew": 0.0, "pixel_aspect_ratio": 1.0,
            "radial_distortion": [0, 0, 0], "tangential_distortion": [0, 0],
            "image_size": [2 * hw, 2 * hw],
        }
        with open(os.path.join(root, "camera", f"{iid}.json"), "w") as f:
            json.dump(cam, f)

        t = i / max(1, n_imgs - 1)
        center = np.array([0.4 * np.sin(2 * np.pi * t), 0.0, 0.0])
        # the ball and backdrop ray-cast at half resolution (focal hw,
        # principal point hw / 2)
        yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64)
        dirs = np.stack([(xx - hw / 2) / hw, (yy - hw / 2) / hw,
                         np.ones_like(xx)], axis=-1)
        dirs_w = dirs @ R_w2c
        oc = c - center
        b = 2.0 * (dirs_w @ oc)
        cc = oc @ oc - radius_ball ** 2
        disc = b * b - 4.0 * (dirs_w ** 2).sum(-1) * cc
        hit = disc > 0
        img = np.tile(bg_color, (hw, hw, 1))
        tq = (-b - np.sqrt(np.maximum(disc, 0.0))) / (
            2.0 * (dirs_w ** 2).sum(-1) + 1e-12)
        p_hit = c + dirs_w * tq[..., None]
        normal = (p_hit - center) / radius_ball
        light = np.clip(normal @ np.array([0.4, 0.6, -0.69]), 0, 1)
        shade = (0.45 + 0.55 * light)[..., None]
        img[hit] = (obj_color * shade[hit])
        img += rng.normal(0, 0.01, size=img.shape)
        img = np.clip(img, 0, 1)
        img8 = (img * 255).astype(np.uint8)
        rows = pillow_rows(torch.from_numpy(img8)).numpy()
        with open(os.path.join(root, "rgb", "2x", f"{iid}.png"), "wb") as f:
            f.write(png_from_rows(rows, hw, 3, pillow=True))
        masks[i] = hit.astype(np.uint8)

    sph = rng.normal(size=(n_obj_points, 3))
    sph /= np.linalg.norm(sph, axis=-1, keepdims=True)
    obj_pts = sph * radius_ball
    wall = np.stack([rng.uniform(-3, 3, n_bg_points),
                     rng.uniform(-3, 3, n_bg_points),
                     np.full(n_bg_points, bg_z)], axis=1)
    pts = np.concatenate([obj_pts, wall])
    cols = np.concatenate([np.tile(obj_color * 255, (n_obj_points, 1)),
                           np.tile(bg_color * 255, (n_bg_points, 1))])
    store_ply(os.path.join(root, "points3D_downsample2.ply"), pts, cols)

    f_obj = rng.normal(size=clip_dim).astype(np.float32)
    f_obj /= np.linalg.norm(f_obj)
    f_bg = rng.normal(size=clip_dim).astype(np.float32)
    f_bg -= (f_bg @ f_obj) * f_obj      # orthogonal: a clean relevancy
    f_bg /= np.linalg.norm(f_bg)
    feats = np.stack([f_obj, f_bg])
    lf_dir = os.path.join(root, "language_features")
    os.makedirs(lf_dir, exist_ok=True)
    # frame i reads rid i + 1 in every split (the i % 4 split's train,
    # test and video cameras coincide there)
    for i in range(n_imgs):
        seg1 = np.where(masks[i] > 0, 0, 1).astype(np.int32)
        seg = np.stack([seg1] * 4)
        rid = i + 1
        np.save(os.path.join(lf_dir, f"{rid:06d}_s.npy"), seg)
        np.save(os.path.join(lf_dir, f"{rid:06d}_f.npy"), feats)
    info = {"f_obj": f_obj, "f_bg": f_bg, "masks": masks,
            "clip_dim": clip_dim}
    return root, info
