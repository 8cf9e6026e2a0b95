"""Synthetic trained-checkpoint-like Gaussian scenes (numpy port of
langsplat4d/utils/synth.py; see its docstring for the distributions).

Gives the same arrays as the JAX package from the same seed: the random
draws happen in the same order, and the k-nearest-neighbour log-scales that
the JAX version computes through `create_from_pcd` are overwritten there
anyway, so they are not computed here.
"""
from __future__ import annotations

import numpy as np
import torch

from langsplat4d_torch.core import state as statelib
from langsplat4d_torch.core.device import resolve_device
from langsplat4d_torch.core.sh import rgb_to_sh


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
