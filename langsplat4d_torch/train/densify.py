"""Adaptive density control on the padded capacity: clone, split, prune,
opacity reset and point growing, with the Adam-moment surgery they imply
(port of langsplat4d/train/densify.py; reference
scene/gaussian_model.py:391-394, 446-539, 575-627, 714-731, 746-748).

The state keeps its capacity: rows [0, num_active) are live, and nothing is
reallocated. Removing rows is a stable partition, the keepers first in their
order, after which the freed rows are reset to neutral padding with zero
moments; appended rows go to num_active + offset + rank (rank among the
selected rows; rows past the capacity are dropped) with zero moments. The
rows therefore stand where the JAX package puts them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from langsplat4d_torch.core.state import PAD_LOG_SCALE, PAD_OPACITY_LOGIT
from langsplat4d_torch.core.transforms import inverse_sigmoid, quat_to_rotmat
from langsplat4d_torch.train.trainstate import (GAUSSIAN_KEYS, TrainState,
                                                reset_densification_stats)

AUX_KEYS = ("max_radii2d", "xyz_gradient_accum", "denom",
            "deformation_table", "deformation_accum")


@torch.no_grad()
def add_densification_stats(state: TrainState, vs_grad: torch.Tensor,
                            update_filter: torch.Tensor) -> TrainState:
    """xyz_gradient_accum += |grad_xy|, denom += 1 on the visible Gaussians
    (gaussian_model.py:746-748)."""
    norm = torch.linalg.norm(vs_grad[:, :2], dim=-1, keepdim=True)
    upd = update_filter[:, None]
    state.xyz_gradient_accum = state.xyz_gradient_accum + torch.where(
        upd, norm, 0.0)
    state.denom = state.denom + upd.to(state.denom.dtype)
    return state


@torch.no_grad()
def update_max_radii(state: TrainState, radii: torch.Tensor,
                     visibility: torch.Tensor) -> TrainState:
    """max_radii2D = max(max_radii2D, radii) on the visible (train.py:390)."""
    state.max_radii2d = torch.where(
        visibility, torch.maximum(state.max_radii2d, radii.to(torch.float32)),
        state.max_radii2d)
    return state


def _grads(state: TrainState) -> torch.Tensor:
    return torch.nan_to_num(state.xyz_gradient_accum / state.denom, nan=0.0,
                            posinf=0.0, neginf=0.0)


def _active(state: TrainState) -> torch.Tensor:
    return torch.arange(state.capacity, device=state.device) < state.num_active


def _gather_rows(state: TrainState, order: torch.Tensor,
                 num_active: int) -> TrainState:
    """Permute every per-Gaussian row (parameters, moments, buffers)."""
    for tree in (state.params, state.opt.m, state.opt.v):
        for k in GAUSSIAN_KEYS:
            tree[k] = tree[k][order]
    for k in AUX_KEYS:
        setattr(state, k, getattr(state, k)[order])
    state.num_active = int(num_active)
    return state


def _neutralize_padding(state: TrainState) -> TrainState:
    """Rows >= num_active back to neutral padding, with zero moments."""
    pad = ~_active(state)
    for k in GAUSSIAN_KEYS:
        arr = state.params[k]
        if k == "opacity":
            fill = torch.full_like(arr, PAD_OPACITY_LOGIT)
        elif k == "scaling":
            fill = torch.full_like(arr, PAD_LOG_SCALE)
        elif k == "rotation":
            fill = torch.cat([torch.ones_like(arr[:, :1]),
                              torch.zeros_like(arr[:, 1:])], dim=1)
        else:
            fill = torch.zeros_like(arr)
        mask = pad.reshape((-1,) + (1,) * (arr.ndim - 1))
        state.params[k] = torch.where(mask, fill, arr)
        for tree in (state.opt.m, state.opt.v):
            tree[k] = torch.where(mask, 0.0, tree[k])
    return state


@torch.no_grad()
def prune_points(state: TrainState, mask: torch.Tensor) -> TrainState:
    """Remove the masked live Gaussians by a stable partition, keepers first
    in their order (prune_points + _prune_optimizer,
    gaussian_model.py:461-508)."""
    kill = mask & _active(state)
    order = torch.argsort(kill.to(torch.int32), stable=True)
    n_new = state.num_active - int(kill.sum())
    return _neutralize_padding(_gather_rows(state, order, n_new))


def _append_rows(state: TrainState, new_rows, sel: torch.Tensor,
                 offset: int) -> TrainState:
    """Write the selected rows of `new_rows[k]` ([cap, ...]) to
    num_active + offset + rank, dropping those past the capacity; their
    moments are zeroed and their deformation_table entries copied from the
    source rows."""
    rank = torch.cumsum(sel.to(torch.int64), 0) - 1
    target = state.num_active + offset + rank
    src = torch.nonzero(sel & (target < state.capacity)).flatten()
    dst = target[src]
    for k in GAUSSIAN_KEYS:
        state.params[k] = state.params[k].index_copy(0, dst, new_rows[k][src])
        for tree in (state.opt.m, state.opt.v):
            tree[k] = tree[k].index_fill(0, dst, 0.0)
    state.deformation_table = state.deformation_table.index_copy(
        0, dst, state.deformation_table[src])
    return state


@torch.no_grad()
def densify_and_clone(state: TrainState, grad_threshold: float,
                      scene_extent: float, percent_dense: float) -> TrainState:
    """Clone the small Gaussians of large gradient
    (gaussian_model.py:607-627)."""
    grads = _grads(state)
    max_scale = torch.exp(state.params["scaling"]).max(dim=1).values
    sel = ((torch.linalg.norm(grads, dim=-1) >= grad_threshold)
           & (max_scale <= percent_dense * scene_extent) & _active(state))
    num_sel = int(sel.sum())
    rows = {k: state.params[k] for k in GAUSSIAN_KEYS}
    state = _append_rows(state, rows, sel, 0)
    state.num_active = min(state.num_active + num_sel, state.capacity)
    return reset_densification_stats(state)


@torch.no_grad()
def densify_and_split(state: TrainState, grad_threshold: float,
                      scene_extent: float, percent_dense: float,
                      generator: Optional[torch.Generator] = None,
                      n_split: int = 2,
                      draws: Optional[Sequence] = None) -> TrainState:
    """Split the large Gaussians of large gradient into `n_split` children
    sampled from them, then prune the originals
    (gaussian_model.py:575-605). Child j's offsets are standard normal draws
    [cap, 3] from `generator` (on the state's device), or `draws[j]` where
    given, times the scales."""
    grads = _grads(state)[:, 0]
    scaling = torch.exp(state.params["scaling"])
    max_scale = scaling.max(dim=1).values
    sel = ((grads >= grad_threshold)
           & (max_scale > percent_dense * scene_extent) & _active(state))
    num_sel = int(sel.sum())
    rot = quat_to_rotmat(state.params["rotation"])
    xyz0 = state.params["xyz"]
    rows = {k: state.params[k] for k in GAUSSIAN_KEYS}
    new_scaling = torch.log(scaling / (0.8 * n_split))
    n_active = state.num_active
    for j in range(n_split):
        if draws is not None:
            z = torch.as_tensor(np.array(draws[j], np.float32),
                                device=state.device)
        else:
            z = torch.randn(scaling.shape, generator=generator,
                            device=state.device)
        samples = z * scaling
        new_xyz = torch.einsum("nij,nj->ni", rot, samples) + xyz0
        state = _append_rows(state, dict(rows, xyz=new_xyz,
                                         scaling=new_scaling),
                             sel, j * num_sel)
    state.num_active = min(n_active + n_split * num_sel, state.capacity)
    state = reset_densification_stats(state)
    return prune_points(state, sel)


@torch.no_grad()
def prune(state: TrainState, min_opacity: float, scene_extent: float,
          max_screen_size: float) -> TrainState:
    """Prune by opacity and, with max_screen_size > 0, by screen and world
    size (gaussian_model.py:714-725)."""
    mask = torch.sigmoid(state.params["opacity"])[:, 0] < min_opacity
    if max_screen_size > 0:
        big_vs = state.max_radii2d > max_screen_size
        big_ws = (torch.exp(state.params["scaling"]).max(dim=1).values
                  > 0.1 * scene_extent)
        mask = mask | big_vs | big_ws
    return prune_points(state, mask)


@torch.no_grad()
def reset_opacity(state: TrainState) -> TrainState:
    """Clamp the live opacities to at most 0.01 and zero the opacity
    moments (gaussian_model.py:391-394, 446-459)."""
    op = state.params["opacity"]
    new_op = inverse_sigmoid(torch.clamp(torch.sigmoid(op), max=0.01))
    state.params["opacity"] = torch.where(_active(state)[:, None], new_op, op)
    state.opt.m["opacity"] = torch.zeros_like(state.opt.m["opacity"])
    state.opt.v["opacity"] = torch.zeros_like(state.opt.v["opacity"])
    return state


def densify(state: TrainState, max_grad: float, extent: float,
            percent_dense: float,
            generator: Optional[torch.Generator] = None) -> TrainState:
    """Clone, then split (gaussian_model.py:726-731); the loop prunes in a
    call of its own, as the reference does (train.py:399-406). As in the
    JAX package, the clone resets the gradient statistics before the split
    reads them."""
    state = densify_and_clone(state, max_grad, extent, percent_dense)
    return densify_and_split(state, max_grad, extent, percent_dense,
                             generator)


@torch.no_grad()
def grow(state: TrainState, density_threshold: float = 5.0,
         displacement_scale: float = 5.0, seed: int = 0,
         voxel_size: float = 8.0):
    """Point growing (reference GaussianModel.grow, add_point_by_mask and
    get_displayment, gaussian_model.py:632-713): voxel-downsample the live
    cloud, find its low-density points, and append copies of their rows at
    positions displaced by normal draws (numpy, `seed`) inside the AABB, as
    far as the capacity allows. Returns (state, points added)."""
    from langsplat4d_torch.ops.point_utils import grow_points

    n = state.num_active
    if n == 0:
        return state, 0
    pts = state.params["xyz"][:n].cpu().numpy().astype(np.float32)
    sel_local, _ = grow_points(pts, density_threshold, displacement_scale,
                               voxel_size=voxel_size, device=state.device)
    sel_idx = np.nonzero(sel_local)[0]
    if sel_idx.size == 0:
        return state, 0
    rng = np.random.default_rng(seed)
    disp = rng.normal(size=(sel_idx.size, 3)).astype(np.float32) \
        * displacement_scale
    new_xyz = pts[sel_idx] + disp
    aabb = state.aabb.cpu().numpy()     # [0] = max, [1] = min
    inside = ((new_xyz < aabb[0]) & (new_xyz > aabb[1])).all(axis=1)
    sel_idx, new_xyz = sel_idx[inside], new_xyz[inside]
    headroom = state.capacity - n
    sel_idx, new_xyz = sel_idx[:headroom], new_xyz[:headroom]
    if sel_idx.size == 0:
        return state, 0
    mask = torch.zeros(state.capacity, dtype=torch.bool, device=state.device)
    idx = torch.as_tensor(sel_idx, device=state.device)
    mask[idx] = True
    xyz_full = state.params["xyz"].clone()
    xyz_full[idx] = torch.as_tensor(new_xyz, device=state.device)
    rows = dict({k: state.params[k] for k in GAUSSIAN_KEYS}, xyz=xyz_full)
    state = _append_rows(state, rows, mask, 0)
    state.num_active = min(n + int(sel_idx.size), state.capacity)
    return state, int(sel_idx.size)
