"""The training step: batched render -> loss -> gradients -> Adam (port of
langsplat4d/train/step.py; the body of the reference's hot loop,
train.py:164-426).

Renders each camera of the batch under autograd through the tile-list or the
stream-layout compositor with its hand-derived backward, computes the stage
loss (train.py:283-337), takes gradients with respect to the trainable leaves and
the NDC viewspace dummies (the densification statistics, train.py:352-354)
and applies the per-group Adam update. PyTorch runs eagerly, so there is no
compiled step: `train_step` updates the state in place and returns it. The
host synchronises once per camera on the emitted pair count of the tile
binning (and once more on the stream's length with `stream_train`); the loss
stays on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from langsplat4d_torch.field.deformation import DeformConfig
from langsplat4d_torch.field.hexplane import compute_regulation
from langsplat4d_torch.render.pipeline import render
from langsplat4d_torch.render.raster import CameraParams, RasterSettings
from langsplat4d_torch.train import losses
from langsplat4d_torch.train.optim import (LRConfig, adam_update,
                                           group_lrs, group_of_leaf,
                                           trainable_tree)
from langsplat4d_torch.train.trainstate import GAUSSIAN_KEYS, TrainState


class StepConfig(NamedTuple):
    """Per-stage configuration of the train step. `settings` must have
    `analytic_vjp` or `stream_train` on: the render paths have no
    backward."""
    settings: RasterSettings
    dcfg: DeformConfig
    lr_cfg: LRConfig
    stage: str
    joint_train: bool = False
    no_dlang: bool = True
    lam: float = 0.2            # lang-L1 weight (train.py:287, args.lam)
    beta: float = 0.01          # cos-loss weight (train.py:291, args.beta)
    addcosloss: bool = False
    lambda_dssim: float = 0.0
    nonormalized: bool = False
    time_smoothness_weight: float = 0.0
    l1_time_planes: float = 0.0
    plane_tv_weight: float = 0.0
    batch_size: int = 1


class Batch(NamedTuple):
    """A batch of B cameras, stacked on the leading axis. Two formats: full
    (`gt_images` f32, `gt_lang` and `lang_mask` maps) and compact
    (`gt_images` uint8, the language ground truth as per-pixel segment ids
    `gt_seg` and per-segment features `gt_tables`), which
    `materialize_batch` decodes on the device."""
    cams: CameraParams                       # tensors [B, ...]
    times: torch.Tensor                      # [B]
    gt_images: torch.Tensor                  # [B, 3, H, W] f32 or uint8
    gt_lang: Optional[torch.Tensor]          # [B, L, H, W] or None
    lang_mask: Optional[torch.Tensor]        # [B, 1, H, W] or None
    gt_seg: Optional[torch.Tensor] = None    # [B, H, W] int; -1 = invalid
    gt_tables: Optional[torch.Tensor] = None  # [B, S, L]


def materialize_batch(batch: Batch) -> Batch:
    """Decode the compact format: uint8 images -> f32 / 255 by true division
    (bit-identical to a host reader's k / 255), (gt_seg, gt_tables) -> the
    per-pixel feature map and its validity mask."""
    gt = batch.gt_images
    if gt.dtype == torch.uint8:
        gt = gt.to(torch.float32) / 255.0
    gt_lang, mask = batch.gt_lang, batch.lang_mask
    if batch.gt_seg is not None:
        seg = batch.gt_seg.long()                               # [B, H, W]
        mask = (seg >= 0)[:, None].to(torch.float32)            # [B, 1, H, W]
        b = seg.shape[0]
        gathered = batch.gt_tables[
            torch.arange(b, device=seg.device)[:, None, None],
            torch.clamp(seg, min=0)]                            # [B, H, W, L]
        gt_lang = gathered.permute(0, 3, 1, 2) * mask
    return batch._replace(gt_images=gt, gt_lang=gt_lang, lang_mask=mask,
                          gt_seg=None, gt_tables=None)


def _stage_loss(cfg: StepConfig, state: TrainState, batch: Batch, images,
                lang_imgs) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    metrics: Dict[str, torch.Tensor] = {}
    if "base" in cfg.stage:
        loss = losses.l1_loss(images, batch.gt_images[:, :3])
        metrics["rgb_l1"] = loss
    else:
        m = batch.lang_mask
        loss = cfg.lam * losses.l1_loss(lang_imgs * m, batch.gt_lang * m)
        metrics["lang_l1"] = loss
        if cfg.addcosloss:
            cl = losses.cos_loss((lang_imgs * m).movedim(1, -1),
                                 (batch.gt_lang * m).movedim(1, -1))
            loss = loss + cfg.beta * cl
            metrics["cos"] = cl
        if cfg.joint_train:
            rgb_l1 = losses.l1_loss(images, batch.gt_images[:, :3])
            loss = loss + rgb_l1
            metrics["rgb_l1"] = rgb_l1
    if cfg.time_smoothness_weight != 0.0:
        loss = loss + compute_regulation(
            state.deform.deformation_net.grid, cfg.time_smoothness_weight,
            cfg.l1_time_planes, cfg.plane_tv_weight)
    if cfg.lambda_dssim != 0.0:
        s = losses.ssim(images, batch.gt_images[:, :3])
        loss = loss + cfg.lambda_dssim * (1.0 - s)
        metrics["ssim"] = s
    metrics["loss"] = loss
    return loss, metrics


def loss_and_grads(cfg: StepConfig, state: TrainState, batch: Batch,
                   bg: torch.Tensor, active_sh_degree: int = 0,
                   wrt: Optional[Sequence[str]] = None):
    """Render the batch, compute the stage loss and differentiate it.

    `wrt` names the leaves (of `state.leaves()`) to differentiate; None means
    the leaves that train in this stage. Returns (metrics, grads by leaf name
    (None where the loss does not reach a leaf), dummy_grads [B, cap, 2],
    radii [B, cap])."""
    batch = materialize_batch(batch)
    leaves = state.leaves()
    if wrt is None:
        train = trainable_tree(leaves, cfg.stage, include_feature=True,
                               joint_train=cfg.joint_train,
                               no_dlang=cfg.no_dlang)
        wrt = [n for n in leaves if train[n]]
    wanted = set(wrt)
    for name, p in state.deform.named_parameters():
        p.requires_grad_("deform." + name in wanted)
    gparams = {k: (state.params[k].detach().requires_grad_(True)
                   if k in wanted else state.params[k])
               for k in GAUSSIAN_KEYS}
    gs = dataclasses.replace(
        state.gaussians(), xyz=gparams["xyz"], features_dc=gparams["f_dc"],
        features_rest=gparams["f_rest"], scaling=gparams["scaling"],
        rotation=gparams["rotation"], opacity=gparams["opacity"],
        language_feature=gparams["language_feature"])

    settings = dataclasses.replace(cfg.settings, sh_degree=active_sh_degree)
    # cfg.no_dlang governs both the graph and trainability (reference
    # render(), gaussian_renderer/__init__.py:121-124)
    dcfg = dataclasses.replace(cfg.dcfg, no_dlang=cfg.no_dlang)
    b = batch.gt_images.shape[0]
    dummies = torch.zeros((b, state.capacity, 2), device=state.device,
                          requires_grad=True)
    images, lang_imgs, radii = [], [], []
    for i in range(b):
        cam = CameraParams(*[t[i] for t in batch.cams])
        out = render(settings, dcfg, cfg.stage, cam, batch.times[i], gs,
                     state.deform, state.aabb, bg, means2d_dummy=dummies[i],
                     nonormalized=cfg.nonormalized)
        images.append(out["render"])
        lang = out["language_feature_image"]
        lang_imgs.append(lang if lang is not None
                         else out["render"].new_zeros(
                             (0,) + out["render"].shape[1:]))
        radii.append(out["radii"])
    loss, metrics = _stage_loss(cfg, state, batch, torch.stack(images),
                                torch.stack(lang_imgs))

    inputs = [dummies] + [gparams[n] if n in gparams else leaves[n]
                          for n in wrt]
    got = torch.autograd.grad(loss, inputs, allow_unused=True)
    dummy_grads = got[0] if got[0] is not None else torch.zeros_like(dummies)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (metrics, dict(zip(wrt, got[1:])), dummy_grads,
            torch.stack(radii).detach())


#: packed per-camera row layout for train_step_packed: 16 viewmatrix +
#: 16 projmatrix + 3 campos + tanfovx + tanfovy + time + iteration = 39
#: f32 (the iteration is f32-exact below 2^24).
PACKED_CAM_WIDTH = 39


def pack_cam_rows(cam_params, times, iteration) -> np.ndarray:
    """Host-side [B, PACKED_CAM_WIDTH] f32 rows for train_step_packed: one
    small upload per step instead of one per camera field."""
    rows = []
    for cp, t in zip(cam_params, times):
        rows.append(np.concatenate([
            np.asarray(cp.viewmatrix, np.float32).reshape(16),
            np.asarray(cp.projmatrix, np.float32).reshape(16),
            np.asarray(cp.campos, np.float32).reshape(3),
            np.float32([cp.tanfovx, cp.tanfovy, t, iteration])]))
    return np.stack(rows)


def train_step_packed(cfg: StepConfig, state: TrainState, packed,
                      imgs: Sequence[torch.Tensor],
                      segs: Optional[Sequence[torch.Tensor]],
                      tables: Optional[Sequence[torch.Tensor]],
                      bg: torch.Tensor, active_sh_degree: int = 0):
    """`train_step` from one packed host row per camera (`pack_cam_rows`:
    a numpy array or CPU tensor, uploaded once) and per-camera ground-truth
    tensors already on the device: images [3, H, W] u8 or f32, and for the
    compact format segment maps [H, W] and feature tables [S, L] (padded
    here to the batch's largest S)."""
    host = torch.as_tensor(np.asarray(packed, np.float32))
    iteration = int(host[0, 38])
    rows = host.to(state.device)
    b = rows.shape[0]
    cams = CameraParams(
        viewmatrix=rows[:, :16].reshape(b, 4, 4),
        projmatrix=rows[:, 16:32].reshape(b, 4, 4), campos=rows[:, 32:35],
        tanfovx=rows[:, 35], tanfovy=rows[:, 36])
    if tables:
        s_max = max(t.shape[0] for t in tables)
        tables = [torch.nn.functional.pad(t, (0, 0, 0, s_max - t.shape[0]))
                  for t in tables]
    batch = Batch(
        cams=cams, times=rows[:, 37], gt_images=torch.stack(list(imgs)),
        gt_lang=None, lang_mask=None,
        gt_seg=torch.stack(list(segs)) if segs else None,
        gt_tables=torch.stack(tables) if tables else None)
    return train_step(cfg, state, batch, bg, iteration, active_sh_degree)


def train_step(cfg: StepConfig, state: TrainState, batch: Batch,
               bg: torch.Tensor, iteration: int, active_sh_degree: int = 0):
    """One step, in place on `state`. Returns (state, metrics,
    viewspace_grad_sum [cap, 2], visibility_any [cap], radii_max [cap])."""
    metrics, grads, dummy_grads, radii = loss_and_grads(
        cfg, state, batch, bg, active_sh_degree)
    vs_grad = dummy_grads.sum(dim=0)
    radii_max = radii.max(dim=0).values
    visibility = radii_max > 0

    leaves = state.leaves()
    group_lr = group_lrs(cfg.lr_cfg, iteration)
    lrs = {name: group_lr[group_of_leaf(name)] for name in leaves}
    train = trainable_tree(leaves, cfg.stage, include_feature=True,
                           joint_train=cfg.joint_train, no_dlang=cfg.no_dlang)
    adam_update(leaves, grads, state.opt, lrs, train)
    return state, metrics, vs_grad, visibility, radii_max


@torch.no_grad()
def eval_step(cfg: StepConfig, state: TrainState, cam: CameraParams, time,
              bg, active_sh_degree: int = 0):
    """Single-camera forward for validation and reports (no gradients)."""
    settings = dataclasses.replace(cfg.settings, sh_degree=active_sh_degree)
    return render(settings, cfg.dcfg, cfg.stage, cam, time, state.gaussians(),
                  state.deform, state.aabb, bg, nonormalized=cfg.nonormalized)
