"""Trained-model loading: PLY + deformation.pth (port of
langsplat4d/checkpoint.py; reference Scene(load_iteration, load_stage) and
GaussianModel.load_ply / load_model).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from langsplat4d_torch.core import plyio
from langsplat4d_torch.core import state as statelib
from langsplat4d_torch.core.device import resolve_device
from langsplat4d_torch.core.state import GaussianState
from langsplat4d_torch.field.deformation import DeformConfig, DeformNetwork
from langsplat4d_torch.interop import load_deformation


@dataclass
class TrainedModel:
    """What a render needs from a checkpoint."""
    gaussians: GaussianState
    deform: DeformNetwork
    aabb: torch.Tensor          # [2, 3]: max corner, min corner
    active_sh_degree: int


def search_for_max_iteration(folder: str, stage: str) -> Optional[int]:
    if not os.path.isdir(folder):
        return None
    pat = re.compile(re.escape(stage) + r"_iteration_(\d+)$")
    its = [int(m.group(1)) for name in os.listdir(folder)
           if (m := pat.match(name))]
    return max(its) if its else None


def load_trained_model(model_path: str, load_stage: str, iteration: int,
                       dcfg: DeformConfig, *, max_sh_degree: int = 3,
                       aabb=None, capacity: Optional[int] = None,
                       seed: int = 0, device=None):
    """Returns (TrainedModel, loaded_iteration); iteration -1 picks the
    latest `<load_stage>_iteration_*` directory. Without a deformation.pth
    the network keeps its initialization from `seed`. `device=None` is the
    current CUDA device (an error where there is none)."""
    device = resolve_device(device)
    pc_dir = os.path.join(model_path, "point_cloud")
    if iteration == -1:
        iteration = search_for_max_iteration(pc_dir, load_stage)
        if iteration is None:
            raise FileNotFoundError(
                f"no '{load_stage}_iteration_*' checkpoints in {pc_dir}")
    ckpt_dir = os.path.join(pc_dir, f"{load_stage}_iteration_{iteration}")

    arrays = plyio.ply_arrays_to_gaussians(
        plyio.read_ply(os.path.join(ckpt_dir, "point_cloud.ply")),
        max_sh_degree=max_sh_degree)
    lang = arrays["language_feature"]
    gs = statelib.from_arrays(
        arrays["xyz"], arrays["features_dc"], arrays["features_rest"],
        arrays["scaling"], arrays["rotation"], arrays["opacity"],
        language_feature=lang if lang.shape[1] else None,
        capacity=capacity, lang_dim=dcfg.lang_dim, device=device)

    generator = torch.Generator().manual_seed(seed)
    if os.path.exists(os.path.join(ckpt_dir, "deformation.pth")):
        net = load_deformation(ckpt_dir, dcfg, generator, device=device)
    else:
        net = DeformNetwork(dcfg, generator).to(device)

    if aabb is None:
        xyz = arrays["xyz"]
        aabb = np.stack([xyz.max(0), xyz.min(0)])
    aabb = torch.as_tensor(np.asarray(aabb, np.float32), device=device)
    return TrainedModel(gs, net, aabb, max_sh_degree), iteration
