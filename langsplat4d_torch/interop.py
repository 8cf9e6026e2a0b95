"""Bridges to the JAX package's parameters and to checkpoint files.

`params_from_jax` and `gaussians_from_numpy` turn the JAX package's
deformation pytree and GaussianState, given as numpy arrays, into the port's
state dict and GaussianState, and `train_state_from_jax` its whole TrainState
(parameters, Adam moments and step, densification buffers), so both packages
can compute from the same values. `load_deformation` reads a
reference-layout `deformation.pth`.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from langsplat4d_torch.core.device import resolve_device
from langsplat4d_torch.core.state import GaussianState
from langsplat4d_torch.field.deformation import DeformConfig, DeformNetwork

# heads whose Sequential starts with a ReLU (Linears at odd indices)
_HEADS = ("pos_deform", "scales_deform", "rotations_deform", "opacity_deform",
          "shs_deform", "discrete_coff_generator", "static_mlp",
          "lang_deform")
# constant frequency buffers some writers include; the module derives them
# from its config
_POC_KEYS = ("time_poc", "pos_poc", "rotation_scaling_poc", "opacity_poc")


def params_from_jax(deform_params: Dict[str, Any],
                    dcfg: DeformConfig) -> Dict[str, torch.Tensor]:
    """JAX deformation params (`init_deform_params` layout, numpy leaves:
    Linear layers as {"w": [in, out], "b": [out]}, planes [C, H, W]) -> the
    state dict of `DeformNetwork(dcfg)`."""
    sd: Dict[str, np.ndarray] = {}

    def linears(prefix, layers, first):
        for i, layer in enumerate(layers):
            sd[f"{prefix}.{2 * i + first}.weight"] = np.asarray(layer["w"]).T
            sd[f"{prefix}.{2 * i + first}.bias"] = np.asarray(layer["b"])

    linears("timenet", deform_params["timenet"], 0)
    linears("deformation_net.feature_out", deform_params["feature_out"], 0)
    for name in _HEADS:
        if name in deform_params:
            linears(f"deformation_net.{name}", deform_params[name], 1)
    for s, planes in enumerate(deform_params["grid"]["grids"]):
        for p, plane in enumerate(planes):
            sd[f"deformation_net.grid.grids.{s}.{p}"] = np.asarray(plane)[None]
    if dcfg.empty_voxel:
        sd["deformation_net.empty_voxel.grid"] = np.asarray(
            deform_params["empty_voxel"])[None]
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


def gaussians_from_numpy(arrays: Dict[str, Any], device=None
                         ) -> GaussianState:
    """A GaussianState from padded numpy arrays named as the fields of the
    JAX package's GaussianState (xyz, features_dc, features_rest, scaling,
    rotation, opacity, language_feature, num_active). `device=None` is the
    current CUDA device (an error where there is none)."""
    device = resolve_device(device)
    fields = {k: torch.from_numpy(np.array(arrays[k], np.float32)).to(device)
              for k in ("xyz", "features_dc", "features_rest", "scaling",
                        "rotation", "opacity", "language_feature")}
    return GaussianState(**fields, num_active=int(arrays["num_active"]))


def load_deformation(path: str, dcfg: DeformConfig,
                     generator: torch.Generator | None = None,
                     device=None) -> DeformNetwork:
    """`deformation.pth` in `path` -> DeformNetwork, loaded strictly, on
    `device` (None: the current CUDA device, an error where there is none)."""
    device = resolve_device(device)
    sd = torch.load(os.path.join(path, "deformation.pth"), map_location="cpu",
                    weights_only=True)
    for k in _POC_KEYS:
        sd.pop(k, None)
    net = DeformNetwork(dcfg, generator)
    net.load_state_dict(sd, strict=True)
    return net.to(device)


def train_state_from_jax(jstate, dcfg: DeformConfig, device=None):
    """The JAX package's TrainState -> the port's, leaf for leaf: `jstate` is
    any object with its fields (`params` with the "deform" subtree, `opt.m`,
    `opt.v`, `opt.step`, `num_active`, the densification buffers, `aabb`,
    `active_sh_degree`) whose leaves `np.asarray` can read. `device=None` is
    the current CUDA device (an error where there is none)."""
    from langsplat4d_torch.train.optim import AdamState
    from langsplat4d_torch.train.trainstate import (GAUSSIAN_KEYS,
                                                    make_train_state)
    device = resolve_device(device)

    def flat(tree) -> Dict[str, torch.Tensor]:
        """A params-shaped pytree -> the port's named leaves."""
        out = {k: torch.from_numpy(np.array(tree[k], np.float32))
               for k in GAUSSIAN_KEYS}
        out.update({"deform." + k: v
                    for k, v in params_from_jax(tree["deform"], dcfg).items()})
        return {k: v.to(device) for k, v in out.items()}

    p = flat(jstate.params)
    net = DeformNetwork(dcfg)
    net.load_state_dict({k[len("deform."):]: v for k, v in p.items()
                         if k.startswith("deform.")}, strict=True)
    gs = GaussianState(
        xyz=p["xyz"], features_dc=p["f_dc"], features_rest=p["f_rest"],
        scaling=p["scaling"], rotation=p["rotation"], opacity=p["opacity"],
        language_feature=p["language_feature"],
        num_active=int(jstate.num_active))
    state = make_train_state(gs, net.to(device),
                             np.array(jstate.aabb, np.float32),
                             int(jstate.active_sh_degree))
    names = list(state.leaves())
    m, v = flat(jstate.opt.m), flat(jstate.opt.v)
    state.opt = AdamState(m={k: m[k] for k in names},
                          v={k: v[k] for k in names},
                          step=int(jstate.opt.step))
    for name in ("max_radii2d", "xyz_gradient_accum", "denom",
                 "deformation_accum"):
        setattr(state, name, torch.from_numpy(
            np.array(getattr(jstate, name), np.float32)).to(device))
    state.deformation_table = torch.from_numpy(
        np.array(jstate.deformation_table, bool)).to(device)
    return state
