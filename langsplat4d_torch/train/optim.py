"""Per-group Adam with schedule-driven learning rates (port of
langsplat4d/train/optim.py; reference scene/gaussian_model.py:220-329).

Parameters are a flat dict of named leaves: the Gaussian tensors by name
("xyz", "f_dc", ...) and the deformation network's parameters as
"deform.<state-dict key>". Groups: xyz, f_dc, f_rest, opacity, scaling,
rotation, language_feature, deformation (the MLPs and timenet) and grid (the
HexPlanes).

The update is written on tensors, not with `torch.optim.Adam`: the JAX
package keeps one global step count for the bias correction, so a leaf that
was frozen for its first steps is corrected with the global count when it
starts to train, where `torch.optim.Adam` would count per parameter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from langsplat4d_torch.core.transforms import expon_lr

BETA1, BETA2 = 0.9, 0.999
EPS = 1e-15  # the reference uses eps=1e-15


def group_of_leaf(name: str) -> str:
    """The param-group label of a named leaf."""
    if name.startswith("deform."):
        return "grid" if ".grid.grids." in name else "deformation"
    return name


@dataclass
class AdamState:
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: int = 0


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(m={k: torch.zeros_like(p) for k, p in params.items()},
                     v={k: torch.zeros_like(p) for k, p in params.items()})


@torch.no_grad()
def adam_update(params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], opt: AdamState,
                lrs: Dict[str, float], trainable: Dict[str, bool],
                eps: float = EPS) -> None:
    """One Adam step, in place on `params` and the moments. `lrs` maps each
    leaf to its learning rate; leaves with `trainable[name]` False keep
    parameter and moments untouched, but the one global step count advances,
    so their later bias correction uses it. A trainable leaf without a
    gradient (None or missing) takes a zero gradient."""
    opt.step += 1
    bc1 = 1.0 - BETA1 ** opt.step
    bc2 = 1.0 - BETA2 ** opt.step
    by_lr: Dict[float, list] = {}
    for name, p in params.items():
        if trainable[name]:
            by_lr.setdefault(float(lrs[name]), []).append(name)
    for lr, names in by_lr.items():
        ps = [params[n] for n in names]
        gs = [grads[n] if grads.get(n) is not None
              else torch.zeros_like(params[n]) for n in names]
        ms = [opt.m[n] for n in names]
        vs = [opt.v[n] for n in names]
        torch._foreach_mul_(ms, BETA1)
        torch._foreach_add_(ms, gs, alpha=1 - BETA1)
        torch._foreach_mul_(vs, BETA2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - BETA2)
        denom = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(ms, bc1)
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(ps, upd)


@dataclass(frozen=True)
class LRConfig:
    """Learning-rate configuration: the optimization parameters and the
    spatial_lr_scale multiplier (training_setup, gaussian_model.py:302-313).
    """
    position_lr_init: float
    position_lr_final: float
    position_lr_delay_mult: float
    position_lr_max_steps: int
    deformation_lr_init: float
    deformation_lr_final: float
    deformation_lr_delay_mult: float
    grid_lr_init: float
    grid_lr_final: float
    feature_lr: float
    opacity_lr: float
    scaling_lr: float
    rotation_lr: float
    language_feature_lr: float
    spatial_lr_scale: float = 1.0

    @classmethod
    def from_optim(cls, o, spatial_lr_scale: float) -> "LRConfig":
        """From any object with the optimization parameters as attributes."""
        names = [f for f in cls.__dataclass_fields__
                 if f != "spatial_lr_scale"]
        return cls(**{f: getattr(o, f) for f in names},
                   spatial_lr_scale=spatial_lr_scale)


def group_lrs(cfg: LRConfig, iteration) -> Dict[str, float]:
    """Per-group learning rate at `iteration`. xyz, deformation and grid
    follow update_learning_rate (gaussian_model.py:315-329); the others are
    constant."""
    s = cfg.spatial_lr_scale
    return {
        "xyz": expon_lr(iteration, cfg.position_lr_init * s,
                        cfg.position_lr_final * s,
                        lr_delay_mult=cfg.position_lr_delay_mult,
                        max_steps=cfg.position_lr_max_steps),
        "deformation": expon_lr(iteration, cfg.deformation_lr_init * s,
                                cfg.deformation_lr_final * s,
                                lr_delay_mult=cfg.deformation_lr_delay_mult,
                                max_steps=cfg.position_lr_max_steps),
        "grid": expon_lr(iteration, cfg.grid_lr_init * s,
                         cfg.grid_lr_final * s,
                         lr_delay_mult=cfg.deformation_lr_delay_mult,
                         max_steps=cfg.position_lr_max_steps),
        "f_dc": cfg.feature_lr,
        "f_rest": cfg.feature_lr / 20.0,
        "opacity": cfg.opacity_lr,
        "scaling": cfg.scaling_lr,
        "rotation": cfg.rotation_lr,
        "language_feature": cfg.language_feature_lr,
    }


def trainable_tree(params, stage: str, *, include_feature: bool,
                   joint_train: bool, no_dlang: bool) -> Dict[str, bool]:
    """Which leaves train in `stage`: the reference's param-group selection
    and requires_grad_ toggles (training_setup, gaussian_model.py:226-299).
    `params` is any iterable of leaf names."""
    lang_stage = include_feature and ("lang" in stage)

    def decide(name: str) -> bool:
        if not lang_stage:
            # base stages: everything trains except the language features
            return name != "language_feature"
        if name == "language_feature":
            return True
        if name.startswith("deform."):
            if "fine" not in stage:
                return False          # no deform groups in coarse-lang
            if ".lang_deform." in name:
                return not no_dlang
            if ".discrete_coff_generator." in name:
                return "discrete" in stage
        return joint_train

    return {name: decide(name) for name in params}
