"""Stage-aware render (port of langsplat4d/render/pipeline.py; reference
gaussian_renderer/__init__.py:19-248).

Stages: 'coarse-*' passes attributes through undeformed; 'fine-*' runs the
deformation, with the language MLP forced off in 'fine-base'; '*-base'
renders no language image (a zero language tensor of width lang_dim is still
threaded through, as in the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from langsplat4d_torch.core.state import GaussianState
from langsplat4d_torch.core.transforms import safe_normalize
from langsplat4d_torch.field.deformation import (DeformConfig, DeformNetwork,
                                                 deform_forward)
from langsplat4d_torch.render.raster import (CameraParams, RasterSettings,
                                             binning_saturation, preprocess,
                                             rasterize)

STAGES = ("coarse-base", "coarse-lang", "fine-base", "fine-lang",
          "fine-lang-discrete")


def prepare_attributes(dcfg: DeformConfig, stage: str, time: float,
                       gs: GaussianState, net: DeformNetwork,
                       aabb: torch.Tensor, *, nonormalized: bool = False,
                       grid_spatial=None, scaling_modifier: float = 1.0):
    """Deformation (fine stages) and activations. Returns (means3d,
    scales_act, rotations_act, opacity_act, shs, lang, coff)."""
    n = gs.capacity
    means3d, opacity = gs.xyz, gs.opacity
    scales, rotations = gs.scaling, gs.rotation
    shs = gs.get_features()
    if "base" in stage:
        lang = torch.zeros((n, dcfg.lang_dim), device=gs.device)
    else:
        lang = gs.language_feature
        if not nonormalized:
            lang = safe_normalize(lang)

    coff = None
    if stage.startswith("fine"):
        if "base" in stage:
            stage_dcfg = dataclasses.replace(dcfg, no_dlang=True,
                                             use_discrete_lang_f=False)
        else:
            stage_dcfg = dataclasses.replace(
                dcfg, use_discrete_lang_f="discrete" in stage)
        if torch.is_tensor(time):       # stays on its device: no host sync
            times = time.to(gs.device, torch.float32).reshape(1, 1).expand(
                n, 1)
        else:
            times = torch.full((n, 1), float(time), device=gs.device)
        (means3d, scales, rotations, opacity, shs, lang,
         coff) = deform_forward(net, stage_dcfg, aabb, means3d, scales,
                                rotations, opacity, shs, lang, times,
                                grid_spatial=grid_spatial)

    scales_act = torch.exp(scales)
    if scaling_modifier != 1.0:
        scales_act = scales_act * scaling_modifier
    return (means3d, scales_act, safe_normalize(rotations),
            torch.sigmoid(opacity), shs, lang, coff)


def render(settings: RasterSettings, dcfg: DeformConfig, stage: str,
           cam: CameraParams, time: float, gs: GaussianState,
           net: DeformNetwork, aabb: torch.Tensor, bg: torch.Tensor, *,
           scaling_modifier: float = 1.0,
           override_color: Optional[torch.Tensor] = None,
           nonormalized: bool = False,
           grid_spatial=None,
           means2d_dummy: Optional[torch.Tensor] = None,
           gather=None) -> Dict[str, Optional[torch.Tensor]]:
    """One render. Returns render, language_feature_image (None in base
    stages), viewspace_points (the `means2d_dummy` gradient tap; zeros
    [cap, 2] without one, as in the reference), visibility_filter, radii,
    depth and coff. `gather`: see `raster.rasterize` (`gs` is then a rank's
    block of the rows, and the per-row outputs are the block's)."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; expected one of {STAGES}")
    (means3d, scales_act, rotations_act, opacity_act, shs, lang,
     coff) = prepare_attributes(
        dcfg, stage, time, gs, net, aabb, nonormalized=nonormalized,
        grid_spatial=grid_spatial, scaling_modifier=scaling_modifier)
    rendered, lang_img, radii, depth = rasterize(
        settings, cam, means3d, opacity_act, scales_act, rotations_act,
        shs if override_color is None else None, override_color, lang, bg,
        active=gs.active_mask(), means2d_dummy=means2d_dummy,
        gather=gather)
    return {
        "render": rendered,
        "language_feature_image": None if "base" in stage else lang_img,
        "viewspace_points": (means2d_dummy if means2d_dummy is not None
                             else gs.xyz.new_zeros((gs.capacity, 2))),
        "visibility_filter": radii > 0,
        "radii": radii,
        "depth": depth,
        "coff": coff,
    }


@torch.no_grad()
def binning_report(settings: RasterSettings, cam: CameraParams,
                   gs: GaussianState) -> Dict[str, float]:
    """The tile lists' saturation on the undeformed Gaussians (deformation
    moves them little against a tile). See `raster.binning_saturation` for
    the fields."""
    prep = preprocess(
        settings, cam, gs.xyz, torch.sigmoid(gs.opacity),
        torch.exp(gs.scaling), safe_normalize(gs.rotation), None,
        gs.xyz.new_zeros((gs.capacity, 3)), active=gs.active_mask())
    return {k: float(v) for k, v in binning_saturation(settings,
                                                       prep).items()}
