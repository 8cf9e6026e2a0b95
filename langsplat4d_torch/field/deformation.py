"""4D deformation field (port of langsplat4d/field/deformation.py; reference
scene/deformation.py Deformation / deform_network).

`DeformNetwork` is laid out so the reference's `deformation.pth` keys load
with `load_state_dict(strict=True)`: `timenet.{2i}`,
`deformation_net.feature_out.{2i}`, `deformation_net.<head>.{2i+1}` and
`deformation_net.grid.grids.{s}.{p}` ([1, C, H, W]). The ablation gates live
in `DeformConfig`; `deform_forward` takes the config explicitly because the
render stage overrides some gates per call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from langsplat4d_torch.core.transforms import quat_multiply, safe_normalize
from langsplat4d_torch.field import hexplane as hp
from langsplat4d_torch.field.nets import mlp, poc_fre, poc_freqs


@dataclass(frozen=True)
class DeformConfig:
    """Same fields and defaults as the JAX package's DeformConfig."""
    net_width: int = 64
    defor_depth: int = 1
    timebase_pe: int = 4
    posebase_pe: int = 10
    scale_rotation_pe: int = 2
    opacity_pe: int = 2
    timenet_width: int = 64
    timenet_output: int = 32
    grid_pe: int = 0
    bounds: float = 1.6
    kplanes_out_dim: int = 32
    kplanes_resolution: Tuple[int, ...] = (64, 64, 64, 25)
    multires: Tuple[int, ...] = (1, 2, 4, 8)
    no_grid: bool = False
    no_dx: bool = False
    no_ds: bool = False
    no_dr: bool = False
    no_do: bool = True
    no_dshs: bool = True
    no_dlang: bool = True
    apply_rotation: bool = False
    static_mlp: bool = False
    empty_voxel: bool = False
    lang_dim: int = 3
    centers_num: int = 3
    use_discrete_lang_f: bool = False
    use_tribute_dlang: bool = False
    no_resnet: bool = False
    max_sh_degree: int = 3

    @property
    def grid_feat_dim(self) -> int:
        d = self.kplanes_out_dim * len(self.multires)
        if self.grid_pe != 0:
            d = d * 3
        return d

    @classmethod
    def from_config(cls, hidden, runtime, max_sh_degree: int = 3,
                    **overrides) -> "DeformConfig":
        """Build from langsplat4d.config HiddenConfig + RuntimeConfig."""
        kc = hidden.kplanes_config
        kw = dict(
            net_width=hidden.net_width,
            defor_depth=hidden.defor_depth,
            timebase_pe=hidden.timebase_pe,
            posebase_pe=hidden.posebase_pe,
            scale_rotation_pe=hidden.scale_rotation_pe,
            opacity_pe=hidden.opacity_pe,
            timenet_width=hidden.timenet_width,
            timenet_output=hidden.timenet_output,
            grid_pe=hidden.grid_pe,
            bounds=hidden.bounds,
            kplanes_out_dim=kc["output_coordinate_dim"],
            kplanes_resolution=tuple(kc["resolution"]),
            multires=tuple(hidden.multires),
            no_grid=hidden.no_grid,
            no_dx=hidden.no_dx,
            no_ds=hidden.no_ds,
            no_dr=hidden.no_dr,
            no_do=hidden.no_do,
            no_dshs=hidden.no_dshs,
            no_dlang=bool(hidden.no_dlang),
            apply_rotation=hidden.apply_rotation,
            static_mlp=hidden.static_mlp,
            empty_voxel=hidden.empty_voxel,
            lang_dim=runtime.language_feature_hiddendim,
            centers_num=runtime.centers_num,
            use_discrete_lang_f=runtime.use_discrete_lang_f,
            use_tribute_dlang=runtime.use_tribute_dlang,
            no_resnet=runtime.no_resnet,
            max_sh_degree=max_sh_degree,
        )
        kw.update(overrides)
        return cls(**kw)


class Deformation(nn.Module):
    """The reference's `deformation_net`: HexPlane grid, feature trunk and
    the per-attribute heads (scene/deformation.py:45-69)."""

    def __init__(self, cfg: DeformConfig, generator: torch.Generator):
        super().__init__()
        W = cfg.net_width
        times_ch = 2 * cfg.timebase_pe + 1
        g = generator
        self.grid = hp.HexPlaneField(cfg.kplanes_out_dim,
                                     cfg.kplanes_resolution, cfg.multires, g)
        feat_in = 4 if cfg.no_grid else cfg.grid_feat_dim
        # the reference always builds the first Linear, so defor_depth=0
        # (the Neu3D preset) still has one layer
        self.feature_out = mlp([feat_in] + [W] * max(1, cfg.defor_depth),
                               pre_relu=False, generator=g)
        self.pos_deform = mlp([W, W, 3], pre_relu=True, generator=g)
        self.scales_deform = mlp([W, W, 3], pre_relu=True, generator=g)
        self.rotations_deform = mlp([W, W, 4], pre_relu=True, generator=g)
        self.opacity_deform = mlp([W, W, 1], pre_relu=True, generator=g)
        self.shs_deform = mlp([W, W, 16 * 3], pre_relu=True, generator=g)
        self.lang_deform = mlp([times_ch + cfg.lang_dim, W, W, cfg.lang_dim],
                               pre_relu=True, generator=g)
        self.discrete_coff_generator = mlp([W, W, cfg.centers_num],
                                           pre_relu=True, generator=g)
        if cfg.static_mlp:
            self.static_mlp = mlp([W, W, 1], pre_relu=True, generator=g)
        if cfg.empty_voxel:
            self.empty_voxel = hp.DenseGrid(1, (64, 64, 64))


class DeformNetwork(nn.Module):
    """The reference's `deform_network` (scene/deformation.py:195-217).
    `timenet` exists for checkpoint parity; the dynamic path never calls
    it, as in the reference."""

    def __init__(self, cfg: DeformConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.timenet = mlp([2 * cfg.timebase_pe + 1, cfg.timenet_width,
                            cfg.timenet_output], pre_relu=False,
                           generator=generator)
        self.deformation_net = Deformation(cfg, generator)
        # constant frequency buffers; not in the state dict, since checkpoints
        # written without a config do not carry them
        self.register_buffer("time_poc", poc_freqs(cfg.timebase_pe),
                             persistent=False)


def make_grid_spatial_cache(net: DeformNetwork, cfg: DeformConfig,
                            aabb: torch.Tensor,
                            xyz: torch.Tensor) -> Optional[List[torch.Tensor]]:
    """Time-independent spatial-plane products for a fixed point set, reused
    by every frame of a trajectory render."""
    if cfg.no_grid:
        return None
    return hp.hexplane_spatial(net.deformation_net.grid, aabb, xyz)


def deform_forward(net: DeformNetwork, cfg: DeformConfig, aabb, xyz, scales,
                   rotations, opacity, shs, lang, times,
                   init_centers: bool = False, grid_spatial=None):
    """Full dynamic deformation (reference forward_dynamic,
    scene/deformation.py:103-182,232-248). xyz [N, 3], scales [N, 3]
    log-scales, rotations [N, 4], opacity [N, 1] logits, shs [N, 16, 3],
    lang [N, L] (L = lang_dim, or centers_num * lang_dim in discrete
    mode), times [N, 1]. `init_centers` skips the discrete mix and runs the
    language MLP, which must then be on (`no_dlang` False): the samples the
    discrete stage clusters into centres.

    Returns (pts, scales, rotations, opacity, shs, lang_feature, coff); coff
    is None unless discrete mode is on.
    """
    d = net.deformation_net
    time_pos_emb = poc_fre(times, net.time_poc)
    if cfg.no_grid:
        h = torch.cat([xyz, times], dim=-1)
    else:
        h = hp.hexplane_query(d.grid, aabb, xyz, times, spatial=grid_spatial)
        if cfg.grid_pe > 1:
            h = poc_fre(h, poc_freqs(cfg.grid_pe, device=h.device))
    hidden = d.feature_out(h)

    if cfg.static_mlp:
        mask = d.static_mlp(hidden)
    elif cfg.empty_voxel:
        mask = hp.dense_grid_query(d.empty_voxel, aabb, xyz)
    else:
        mask = torch.ones_like(opacity[:, :1])

    pts = xyz if cfg.no_dx else xyz * mask + d.pos_deform(hidden)
    scales_out = (scales if cfg.no_ds
                  else scales * mask + d.scales_deform(hidden))
    if cfg.no_dr:
        rotations_out = rotations
    elif cfg.apply_rotation:
        rotations_out = quat_multiply(rotations, d.rotations_deform(hidden))
    else:
        rotations_out = rotations + d.rotations_deform(hidden)
    opacity_out = (opacity if cfg.no_do
                   else opacity * mask + d.opacity_deform(hidden))
    if cfg.no_dshs:
        shs_out = shs
    else:
        dshs = d.shs_deform(hidden).reshape(shs.shape[0], 16, 3)
        shs_out = shs * mask[..., None] + dshs

    coff = None
    if cfg.use_discrete_lang_f and not init_centers:
        centers = lang[:, : cfg.lang_dim * cfg.centers_num].reshape(
            lang.shape[0], cfg.centers_num, cfg.lang_dim)
        centers = safe_normalize(centers, eps=0.0)
        coff = d.discrete_coff_generator(hidden)
        lang_feature = safe_normalize(
            torch.einsum("nc,ncd->nd", coff, centers))
    elif init_centers and cfg.no_dlang:
        raise ValueError("init_centers needs the language MLP (no_dlang "
                         "False)")
    elif cfg.no_dlang:
        lang_feature = lang[:, : cfg.lang_dim]
    else:
        if cfg.use_tribute_dlang:
            dlang = d.lang_deform(hidden)
        else:
            dlang = d.lang_deform(torch.cat([lang, time_pos_emb], dim=-1))
        if cfg.no_resnet:
            lang_feature = dlang
        else:
            lang_feature = lang[:, : cfg.lang_dim] * mask + dlang
        lang_feature = safe_normalize(lang_feature)

    return pts, scales_out, rotations_out, opacity_out, shs_out, \
        lang_feature, coff
