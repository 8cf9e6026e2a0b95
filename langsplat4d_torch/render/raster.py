"""Tile-based Gaussian rasterizer (port of langsplat4d/render/raster.py: the
stream path for rendering, the tile-list and the stream-layout analytic-VJP
paths for training, and the cell-list render option).

`preprocess` projects the Gaussians with the CUDA reference's semantics
(frustum cull at view z <= 0.2, EWA covariance with +0.3 dilation, SH clamp
at 0) and is differentiable under autograd. `rasterize` bins them with the
exact duplicate-and-sort stream (render/stream.py) and then, in the JAX
package's order of precedence:
- `settings.stream_train`: gathers differentiable rows by the stream's slots
  and composites them with the stream-layout training kernel and its
  hand-derived backward (render/stream_vjp.py); nothing is truncated;
- `settings.cell_composite`: bins by coarse cells only, and every tile walks
  its cell's candidates inside the cell kernel (rendering);
- `settings.analytic_vjp`: cuts per-tile lists of `tile_capacity` entries
  from the stream and composites them with the tile-list kernel and its
  hand-derived backward (render/composite_vjp.py), as the JAX package's
  default training step does;
- else composites each tile's segment with the stream kernel, which writes
  the [C, H, W] image directly (rendering).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch

from langsplat4d_torch.core.sh import eval_sh
from langsplat4d_torch.ops.composite import (MAX_RECT_COORD, composite_cells,
                                             composite_stream)
from langsplat4d_torch.render.composite_vjp import composite_cv
from langsplat4d_torch.render.stream import (bin_cells, bin_tiles,
                                             build_stream,
                                             build_stream_train,
                                             pack_cell_rows, sorted_pairs)
from langsplat4d_torch.render.stream_vjp import composite_stream_train


class CameraParams(NamedTuple):
    """Per-camera tensors (row-vector convention: p_hom @ M); view and full
    projection matrices transposed as the reference stores them."""
    viewmatrix: torch.Tensor   # [4, 4]
    projmatrix: torch.Tensor   # [4, 4]
    campos: torch.Tensor       # [3]
    tanfovx: torch.Tensor      # []
    tanfovy: torch.Tensor      # []


@dataclass(frozen=True)
class RasterSettings:
    image_height: int
    image_width: int
    sh_degree: int = 3
    include_feature: bool = True
    tile_size: int = 16
    # CUDA cutoffs: alpha >= 1/255 and the T >= 1e-4 stop
    hard_cutoffs: bool = True
    # The training path: per-tile lists of at most `tile_capacity` entries
    # (the nearest ones; farther ones are dropped) composited by the
    # tile-list kernel with its hand-derived backward. Off: the stream path.
    analytic_vjp: bool = False
    tile_capacity: Optional[int] = None
    # The training path on the stream layout: one slot per (Gaussian, tile)
    # pair, no capacity, nothing dropped (render/stream_vjp.py). Takes
    # precedence over `analytic_vjp`; `stream_ellipse_cull` drops the pairs
    # whose tile lies wholly outside the alpha >= 1/255 ellipse, which the
    # compositor would give zero weight anyway.
    stream_train: bool = False
    stream_ellipse_cull: bool = True
    # A render option: bin by cells of `bin_cell_tiles`^2 tiles only; every
    # tile walks its cell's depth-ordered candidates in the cell kernel.
    cell_composite: bool = False
    bin_cell_tiles: int = 8

    def __post_init__(self):
        if (self.analytic_vjp and not self.stream_train
                and self.tile_capacity is None):
            raise ValueError("analytic_vjp needs a tile_capacity")
        if self.cell_composite and max(self.tiles_x,
                                       self.tiles_y) > MAX_RECT_COORD:
            raise ValueError(
                f"cell_composite packs tile rects 8 bits a coordinate: "
                f"{self.tiles_x} x {self.tiles_y} tiles is too many")

    @property
    def tiles_x(self) -> int:
        return -(-self.image_width // self.tile_size)

    @property
    def tiles_y(self) -> int:
        return -(-self.image_height // self.tile_size)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def cells_x(self) -> int:
        return -(-self.tiles_x // self.bin_cell_tiles)

    @property
    def cells_y(self) -> int:
        return -(-self.tiles_y // self.bin_cell_tiles)


def preprocess(settings: RasterSettings, cam: CameraParams,
               means3d: torch.Tensor,      # [N, 3]
               opacities: torch.Tensor,    # [N, 1] after sigmoid
               scales: torch.Tensor,       # [N, 3] after exp
               rotations: torch.Tensor,    # [N, 4]
               shs: Optional[torch.Tensor],             # [N, K, 3]
               colors_precomp: Optional[torch.Tensor],  # [N, 3]
               cov3d_precomp: Optional[torch.Tensor] = None,  # [N, 6]
               active: Optional[torch.Tensor] = None,  # [N] bool
               means2d_dummy: Optional[torch.Tensor] = None,  # [N, 2]
               ) -> Dict[str, torch.Tensor]:
    """Screen-space attributes per Gaussian: point_image, conic, depth,
    opacity, radii, visible, rect_min, rect_max (tile units) and colors.
    `means2d_dummy` (zeros) is added to the projected centre in NDC, so that
    its gradient is the screen-space gradient the densification reads."""
    h, w = settings.image_height, settings.image_width
    focal_x = w / (2.0 * cam.tanfovx)
    focal_y = h / (2.0 * cam.tanfovy)

    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    V = cam.viewmatrix
    P = cam.projmatrix

    def xform_row(M, col):
        return mx * M[0, col] + my * M[1, col] + mz * M[2, col] + M[3, col]

    pv_x = xform_row(V, 0)
    pv_y = xform_row(V, 1)
    depth = xform_row(V, 2)
    pp_x = xform_row(P, 0)
    pp_y = xform_row(P, 1)
    pp_w = xform_row(P, 3)
    inv_w = 1.0 / (pp_w + 1e-7)
    ndc_x = pp_x * inv_w
    ndc_y = pp_y * inv_w
    if means2d_dummy is not None:
        ndc_x = ndc_x + means2d_dummy[:, 0]
        ndc_y = ndc_y + means2d_dummy[:, 1]
    pi_x = ((ndc_x + 1.0) * w - 1.0) * 0.5
    pi_y = ((ndc_y + 1.0) * h - 1.0) * 0.5

    if cov3d_precomp is not None:
        s_xx, s_xy, s_xz, s_yy, s_yz, s_zz = cov3d_precomp.unbind(1)
    else:
        q_inv = torch.rsqrt(torch.sum(rotations * rotations, dim=-1))
        qr, qx, qy, qz = (rotations * q_inv[:, None]).unbind(1)
        r00 = 1 - 2 * (qy * qy + qz * qz)
        r01 = 2 * (qx * qy - qr * qz)
        r02 = 2 * (qx * qz + qr * qy)
        r10 = 2 * (qx * qy + qr * qz)
        r11 = 1 - 2 * (qx * qx + qz * qz)
        r12 = 2 * (qy * qz - qr * qx)
        r20 = 2 * (qx * qz - qr * qy)
        r21 = 2 * (qy * qz + qr * qx)
        r22 = 1 - 2 * (qx * qx + qy * qy)
        s0, s1, s2 = scales.unbind(1)
        l00, l01, l02 = r00 * s0, r01 * s1, r02 * s2
        l10, l11, l12 = r10 * s0, r11 * s1, r12 * s2
        l20, l21, l22 = r20 * s0, r21 * s1, r22 * s2
        s_xx = l00 * l00 + l01 * l01 + l02 * l02
        s_xy = l00 * l10 + l01 * l11 + l02 * l12
        s_xz = l00 * l20 + l01 * l21 + l02 * l22
        s_yy = l10 * l10 + l11 * l11 + l12 * l12
        s_yz = l10 * l20 + l11 * l21 + l12 * l22
        s_zz = l20 * l20 + l21 * l21 + l22 * l22

    # EWA projection to 2D
    tz = depth
    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    inv_tz = 1.0 / tz
    tx = torch.clamp(pv_x * inv_tz, -limx, limx) * tz
    ty = torch.clamp(pv_y * inv_tz, -limy, limy) * tz
    j00 = focal_x * inv_tz
    j02 = -(focal_x * tx) * (inv_tz * inv_tz)
    j11 = focal_y * inv_tz
    j12 = -(focal_y * ty) * (inv_tz * inv_tz)
    # rows of W2V are the columns of the stored (transposed) view matrix
    t00 = j00 * V[0, 0] + j02 * V[0, 2]
    t01 = j00 * V[1, 0] + j02 * V[1, 2]
    t02 = j00 * V[2, 0] + j02 * V[2, 2]
    t10 = j11 * V[0, 1] + j12 * V[0, 2]
    t11 = j11 * V[1, 1] + j12 * V[1, 2]
    t12 = j11 * V[2, 1] + j12 * V[2, 2]
    u0 = t00 * s_xx + t01 * s_xy + t02 * s_xz
    u1 = t00 * s_xy + t01 * s_yy + t02 * s_yz
    u2 = t00 * s_xz + t01 * s_yz + t02 * s_zz
    v0 = t10 * s_xx + t11 * s_xy + t12 * s_xz
    v1 = t10 * s_xy + t11 * s_yy + t12 * s_yz
    v2 = t10 * s_xz + t11 * s_yz + t12 * s_zz
    cxx = u0 * t00 + u1 * t01 + u2 * t02 + 0.3
    cxy = u0 * t10 + u1 * t11 + u2 * t12
    cyy = v0 * t10 + v1 * t11 + v2 * t12 + 0.3

    det = cxx * cyy - cxy * cxy
    # an f32-overflowed covariance turns det into inf and the conic into NaN;
    # cull such a Gaussian instead of poisoning the frame
    num_ok = (torch.isfinite(det) & torch.isfinite(cxx) & torch.isfinite(cyy)
              & torch.isfinite(cxy))
    cxx = torch.where(num_ok, cxx, 1.0)
    cyy = torch.where(num_ok, cyy, 1.0)
    cxy = torch.where(num_ok, cxy, 0.0)
    det = torch.where(num_ok, det, 1.0)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    conic = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=-1)

    mid = 0.5 * (cxx + cyy)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))

    visible = (depth > 0.2) & (det != 0.0) & num_ok
    if active is not None:
        visible = visible & active

    # Binning bounds: with the hard cutoffs every pixel of alpha >= 1/255 lies
    # within the per-axis marginal extents sqrt(t2 * cov) of the opacity-aware
    # reach t2 = 2 ln(255 op); without them, the reference's 3-sigma square.
    if settings.hard_cutoffs:
        t2 = 2.0 * torch.log(torch.clamp(opacities[:, 0], min=1e-30) * 255.0)
        t2 = torch.clamp(t2, 0.0, 2.0 * torch.log(torch.tensor(255.0)).item())
        bound_x = torch.sqrt(t2 * torch.clamp(cxx, min=0.0))
        bound_y = torch.sqrt(t2 * torch.clamp(cyy, min=0.0))
        reachable = t2 > 0.0
    else:
        bound_x = bound_y = radius
        reachable = torch.ones_like(visible)

    ts = settings.tile_size
    binnable = visible & reachable
    rmin_x = torch.floor(torch.clamp((pi_x - bound_x) / ts, 0,
                                     settings.tiles_x))
    rmax_x = torch.floor(torch.clamp((pi_x + bound_x + ts - 1) / ts, 0,
                                     settings.tiles_x))
    rmin_y = torch.floor(torch.clamp((pi_y - bound_y) / ts, 0,
                                     settings.tiles_y))
    rmax_y = torch.floor(torch.clamp((pi_y + bound_y + ts - 1) / ts, 0,
                                     settings.tiles_y))
    rmin_x = torch.where(binnable, rmin_x, 0.0)
    rmax_x = torch.where(binnable, rmax_x, 0.0)
    rmin_y = torch.where(binnable, rmin_y, 0.0)
    rmax_y = torch.where(binnable, rmax_y, 0.0)
    visible = visible & ((rmax_x - rmin_x) * (rmax_y - rmin_y) > 0)
    radii = torch.where(visible, radius, 0.0)

    if colors_precomp is not None:
        colors = colors_precomp
    else:
        dx = mx - cam.campos[0]
        dy = my - cam.campos[1]
        dz = mz - cam.campos[2]
        inv_n = torch.rsqrt(dx * dx + dy * dy + dz * dz)
        dirs = torch.stack([dx * inv_n, dy * inv_n, dz * inv_n], dim=-1)
        rgb = eval_sh(settings.sh_degree, shs.transpose(1, 2), dirs)
        colors = torch.clamp(rgb + 0.5, min=0.0)

    return dict(
        point_image=torch.stack([pi_x, pi_y], dim=-1), conic=conic,
        depth=depth, opacity=opacities[:, 0], radii=radii, visible=visible,
        rect_min=torch.stack([rmin_x, rmin_y], dim=-1),
        rect_max=torch.stack([rmax_x, rmax_y], dim=-1), colors=colors,
    )


def pack_differentiable(prep: Dict[str, torch.Tensor],
                        features: torch.Tensor) -> torch.Tensor:
    """[N, 6 + C] rows [pix(2), conic(3), opacity, colors, features, depth]:
    what the training compositor differentiates."""
    return torch.cat([prep["point_image"], prep["conic"],
                      prep["opacity"][:, None], prep["colors"], features,
                      prep["depth"][:, None]], dim=1)


def tiles_to_image(settings: RasterSettings,
                   accum: torch.Tensor) -> torch.Tensor:
    """[T, C, px] per-tile channels -> the cropped [C, H, W] image."""
    ts, c_out = settings.tile_size, accum.shape[1]
    img = accum.reshape(settings.tiles_y, settings.tiles_x, c_out, ts, ts)
    img = img.permute(2, 0, 3, 1, 4).reshape(
        c_out, settings.tiles_y * ts, settings.tiles_x * ts)
    return img[:, :settings.image_height, :settings.image_width]


def composite_lists(settings: RasterSettings, prep, features,
                    bg) -> torch.Tensor:
    """The training composite: tile lists -> the compositor with the
    hand-derived backward -> [C + 1, H, W]."""
    entries, valid = bin_tiles(settings, prep)
    accum = composite_cv(settings, pack_differentiable(prep, features),
                         entries, valid, bg)
    return tiles_to_image(settings, accum)


def composite_stream_slots(settings: RasterSettings, prep, features,
                           bg) -> torch.Tensor:
    """The training composite on the stream layout: the stream's slots ->
    one differentiable row gather -> the compositor with the hand-derived
    backward -> [C + 1, H, W]."""
    src, starts = build_stream_train(settings, prep,
                                     settings.stream_ellipse_cull)
    accum = composite_stream_train(
        settings, pack_differentiable(prep, features), src, starts, bg)
    return tiles_to_image(settings, accum)


def composite_cell_lists(settings: RasterSettings, prep, features,
                         bg) -> torch.Tensor:
    """The cell-list composite: coarse binning only, then every tile walks
    its cell's candidate rows inside the kernel -> [C + 1, H, W] (C the
    padded channel count of the rows)."""
    ts, cell = settings.tile_size, settings.bin_cell_tiles
    src, cell_starts = bin_cells(settings, prep)
    out = composite_cells(pack_cell_rows(prep, features, src), cell_starts,
                          bg, cells_x=settings.cells_x, cell=cell,
                          tile_size=ts, hard_cutoffs=settings.hard_cutoffs)
    c_out = out.shape[2]             # [n_cells, cell^2, c_out, px]
    img = out.reshape(settings.cells_y, settings.cells_x, cell, cell, c_out,
                      ts, ts)
    img = img.permute(4, 0, 2, 5, 1, 3, 6).reshape(
        c_out, settings.cells_y * cell * ts, settings.cells_x * cell * ts)
    return img[:, :settings.image_height, :settings.image_width]


def binning_saturation(settings: RasterSettings,
                       prep) -> Dict[str, torch.Tensor]:
    """Truncation diagnostics of the tile lists (for reports, not the hot
    path): `tile_full_frac`, the share of tiles whose list of
    `settings.tile_capacity` entries is full, the only case in which a list
    may have dropped Gaussians, and `tile_max_count`, the longest list there
    would be without a capacity. (The JAX package also reports its band and
    cell lists; the port has neither.)"""
    if settings.tile_capacity is None:
        raise ValueError("binning_saturation needs a tile_capacity")
    prep = {k: prep[k].detach() for k in
            ("depth", "visible", "rect_min", "rect_max")}
    _, starts, _ = sorted_pairs(settings, prep, ellipse_cull=False)
    counts = starts[1:] - starts[:-1]
    return {"tile_full_frac":
            (counts >= settings.tile_capacity).float().mean(),
            "tile_max_count": counts.max()}


def rasterize(settings: RasterSettings, cam: CameraParams,
              means3d, opacities, scales, rotations, shs, colors_precomp,
              language_features: torch.Tensor,   # [N, L]
              bg: torch.Tensor,                  # [3]
              cov3d_precomp=None, active=None, means2d_dummy=None):
    """Returns (rendered [3, H, W], language image [L, H, W], radii [N],
    depth [1, H, W]) — the CUDA rasterizer's return signature (reference
    gaussian_renderer/__init__.py:219-228). Differentiable only with
    `settings.stream_train` or `settings.analytic_vjp`."""
    prep = preprocess(settings, cam, means3d, opacities, scales, rotations,
                      shs, colors_precomp, cov3d_precomp, active,
                      means2d_dummy)
    feats = (language_features if settings.include_feature
             else language_features.new_zeros((means3d.shape[0], 0)))
    if settings.stream_train:
        img = composite_stream_slots(settings, prep, feats, bg)
    elif settings.cell_composite:
        img = composite_cell_lists(settings, prep, feats, bg)
    elif settings.analytic_vjp:
        img = composite_lists(settings, prep, feats, bg)
    else:
        rows, starts = build_stream(settings, prep, feats)
        img = composite_stream(
            rows, starts, bg, tiles_x=settings.tiles_x,
            tiles_y=settings.tiles_y, tile_size=settings.tile_size,
            height=settings.image_height, width=settings.image_width,
            hard_cutoffs=settings.hard_cutoffs)
    c_lang = feats.shape[1]
    return (img[:3], img[3:3 + c_lang], prep["radii"],
            img[3 + c_lang:4 + c_lang])
