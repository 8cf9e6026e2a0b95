"""HexPlane (K-Planes) spatio-temporal feature field (port of
langsplat4d/field/hexplane.py; reference scene/hexplane.py:109-185).

Six planes per scale over the coordinate pairs xy, xz, xt, yz, yt, zt;
bilinear samples multiplied over planes, concatenated over scales. Plane
parameters keep the reference's [1, C, H, W] layout so checkpoints load
as they are.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import torch
from torch import nn

from langsplat4d_torch.ops.grid_sample import grid_sample_2d, grid_sample_3d

COO_COMBS = tuple(itertools.combinations(range(4), 2))  # xy,xz,xt,yz,yt,zt
SPATIAL_PLANE_IDS = (0, 1, 3)
TIME_PLANE_IDS = (2, 4, 5)


class HexPlaneField(nn.Module):
    """`grids.{scale}.{plane}` parameters of shape [1, C, reso[c1], reso[c0]];
    time planes start at 1, spatial planes uniform in [0.1, 0.5]."""

    def __init__(self, out_dim: int, resolution: Sequence[int],
                 multires: Sequence[int], generator: torch.Generator):
        super().__init__()
        grids = []
        for res_mult in multires:
            reso = ([r * res_mult for r in resolution[:3]]
                    + list(resolution[3:]))
            planes = []
            for comb in COO_COMBS:
                shape = (1, out_dim, reso[comb[1]], reso[comb[0]])
                if 3 in comb:
                    plane = torch.ones(shape)
                else:
                    plane = torch.empty(shape).uniform_(0.1, 0.5,
                                                        generator=generator)
                planes.append(nn.Parameter(plane))
            grids.append(nn.ParameterList(planes))
        self.grids = nn.ModuleList(grids)


class DenseGrid(nn.Module):
    """Ones-initialized occupancy grid `grid` [1, C, Nx, Ny, Nz]
    (reference scene/grid.py:15-24)."""

    def __init__(self, channels: int = 1, world_size=(64, 64, 64)):
        super().__init__()
        self.grid = nn.Parameter(torch.ones(1, channels, *world_size))


def normalize_aabb(pts: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """aabb[0] is the max corner and aabb[1] the min corner (the reference's
    inverted convention, kept for parity)."""
    return (pts - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


def hexplane_spatial(field: HexPlaneField, aabb: torch.Tensor,
                     pts: torch.Tensor) -> List[torch.Tensor]:
    """Time-independent part of the query: per scale, the product of the
    xy, xz and yz plane samples ([n, C] each). Computed once per trajectory,
    since the Gaussians' positions do not change between frames."""
    p = normalize_aabb(pts, aabb)
    per_scale = []
    for planes in field.grids:
        interp = 1.0
        for ci in SPATIAL_PLANE_IDS:
            interp = interp * grid_sample_2d(planes[ci][0],
                                             p[:, list(COO_COMBS[ci])])
        per_scale.append(interp)
    return per_scale


def hexplane_query(field: HexPlaneField, aabb: torch.Tensor,
                   pts: torch.Tensor, timestamps: torch.Tensor,
                   spatial: Optional[List[torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Features at (xyz, t): pts [n, 3] raw world coordinates, timestamps
    [n, 1] in [0, 1]; `spatial` is an optional hexplane_spatial result for the
    same points. Returns [n, out_dim * num_scales]."""
    p4 = torch.cat([normalize_aabb(pts, aabb), timestamps], dim=-1)
    if spatial is None:
        spatial = hexplane_spatial(field, aabb, pts)
    per_scale = []
    for si, planes in enumerate(field.grids):
        interp = spatial[si]
        for ci in TIME_PLANE_IDS:
            interp = interp * grid_sample_2d(planes[ci][0],
                                             p4[:, list(COO_COMBS[ci])])
        per_scale.append(interp)
    return torch.cat(per_scale, dim=-1)


def dense_grid_query(grid: DenseGrid, aabb: torch.Tensor,
                     pts: torch.Tensor) -> torch.Tensor:
    """Trilinear DenseGrid sample, zeros outside the AABB (reference
    scene/grid.py:26-37). pts [n, 3] -> [n, C]. `grid_sample_3d` is
    F.grid_sample's forward with a backward that sums in a fixed order, so
    two identical runs with `empty_voxel` are bit-equal on the GPU."""
    xyz_max, xyz_min = aabb[0], aabb[1]
    ind = ((pts - xyz_min) / (xyz_max - xyz_min)).flip(-1) * 2 - 1
    return grid_sample_3d(grid.grid[0], ind)


# Plane regularizers (reference scene/regulation.py and
# scene/gaussian_model.py:763-802)

def _plane_smoothness(plane: torch.Tensor) -> torch.Tensor:
    """Mean squared second difference along H (dim -2); for time planes H is
    the time axis."""
    first = plane[..., 1:, :] - plane[..., :-1, :]
    second = first[..., 1:, :] - first[..., :-1, :]
    return torch.mean(second ** 2)


def _sum_over_planes(field: HexPlaneField, plane_ids, fn) -> torch.Tensor:
    return sum(fn(planes[i]) for planes in field.grids for i in plane_ids)


def _l1_from_one(plane: torch.Tensor) -> torch.Tensor:
    """mean |1 - plane|. Written with `where` so that the derivative at
    plane == 1 is that of the d >= 0 branch, as the JAX package's abs has it
    (torch.abs has 0 there): the time planes start at exactly 1."""
    d = 1.0 - plane
    return torch.mean(torch.where(d >= 0, d, -d))


def compute_regulation(field: HexPlaneField, time_smoothness_weight: float,
                       l1_time_planes_weight: float,
                       plane_tv_weight: float) -> torch.Tensor:
    """Reference GaussianModel.compute_regulation: smoothness of the spatial
    planes, smoothness of the time planes, and |1 - plane| on the time
    planes, each with its weight."""
    return (plane_tv_weight
            * _sum_over_planes(field, SPATIAL_PLANE_IDS, _plane_smoothness)
            + time_smoothness_weight
            * _sum_over_planes(field, TIME_PLANE_IDS, _plane_smoothness)
            + l1_time_planes_weight
            * _sum_over_planes(field, TIME_PLANE_IDS, _l1_from_one))
