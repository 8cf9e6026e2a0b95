"""Point growing on the host (port of langsplat4d/ops/point_utils.py;
reference utils/point_utils.py:9-147 and GaussianModel.grow,
scene/gaussian_model.py:630-713): voxel downsampling, the low-density test by
the mean 3-NN squared distance, and perturbed copies of the sparse points.
numpy, apart from the neighbour search (`ops.knn`).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from langsplat4d_torch.ops.knn import mean_knn_dist2


def downsample_point_cloud(points: np.ndarray,
                           voxel_size: float) -> np.ndarray:
    """Indices of one point per occupied voxel, sorted."""
    keys = np.floor(points / voxel_size).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return np.sort(idx)


def find_point_indices(points: np.ndarray, subset: np.ndarray) -> np.ndarray:
    """Indices in `points` of the rows that appear in `subset`."""
    pview = points.view([("", points.dtype)] * points.shape[1]).ravel()
    sview = subset.view([("", subset.dtype)] * subset.shape[1]).ravel()
    return np.nonzero(np.isin(pview, sview))[0]


def addpoint(point_cloud: np.ndarray, density_threshold: float,
             displacement_scale: float, iter_pass: int = 0, device=None,
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(all points, low-density points, their perturbed copies, the
    low-density mask): a point is low-density when its mean 3-NN squared
    distance exceeds the threshold. The neighbour search runs on
    `device`."""
    d2 = mean_knn_dist2(point_cloud.astype(np.float32),
                        device=device).cpu().numpy()
    low_density_mask = d2 > density_threshold
    low = point_cloud[low_density_mask]
    rng = np.random.default_rng(iter_pass)
    new_points = low + rng.normal(scale=displacement_scale, size=low.shape)
    return point_cloud, low, new_points, low_density_mask


def grow_points(points: np.ndarray, density_threshold: float = 20,
                displacement_scale: float = 20, voxel_size: float = 8,
                max_downsampled: int = 1000, device=None):
    """GaussianModel.grow's host side: downsample (coarser until at most
    `max_downsampled` points remain), find the low-density candidates;
    returns (the selection mask over `points`, the proposed points)."""
    down_idx = downsample_point_cloud(points, voxel_size)
    while len(down_idx) > max_downsampled:
        voxel_size += 8
        down_idx = downsample_point_cloud(points, voxel_size)
    _, _, new_points, low_mask = addpoint(points[down_idx],
                                          density_threshold,
                                          displacement_scale, device=device)
    global_mask = np.zeros(len(points), bool)
    global_mask[down_idx] = low_mask
    return global_mask, new_points
