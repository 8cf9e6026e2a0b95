"""Gaussian scene state padded to a fixed capacity (port of
langsplat4d/core/state.py).

The padded capacity and the active mask are kept for parity with the JAX
package: only rows [0, num_active) are live, and padded rows are neutral
(very negative opacity logit, tiny scales).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from langsplat4d_torch.core.device import resolve_device

# Opacity logit of padded (inactive) rows; sigmoid(-30) ~ 1e-13.
PAD_OPACITY_LOGIT = -30.0
# Log-scale of padded rows; exp(-20) ~ 2e-9 world units.
PAD_LOG_SCALE = -20.0


def round_capacity(n: int, granule: int = 8192) -> int:
    """Round a Gaussian count up to a capacity granule."""
    return max(granule, ((n + granule - 1) // granule) * granule)


@dataclass
class GaussianState:
    """Per-Gaussian parameters before activation, padded to capacity
    (reference scene/gaussian_model.py:52-69)."""

    xyz: torch.Tensor               # [cap, 3]
    features_dc: torch.Tensor       # [cap, 1, 3]
    features_rest: torch.Tensor     # [cap, (max_sh+1)^2 - 1, 3]
    scaling: torch.Tensor           # [cap, 3] log-scales
    rotation: torch.Tensor          # [cap, 4] unnormalized (w, x, y, z)
    opacity: torch.Tensor           # [cap, 1] logits
    language_feature: torch.Tensor  # [cap, L]
    num_active: int
    # a rank's block of the rows (parallel/mesh.py): the block's first row
    # in the whole state, against which num_active counts
    row_offset: int = 0

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def max_sh_degree(self) -> int:
        return int(round((self.features_rest.shape[1] + 1) ** 0.5)) - 1

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def active_mask(self) -> torch.Tensor:
        """[cap] bool; True for live Gaussians."""
        return (torch.arange(self.capacity, device=self.device)
                + self.row_offset) < self.num_active

    def get_features(self) -> torch.Tensor:
        """[cap, (max_sh+1)^2, 3] concatenated SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)


def from_arrays(xyz, features_dc, features_rest, scaling, rotation, opacity,
                language_feature=None, capacity: Optional[int] = None,
                lang_dim: int = 3, device=None) -> GaussianState:
    """Padded GaussianState from dense (unpadded) numpy arrays, on `device`
    (None: the current CUDA device, an error where there is none)."""
    device = resolve_device(device)
    n = int(np.shape(xyz)[0])
    cap = capacity if capacity is not None else round_capacity(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < active count {n}")
    if language_feature is None:
        language_feature = np.zeros((n, lang_dim), np.float32)
    sh_rest = np.shape(features_rest)[1]
    pads = dict(
        xyz=np.zeros((cap, 3), np.float32),
        features_dc=np.zeros((cap, 1, 3), np.float32),
        features_rest=np.zeros((cap, sh_rest, 3), np.float32),
        scaling=np.full((cap, 3), PAD_LOG_SCALE, np.float32),
        rotation=np.concatenate([np.ones((cap, 1), np.float32),
                                 np.zeros((cap, 3), np.float32)], axis=1),
        opacity=np.full((cap, 1), PAD_OPACITY_LOGIT, np.float32),
        language_feature=np.zeros((cap, np.shape(language_feature)[1]),
                                  np.float32),
    )
    dense = dict(xyz=xyz, features_dc=features_dc,
                 features_rest=features_rest, scaling=scaling,
                 rotation=rotation, opacity=opacity,
                 language_feature=language_feature)
    out = {}
    for k, pad in pads.items():
        pad[:n] = np.asarray(dense[k], np.float32)
        out[k] = torch.from_numpy(pad).to(device)
    return GaussianState(**out, num_active=n)


def create_from_pcd(points, colors, *, max_sh_degree: int = 3,
                    lang_dim: int = 3, capacity: Optional[int] = None,
                    knn_dist2=None, device=None) -> GaussianState:
    """A padded GaussianState from a coloured point cloud (reference
    GaussianModel.create_from_pcd, scene/gaussian_model.py:192-219): SH DC
    from RGB2SH(colors), log-scales log(sqrt(mean 3-NN squared distance))
    clamped below at 1e-7 (`ops.knn`, the simple-knn distCUDA2 init),
    identity quaternions and an opacity logit of inverse_sigmoid(0.1).
    `device=None` is the current CUDA device (an error where there is
    none)."""
    from langsplat4d_torch.core.sh import rgb_to_sh
    from langsplat4d_torch.core.transforms import inverse_sigmoid
    from langsplat4d_torch.ops.knn import mean_knn_dist2

    device = resolve_device(device)
    pts = torch.from_numpy(np.asarray(points, np.float32)).to(device)
    cols = torch.from_numpy(np.asarray(colors, np.float32)).to(device)
    n = pts.shape[0]
    if knn_dist2 is None:
        knn_dist2 = mean_knn_dist2(pts)
    dist2 = torch.clamp(torch.as_tensor(knn_dist2, dtype=torch.float32,
                                        device=device), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    features_dc = rgb_to_sh(cols)[:, None, :]
    features_rest = torch.zeros((n, (max_sh_degree + 1) ** 2 - 1, 3),
                                device=device)
    rots = torch.cat([torch.ones((n, 1), device=device),
                      torch.zeros((n, 3), device=device)], dim=1)
    opacities = inverse_sigmoid(0.1 * torch.ones((n, 1), device=device))
    return from_arrays(*(t.cpu().numpy() for t in (
        pts, features_dc, features_rest, scales, rots, opacities)),
        capacity=capacity, lang_dim=lang_dim, device=device)
