"""Host-side camera (minimal port of langsplat4d/data/cameras.py).

View and projection matrices in the transposed row-vector convention the
rasterizer consumes (reference scene/cameras.py:62-66). Ground-truth
language-feature loading waits for the port of the scene readers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from langsplat4d_torch.core.transforms import projection_matrix, world_to_view

ZNEAR, ZFAR = 0.01, 100.0


@dataclass
class HostCamera:
    R: np.ndarray                  # [3, 3] camera-to-world rotation
    T: np.ndarray                  # [3] world-to-camera translation
    fovx: float
    fovy: float
    width: int
    height: int
    time: float = 0.0
    znear: float = ZNEAR
    zfar: float = ZFAR
    image: Optional[np.ndarray] = None   # [3, H, W] float32 in [0, 1]
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    @property
    def world_view_transform(self) -> np.ndarray:
        return world_to_view(self.R, self.T, self.trans, self.scale).T

    @property
    def projection_matrix(self) -> np.ndarray:
        return projection_matrix(self.znear, self.zfar, self.fovx,
                                 self.fovy).T

    @property
    def full_proj_transform(self) -> np.ndarray:
        return self.world_view_transform @ self.projection_matrix

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.world_view_transform)[3, :3]

    def camera_params(self, device) -> "CameraParams":
        """The five tensors of render.raster.CameraParams on `device`."""
        from langsplat4d_torch.render.raster import CameraParams

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        return CameraParams(
            viewmatrix=t(self.world_view_transform),
            projmatrix=t(self.full_proj_transform),
            campos=t(self.camera_center),
            tanfovx=t(np.tan(self.fovx * 0.5)),
            tanfovy=t(np.tan(self.fovy * 0.5)),
        )
