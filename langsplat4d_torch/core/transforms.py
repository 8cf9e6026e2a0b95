"""Camera and geometry math (port of langsplat4d/core/transforms.py).

Matrix builders are numpy, run once per camera on the host; per-Gaussian
helpers are torch.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera matrix (reference getWorld2View2).

    R is the camera-to-world rotation (COLMAP convention: stored transposed),
    t the world->camera translation.
    """
    if translate is None:
        translate = np.zeros(3)
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.float32(np.linalg.inv(C2W))


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """OpenGL-style perspective projection (reference getProjectionMatrix)."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Batched Hamilton product (w, x, y, z), output normalized."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    q3 = torch.stack([w, x, y, z], dim=-1)
    return q3 / torch.linalg.norm(q3, dim=-1, keepdim=True)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))


def safe_normalize(x: torch.Tensor, eps: float = 1e-9,
                   dim: int = -1) -> torch.Tensor:
    """x / (||x|| + eps), finite at x = 0 (language features start at 0)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    norm = torch.sqrt(torch.clamp(sq, min=1e-30))
    return x / (norm + eps)
