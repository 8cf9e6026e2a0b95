"""Bilinear 2D plane sampling for the HexPlane field (port of
langsplat4d/ops/grid_sample.py, which was written to match this op)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """plane: [C, H, W]; coords: [n, 2] in [-1, 1], coords[:, 0] indexing W
    and coords[:, 1] indexing H. Returns [n, C] (align_corners=True, border
    padding, as reference scene/hexplane.py:21-46)."""
    out = F.grid_sample(plane[None], coords[None, :, None, :],
                        mode="bilinear", padding_mode="border",
                        align_corners=True)        # [1, C, n, 1]
    return out[0, :, :, 0].T
