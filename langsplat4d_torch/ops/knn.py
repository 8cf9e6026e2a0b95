"""Mean squared distance to the 3 nearest neighbours: the `distCUDA2`
initialisation of the log-scales (port of langsplat4d/ops/knn.py; the
reference calls the CUDA `simple-knn` submodule once at model init,
scene/gaussian_model.py:22,203).

Not a kernel of the JAX package's, so it stays plain PyTorch: squared
distances of a block of queries to a block of keys in the expanded form
|q|^2 + |k|^2 - 2 q.k (the JAX package's, so that the scales agree),
clamped at 0, with the point itself and the padding excluded, then a running
top-3 over the key blocks.
"""
from __future__ import annotations

import numpy as np
import torch

from langsplat4d_torch.core.device import resolve_device


def mean_knn_dist2(points, k: int = 3, block_q: int = 1024,
                   block_k: int = 8192, device=None) -> torch.Tensor:
    """[N, 3] points (numpy or tensor) -> [N] mean of the squared distances
    to each point's `k` nearest other points. With fewer than k + 1 points
    the missing neighbours count as inf, as in the JAX package (callers
    clamp). `device=None` is the points' device for a tensor and the current
    CUDA device for a numpy array."""
    if torch.is_tensor(points):
        pts = points.detach().to(torch.float32)
        if device is not None:
            pts = pts.to(resolve_device(device))
    else:
        pts = torch.from_numpy(np.asarray(points, np.float32)).to(
            resolve_device(device))
    n = pts.shape[0]
    sq = (pts * pts).sum(-1)
    out = torch.empty(n, device=pts.device)
    for q0 in range(0, n, block_q):
        q = pts[q0:q0 + block_q]
        q_idx = torch.arange(q0, q0 + q.shape[0], device=pts.device)
        best = torch.full((q.shape[0], k), float("inf"), device=pts.device)
        for k0 in range(0, n, block_k):
            keys = pts[k0:k0 + block_k]
            d2 = sq[q0:q0 + q.shape[0], None] + sq[None, k0:k0 + keys.shape[0]] \
                - 2.0 * (q @ keys.T)
            d2 = torch.clamp(d2, min=0.0)
            k_idx = torch.arange(k0, k0 + keys.shape[0], device=pts.device)
            d2 = torch.where(q_idx[:, None] == k_idx[None, :],
                             float("inf"), d2)
            cand = torch.cat([best, d2], dim=1)
            best = torch.topk(cand, k, dim=1, largest=False).values
        out[q0:q0 + q.shape[0]] = best.mean(dim=1)
    return out
