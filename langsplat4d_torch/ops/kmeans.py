"""K-Means of many small point sets at once, on the device: the discrete
stage's centres (train/loop.prepare_discrete_stage), where the JAX package
fits scikit-learn's KMeans(n_clusters, random_state=0, n_init=10) once per
Gaussian on the host (langsplat4d/train/loop.py:1164-1168).

`kmeans` takes every Gaussian's samples as one [N, S, L] tensor and runs
scikit-learn's algorithm on all of them together:
- greedy k-means++ seeding (`_kmeans_plusplus`): the first centre a sample
  drawn uniformly, each next one the best, by the potential it leaves, of
  2 + int(log k) candidates drawn in proportion to the squared distance to
  the nearest centre;
- Lloyd's iterations, at most MAX_ITER (scikit-learn's 300), each Gaussian
  stopping on its own when its labels repeat or its centres move by at
  most TOL x the mean variance of its samples (scikit-learn's `_tolerance`,
  tol 1e-4); then one more assignment to the final centres;
- N_INIT restarts (scikit-learn's n_init=10), keeping each Gaussian's
  lowest inertia.
An empty cluster takes the sample farthest from its centre (scikit-learn
also takes that sample's weight out of its old cluster; the port does not).
All random numbers come before the restarts, one sequence for every set:
`random_state_draws(k, seed)`, the uniforms that
KMeans(random_state=seed) reads from numpy's RandomState (one for the first
centre, then the candidates', restart after restart), so every set starts
each restart from scikit-learn's own seeds. The plain version,
`kmeans_plain`, a loop over Gaussians written for one point set at a time,
takes the same numbers.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


N_INIT, MAX_ITER, TOL = 10, 300, 1e-4     # as the JAX package calls KMeans


def _trials(k: int) -> int:
    return 2 + int(math.log(k))


def random_state_draws(k: int, seed: int = 0) -> torch.Tensor:
    """[N_INIT, 1 + (k - 1) * trials] float64: the uniforms scikit-learn's
    KMeans(n_clusters=k, n_init=N_INIT, random_state=seed) draws from
    numpy's RandomState(seed) for its k-means++ seeding, in order."""
    r = 1 + (k - 1) * _trials(k)
    return torch.from_numpy(np.random.RandomState(seed).random_sample(
        N_INIT * r).reshape(N_INIT, r))


def tolerance(x: torch.Tensor) -> torch.Tensor:
    """TOL x the mean over features of the samples' variance, per set:
    x [..., S, L] -> [...] (scikit-learn's `_tolerance`)."""
    return x.var(dim=-2, unbiased=False).mean(-1) * TOL


def _sq_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x [N, S, L], c [N, k, L] -> [N, S, k] squared distances."""
    return torch.stack([((x - c[:, None, j]) ** 2).sum(-1)
                        for j in range(c.shape[1])], -1)


def _seed(x: torch.Tensor, k: int, u: torch.Tensor) -> torch.Tensor:
    """Greedy k-means++ for every set: x [N, S, L], u [N, R] -> [N, k, L]."""
    n, s, _ = x.shape
    rows = torch.arange(n, device=x.device)
    t = _trials(k)
    first = (u[:, 0] * s).long().clamp(max=s - 1)
    centers = [x[rows, first]]
    closest = ((x - centers[0][:, None]) ** 2).sum(-1)           # [N, S]
    pot = closest.sum(1)
    for c in range(1, k):
        r = u[:, 1 + (c - 1) * t:1 + c * t] * pot[:, None].double()
        cum = closest.double().cumsum(1)
        cand = torch.searchsorted(cum, r).clamp(max=s - 1)       # [N, t]
        pts = x[rows[:, None], cand]                              # [N, t, L]
        d = ((x[:, None] - pts[:, :, None]) ** 2).sum(-1)        # [N, t, S]
        d = torch.minimum(closest[:, None], d)
        cpot = d.sum(-1)
        best = cpot.argmin(1)
        pot, closest = cpot[rows, best], d[rows, best]
        centers.append(pts[rows, best])
    return torch.stack(centers, 1)


def _lloyd(x: torch.Tensor, centers: torch.Tensor, tol: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's iterations on every set until each stops; -> (centers
    [N, k, L], inertia [N])."""
    n, s, _ = x.shape
    k = centers.shape[1]
    rows = torch.arange(n, device=x.device)
    active = torch.ones(n, dtype=torch.bool, device=x.device)
    labels_old = torch.full((n, s), -1, dtype=torch.long, device=x.device)
    for _ in range(MAX_ITER):
        d = _sq_dist(x, centers)
        labels = d.argmin(-1)
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
        counts = onehot.sum(1)                                   # [N, k]
        new = torch.einsum("nsk,nsl->nkl", onehot, x) / counts.clamp(
            min=1)[..., None]
        empty = counts == 0
        if bool(empty.any()):
            far = d.gather(-1, labels[..., None])[..., 0].topk(k, 1).indices
            rank = (empty.cumsum(1) - 1).clamp(min=0)            # [N, k]
            moved = x[rows[:, None], far.gather(1, rank)]
            new = torch.where(empty[..., None], moved, new)
        shift = ((new - centers) ** 2).sum((1, 2))
        done = (labels == labels_old).all(1) | (shift <= tol)
        centers = torch.where(active[:, None, None], new, centers)
        labels_old = labels
        active = active & ~done
        if not bool(active.any()):
            break
    inertia = _sq_dist(x, centers).min(-1).values.sum(1)
    return centers, inertia


def kmeans(x: torch.Tensor, k: int, seed: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-Means of each set of x [N, S, L] (float32) into k clusters:
    (centers [N, k, L], inertia [N]), the best of N_INIT restarts per set,
    seeded as KMeans(n_clusters=k, n_init=N_INIT, random_state=seed) seeds
    each one."""
    n = x.shape[0]
    u = random_state_draws(k, seed).to(x.device)
    tols = tolerance(x)
    best_c = best_i = None
    for i in range(N_INIT):
        c, inertia = _lloyd(x, _seed(x, k, u[i].expand(n, -1)), tols)
        if best_c is None:
            best_c, best_i = c, inertia
            continue
        better = inertia < best_i
        best_c = torch.where(better[:, None, None], c, best_c)
        best_i = torch.where(better, inertia, best_i)
    return best_c, best_i


def _kmeans_one(x: torch.Tensor, k: int, u: torch.Tensor, tol: float
                ) -> Tuple[torch.Tensor, float]:
    """One set x [S, L] from one restart's uniforms u [R]."""
    s = x.shape[0]
    t = _trials(k)
    centers = [x[min(int(u[0] * s), s - 1)]]
    closest = ((x - centers[0]) ** 2).sum(-1)
    pot = float(closest.sum())
    for c in range(1, k):
        cum = closest.double().cumsum(0)
        best = None
        for j in range(t):
            idx = min(int(torch.searchsorted(
                cum, u[1 + (c - 1) * t + j] * pot)), s - 1)
            d = torch.minimum(closest, ((x - x[idx]) ** 2).sum(-1))
            if best is None or float(d.sum()) < best[0]:
                best = (float(d.sum()), d, idx)
        pot, closest = best[0], best[1]
        centers.append(x[best[2]])
    centers = torch.stack(centers)
    labels_old = None
    for _ in range(MAX_ITER):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)          # [S, k]
        labels = d.argmin(1)
        new = centers.clone()
        far, n_empty = None, 0
        for j in range(k):
            members = x[labels == j]
            if len(members):
                new[j] = members.mean(0)
                continue
            if far is None:             # the samples farthest from their
                far = d[torch.arange(s), labels].topk(k).indices  # centres
            new[j] = x[far[n_empty]]
            n_empty += 1
        shift = float(((new - centers) ** 2).sum())
        centers = new
        if labels_old is not None and bool((labels == labels_old).all()):
            break
        if shift <= tol:
            break
        labels_old = labels
    d = ((x[:, None] - centers[None]) ** 2).sum(-1)
    return centers, float(d.min(1).values.sum())


def kmeans_plain(x: torch.Tensor, k: int, seed: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`kmeans` one set at a time, in a Python loop: the same random
    numbers, the same result up to rounding."""
    n = x.shape[0]
    u = random_state_draws(k, seed).to(x.device)
    tols = tolerance(x)
    out_c = torch.empty((n, k, x.shape[2]), dtype=x.dtype, device=x.device)
    out_i = torch.empty(n, dtype=x.dtype, device=x.device)
    for g in range(n):
        best = None
        for i in range(N_INIT):
            c, inertia = _kmeans_one(x[g], k, u[i], float(tols[g]))
            if best is None or inertia < best[1]:
                best = (c, inertia)
        out_c[g], out_i[g] = best[0], best[1]
    return out_c, out_i
