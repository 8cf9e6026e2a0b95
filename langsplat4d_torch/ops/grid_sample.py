"""Bilinear 2D plane sampling for the HexPlane field (port of
langsplat4d/ops/grid_sample.py, which was written to match this op), and
the DenseGrid's trilinear 3D sample (`grid_sample_3d`, below).

The forward is `F.grid_sample`'s (align_corners, border padding). The
backward is the port's own, `plane_grad`, without float atomics, so two
identical training runs give the same bits: aten's CUDA backward adds the
plane gradient with atomicAdd, and the fine stages drifted apart run to
run. On CUDA tensors `plane_grad` launches the kernels of
csrc/plane_grad.cu (the coordinates' gradient per point as aten computes
it; the plane gradient through one stable sort of the corner cells and a
segmented sum in a fixed order); on CPU tensors it runs `plane_grad_plain`,
the same function in PyTorch (`index_add_`, one index after another).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from langsplat4d_torch.ops import composite

CHUNK = 256            # sorted entries per block of the segmented sum


def _axis(c: torch.Tensor, size: int):
    """aten's align_corners unnormalize and border clip along one axis:
    the clipped source position, its floor, and the clip's derivative
    (0 on and beyond the borders, as aten counts them out of bounds)."""
    raw = (c + 1) / 2 * (size - 1)
    inside = (raw > 0) & (raw < size - 1)
    pos = raw.clamp(0, size - 1)
    return pos, pos.floor(), inside


def _corners(H: int, W: int, coords: torch.Tensor):
    """The four corners (nw, ne, sw, se) of each point's bilinear sample:
    their cells [4, n] and weights [4, n], the distances (e, w, s, n) as
    aten forms them, which corners lie on the plane, and the clip's
    derivative per axis. A far corner beyond the plane has weight exactly
    0 (ix == W - 1) and is clamped onto the border, so it adds nothing."""
    ix, x0, in_x = _axis(coords[:, 0], W)
    iy, y0, in_y = _axis(coords[:, 1], H)
    xi0, yi0 = x0.long(), y0.long()
    xi1, yi1 = (xi0 + 1).clamp(max=W - 1), (yi0 + 1).clamp(max=H - 1)
    e, w, s, n = x0 + 1 - ix, ix - x0, y0 + 1 - iy, iy - y0
    cells = torch.stack([yi0 * W + xi0, yi0 * W + xi1,
                         yi1 * W + xi0, yi1 * W + xi1])
    wts = torch.stack([e * s, w * s, e * n, w * n])
    return cells, wts, (e, w, s, n), (xi0 + 1 < W, yi0 + 1 < H), (in_x, in_y)


def coords_grad_plain(plane: torch.Tensor, g: torch.Tensor, corners):
    """d coords [n, 2] of grid_sample_2d for the output gradient g [n, C],
    from `_corners` of the points, as aten forms it (no sum across points:
    no atomics on a GPU either)."""
    C, H, W = plane.shape
    cells, _, (e, w, s, n), (on_x, on_y), (in_x, in_y) = corners
    v = plane.reshape(C, H * W).T[cells]                    # [4, n, C]
    # corners beyond the plane read 0 in aten
    v[1] = torch.where(on_x[:, None], v[1], 0.0)
    v[2] = torch.where(on_y[:, None], v[2], 0.0)
    v[3] = torch.where((on_x & on_y)[:, None], v[3], 0.0)
    s, n, e, w = s[:, None], n[:, None], e[:, None], w[:, None]
    gix = ((-v[0] * s + v[1] * s - v[2] * n + v[3] * n) * g).sum(1)
    giy = ((-v[0] * e - v[1] * w + v[2] * e + v[3] * w) * g).sum(1)
    return torch.stack(
        [gix * ((W - 1) / 2) * in_x, giy * ((H - 1) / 2) * in_y], 1)


def plane_grad_plain(plane: torch.Tensor, coords: torch.Tensor,
                     g: torch.Tensor):
    """The backward of grid_sample_2d in PyTorch: (d plane [C, H, W],
    d coords [n, 2]) for the output gradient g [n, C]. The plane gradient
    adds with `index_add_`, which on the CPU goes one index after another
    (on a GPU it adds with atomics: there use `plane_grad`)."""
    C, H, W = plane.shape
    corners = _corners(H, W, coords)
    cells, wts = corners[:2]
    g_plane = torch.zeros(H * W, C, dtype=g.dtype, device=g.device)
    g_plane.index_add_(0, cells.reshape(-1),
                       (wts[:, :, None] * g[None]).reshape(-1, C))
    return g_plane.T.reshape(C, H, W), coords_grad_plain(plane, g, corners)


def plane_grad_scheme_plain(plane: torch.Tensor, coords: torch.Tensor,
                            g: torch.Tensor, chunk: int = CHUNK):
    """The plane gradient as csrc/plane_grad.cu sums it, step by step on
    the CPU: the corner keys (a point whose output gradient is all 0 gets
    keys past the plane, HW + point), then `segment_sums_scheme_plain`.
    -> d plane [C, H, W]. For the tests of the kernel's scheme."""
    C, H, W = plane.shape
    n = coords.shape[0]
    cells, wts, *_ = _corners(H, W, coords)
    live = (g != 0).any(1)
    keys = torch.where(live[None], cells, H * W + torch.arange(n)[None])
    return segment_sums_scheme_plain(keys.reshape(-1), wts.reshape(-1), g,
                                     H * W, chunk).T.reshape(C, H, W)


def segment_sums_scheme_plain(keys: torch.Tensor, wts: torch.Tensor,
                              g: torch.Tensor, hw: int, chunk: int = CHUNK):
    """The sums of csrc/plane_grad.cu's `chunk_sums` and `merge_runs`, step
    by step on the CPU: entry e (keys [E], wts [E], E a multiple of the
    points n, entry e for point e % n) adds wts[e] * g[e % n] to cell
    keys[e] (keys >= hw add nothing); one stable sort, per `chunk` sorted
    entries a Hillis-Steele segmented scan, each run inside a chunk written
    by its last entry, and a run that crosses chunks summed from its first
    chunk's tail partial and the following chunks' head partials in order.
    -> [hw, C]."""
    C = g.shape[1]
    n = g.shape[0]
    skeys, order = torch.sort(keys, stable=True)
    E = keys.numel()
    chunks = -(-E // chunk)
    K = torch.full((chunks * chunk,), torch.iinfo(torch.int64).max)
    K[:E] = skeys
    V = torch.zeros((chunks * chunk, C), dtype=g.dtype)
    V[:E] = wts[order][:, None] * g[order % n]
    K, V = K.reshape(chunks, chunk), V.reshape(chunks, chunk, C)
    d = 1
    while d < chunk:                   # all lanes add their old neighbour
        take = torch.zeros_like(K, dtype=torch.bool)
        take[:, d:] = K[:, d:] == K[:, :-d]
        add = torch.zeros_like(V)
        add[:, d:] = V[:, :-d]
        V = V + torch.where(take[..., None], add, 0.0)
        d *= 2
    out = torch.zeros((hw, C), dtype=g.dtype)
    head = torch.zeros((chunks, C), dtype=g.dtype)
    tail = torch.zeros((chunks, C), dtype=g.dtype)
    flat = K.reshape(-1)
    for pos in range(E):
        b, t = divmod(pos, chunk)
        key = int(flat[pos])
        if key >= hw or not (t == chunk - 1 or pos + 1 >= E
                             or flat[pos + 1] != key):
            continue                   # past the plane, or not a run's end
        before = (b > 0 and flat[b * chunk] == key
                  and flat[b * chunk - 1] == key)
        on = t == chunk - 1 and pos + 1 < E and flat[pos + 1] == key
        if not before and not on:
            out[key] = V[b, t]
        if before:
            head[b] = V[b, t]
        if on:
            tail[b] = V[b, t]
    for b in range(1, chunks):
        key = int(flat[b * chunk])
        if key >= hw or flat[b * chunk - 1] != key:
            continue                   # no run crosses into chunk b
        if b >= 2 and flat[(b - 1) * chunk - 1] == key:
            continue                   # not the run's first crossing
        acc, j = tail[b - 1].clone(), b
        while True:
            acc = acc + head[j]
            nxt = (j + 1) * chunk
            if j + 1 >= chunks or nxt >= E or flat[nxt] != key:
                break
            j += 1
        out[key] = acc
    return out


def plane_grad(plane: torch.Tensor, coords: torch.Tensor, g: torch.Tensor):
    """The backward of grid_sample_2d: (d plane [C, H, W], d coords [n, 2])
    for the output gradient g [n, C], float32, C <= 32. On CUDA tensors
    the kernels of csrc/plane_grad.cu, two identical calls bit-equal; on
    CPU tensors `plane_grad_plain`."""
    if g.device.type == "cpu":
        return plane_grad_plain(plane, coords, g)
    if g.device.type != "cuda":
        raise ValueError(f"plane_grad: no kernel for {g.device}")
    C, H, W = plane.shape
    n = coords.shape[0]
    for name, t in (("plane", plane), ("coords", coords), ("g", g)):
        if t.dtype != torch.float32 or t.device != g.device:
            raise ValueError(f"{name} must be float32 on {g.device}")
    plane, coords, g = plane.contiguous(), coords.contiguous(), g.contiguous()
    dev = g.device
    g_coords = torch.empty((n, 2), dtype=torch.float32, device=dev)
    keys = torch.empty(4 * n, dtype=torch.int32, device=dev)
    wts = torch.empty(4 * n, dtype=torch.float32, device=dev)
    composite._launch("plane_grad_corners", dev, coords.data_ptr(),
                      plane.data_ptr(), g.data_ptr(), g_coords.data_ptr(),
                      keys.data_ptr(), wts.data_ptr(), n, C, H, W)
    skeys, order = torch.sort(keys, stable=True)
    out = torch.zeros((H * W, C), dtype=torch.float32, device=dev)
    partials = torch.empty(2 * C * max(-(-4 * n // CHUNK), 1),
                           dtype=torch.float32, device=dev)
    composite._launch("plane_grad_sums", dev, skeys.data_ptr(),
                      order.data_ptr(), wts.data_ptr(), g.data_ptr(),
                      out.data_ptr(), partials.data_ptr(), 4 * n, n, C, H * W)
    plane_grad.launches += 1
    return out.T.reshape(C, H, W), g_coords


plane_grad.launches = 0


class _GridSample2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plane, coords):
        ctx.save_for_backward(plane, coords)
        out = F.grid_sample(plane[None], coords[None, :, None, :],
                            mode="bilinear", padding_mode="border",
                            align_corners=True)        # [1, C, n, 1]
        return out[0, :, :, 0].T

    @staticmethod
    def backward(ctx, g):
        plane, coords = ctx.saved_tensors
        g_plane, g_coords = plane_grad(plane, coords, g)
        return (g_plane if ctx.needs_input_grad[0] else None,
                g_coords if ctx.needs_input_grad[1] else None)


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """plane: [C, H, W]; coords: [n, 2] in [-1, 1], coords[:, 0] indexing W
    and coords[:, 1] indexing H. Returns [n, C] (align_corners=True, border
    padding, as reference scene/hexplane.py:21-46). Its backward adds no
    float atomics (see the module docstring)."""
    return _GridSample2d.apply(plane, coords)


# The DenseGrid's trilinear sample (field/hexplane.py dense_grid_query):
# F.grid_sample in 3-D, align_corners, zeros outside. aten's CUDA backward
# adds the grid gradient with atomicAdd, so its backward here is the port's
# own, on the plane gradient's path with eight corners a point where the
# plane has four: csrc/plane_grad.cu's `dense_grid_corners` (the
# coordinates' gradient per point, the corners' keys and weights), one
# stable sort, and its `plane_grad_sums`.

def _dense_corners(D: int, H: int, W: int, ind: torch.Tensor):
    """The eight corners of each point's trilinear sample, in aten's order
    (tnw, tne, tsw, tse, bnw, bne, bsw, bse: x fastest): cells [8, n] of
    the flattened [D, H, W] grid (clamped onto it), weights [8, n], which
    corners lie on the grid [8, n], and each weight's derivative along x,
    y and z [3, 8, n]. ind [n, 3] holds (x, y, z) in [-1, 1] indexing W,
    H and D."""
    pos, lo, frac = [], [], []
    for a, size in enumerate((W, H, D)):
        p = (ind[:, a] + 1) / 2 * (size - 1)
        f = p.floor()
        pos.append(p)
        lo.append(f)
        frac.append((f + 1 - p, p - f))        # weight of the near, far
    cells, wts, inside, dw = [], [], [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                off = (dx, dy, dz)
                idx = [(lo[a] + off[a]).long() for a in range(3)]
                on = ((idx[0] >= 0) & (idx[0] < W) & (idx[1] >= 0)
                      & (idx[1] < H) & (idx[2] >= 0) & (idx[2] < D))
                w = [frac[a][off[a]] for a in range(3)]
                sign = [1.0 if off[a] else -1.0 for a in range(3)]
                cells.append((idx[2].clamp(0, D - 1) * H
                              + idx[1].clamp(0, H - 1)) * W
                             + idx[0].clamp(0, W - 1))
                wts.append(w[0] * w[1] * w[2])
                inside.append(on)
                dw.append(torch.stack([sign[0] * w[1] * w[2],
                                       sign[1] * w[0] * w[2],
                                       sign[2] * w[0] * w[1]]))
    return (torch.stack(cells), torch.stack(wts), torch.stack(inside),
            torch.stack(dw, 1))


def _dense_coords_grad(grid: torch.Tensor, g: torch.Tensor, corners):
    """d ind [n, 3] of the trilinear sample for the output gradient g
    [n, C]: per point, sum over corners and channels of the corner's value
    (0 off the grid) x its weight's derivative x g, times (size - 1) / 2,
    the align_corners unnormalize's slope. No sum across points."""
    C, D, H, W = grid.shape
    cells, _, inside, dw = corners
    v = grid.reshape(C, -1).T[cells] * inside[..., None]       # [8, n, C]
    gv = (v * g[None]).sum(-1)                                  # [8, n]
    scale = torch.tensor([(W - 1) / 2, (H - 1) / 2, (D - 1) / 2],
                         dtype=g.dtype, device=g.device)
    return (dw * gv[None]).sum(1).T * scale


def dense_grid_keys(grid_shape, ind: torch.Tensor, g: torch.Tensor):
    """The grid gradient's sum as `plane_grad_sums` takes it, as
    `dense_grid_corners` forms it: keys [8 n] (int32) and weights [8 n]
    laid out [8, n], entry e for point e % n. A corner off the grid, and
    every corner of a point whose output gradient is all 0, is keyed past
    the grid (D H W + point): the padded rows of a GaussianState sit at one
    position and would otherwise make one run of millions of entries in
    one cell."""
    C, D, H, W = grid_shape
    n = ind.shape[0]
    cells, wts, inside, _ = _dense_corners(D, H, W, ind)
    live = inside & (g != 0).any(1)[None]
    past = D * H * W + torch.arange(n, device=ind.device)[None]
    keys = torch.where(live, cells, past)
    return keys.reshape(-1).to(torch.int32), wts.reshape(-1).contiguous()


def dense_grid_grad_plain(grid: torch.Tensor, ind: torch.Tensor,
                          g: torch.Tensor):
    """The backward of the trilinear sample in PyTorch: (d grid [C, D, H,
    W], d ind [n, 3]) for the output gradient g [n, C]. The grid gradient
    adds with `index_add_`, one index after another on the CPU."""
    C, D, H, W = grid.shape
    corners = _dense_corners(D, H, W, ind)
    cells, wts, inside, _ = corners
    vals = (wts * inside)[..., None] * g[None]                  # [8, n, C]
    g_grid = torch.zeros(D * H * W, C, dtype=g.dtype, device=g.device)
    g_grid.index_add_(0, cells.reshape(-1), vals.reshape(-1, C))
    return (g_grid.T.reshape(C, D, H, W),
            _dense_coords_grad(grid, g, corners))


def dense_grid_corners(grid: torch.Tensor, ind: torch.Tensor,
                       g: torch.Tensor):
    """csrc/plane_grad.cu's `dense_grid_corners` on CUDA tensors (float32,
    contiguous): (keys [8 n] int32, weights [8 n], d ind [n, 3]), the keys
    and weights those of `dense_grid_keys`."""
    C, D, H, W = grid.shape
    n = ind.shape[0]
    dev = g.device
    keys = torch.empty(8 * n, dtype=torch.int32, device=dev)
    wts = torch.empty(8 * n, dtype=torch.float32, device=dev)
    g_ind = torch.empty((n, 3), dtype=torch.float32, device=dev)
    composite._launch("dense_grid_corners", dev, ind.data_ptr(),
                      grid.data_ptr(), g.data_ptr(), g_ind.data_ptr(),
                      keys.data_ptr(), wts.data_ptr(), n, C, D, H, W)
    return keys, wts, g_ind


def dense_grid_grad(grid: torch.Tensor, ind: torch.Tensor, g: torch.Tensor):
    """The backward of the trilinear sample: (d grid [C, D, H, W], d ind
    [n, 3]) for the output gradient g [n, C], float32, C <= 32. On CUDA
    tensors the kernels of csrc/plane_grad.cu (`dense_grid_corners`, one
    stable sort of its keys, the segmented sums), two identical calls
    bit-equal; on CPU tensors `dense_grid_grad_plain`."""
    if g.device.type == "cpu":
        return dense_grid_grad_plain(grid, ind, g)
    if g.device.type != "cuda":
        raise ValueError(f"dense_grid_grad: no kernel for {g.device}")
    C, D, H, W = grid.shape
    n = ind.shape[0]
    for name, t in (("grid", grid), ("ind", ind), ("g", g)):
        if t.dtype != torch.float32 or t.device != g.device:
            raise ValueError(f"{name} must be float32 on {g.device}")
    grid, ind, g = grid.contiguous(), ind.contiguous(), g.contiguous()
    dev = g.device
    keys, wts, g_ind = dense_grid_corners(grid, ind, g)
    skeys, order = torch.sort(keys, stable=True)
    out = torch.zeros((D * H * W, C), dtype=torch.float32, device=dev)
    partials = torch.empty(2 * C * max(-(-8 * n // CHUNK), 1),
                           dtype=torch.float32, device=dev)
    composite._launch("plane_grad_sums", dev, skeys.data_ptr(),
                      order.data_ptr(), wts.data_ptr(), g.data_ptr(),
                      out.data_ptr(), partials.data_ptr(), 8 * n, n, C,
                      D * H * W)
    dense_grid_grad.launches += 1
    return out.T.reshape(C, D, H, W), g_ind


dense_grid_grad.launches = 0


class _DenseGridSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, ind):
        ctx.save_for_backward(grid, ind)
        out = F.grid_sample(grid[None], ind.reshape(1, 1, 1, -1, 3),
                            mode="bilinear", align_corners=True)
        return out.reshape(grid.shape[0], -1).T

    @staticmethod
    def backward(ctx, g):
        grid, ind = ctx.saved_tensors
        g_grid, g_ind = dense_grid_grad(grid, ind, g)
        return (g_grid if ctx.needs_input_grad[0] else None,
                g_ind if ctx.needs_input_grad[1] else None)


def grid_sample_3d(grid: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """grid: [C, D, H, W]; ind: [n, 3] in [-1, 1], (x, y, z) indexing W, H
    and D. Returns [n, C]: F.grid_sample's trilinear sample (align_corners,
    zeros outside) bit for bit, with a backward that adds no float atomics
    (`dense_grid_grad`)."""
    return _DenseGridSample.apply(grid, ind)
