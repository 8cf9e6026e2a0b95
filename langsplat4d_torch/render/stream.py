"""Stream binning: exact duplicate-and-sort tile assignment (port of
langsplat4d/render/stream.py).

Every visible Gaussian emits one (tile, depth-rank) pair per tile of its
rect, as the CUDA reference's duplicateWithKeys does: a per-Gaussian tile
count, a prefix sum, `repeat_interleave`, then one sort. There are no span
tiers, no budget and no wide-key switch: those existed because XLA needs
static shapes. The one host sync is the emitted count, which sizes the
duplicate buffers (the CUDA reference makes the same sync).

Keys are int64 `tile << 32 | depth_rank`: lex order on (tile, rank) is
(tile, depth) order, the rank bits index a depth-ordered attribute table
directly, and both fields have 32 bits of room.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

PW = 16  # packed row width: 8 header columns + rgb, lang, depth, padding
HDR = 8  # header columns before the feature block

RANK_BITS = 32
RANK_MASK = (1 << RANK_BITS) - 1


def row_width(n_feat: int) -> int:
    """Packed row width for `n_feat` feature columns (rgb + lang + depth):
    at least PW, rounded up to a multiple of 8."""
    return max(PW, -(-(HDR + n_feat) // 8) * 8)


def pack_attribute_table(prep: Dict[str, torch.Tensor],
                         features: torch.Tensor) -> torch.Tensor:
    """[N, PW] packed per-Gaussian rows: [pix_x, pix_y, conic0..2, ln_op, 0,
    0, r, g, b, feat_0..L-1, depth, 0...] (the JAX package's row layout)."""
    n = prep["depth"].shape[0]
    ln_op = torch.log(torch.clamp(prep["opacity"], min=1e-30))
    cols = torch.cat([
        prep["point_image"], prep["conic"], ln_op[:, None],
        prep["depth"].new_zeros((n, 2)), prep["colors"], features,
        prep["depth"][:, None]], dim=1)
    pw = row_width(cols.shape[1] - HDR)
    return torch.nn.functional.pad(cols, (0, pw - cols.shape[1]))


def tile_min_quad(A, B, C, cx, cy, x0, x1, y0, y1):
    """Min over the pixel rect [x0, x1] x [y0, y1] of the conic quadratic
    A(x-cx)^2 + 2B(x-cx)(y-cy) + C(y-cy)^2: 0 when the centre is inside,
    else the least of the four clamped edge minima (exact for PSD conics)."""
    inside = (cx >= x0) & (cx <= x1) & (cy >= y0) & (cy <= y1)

    def edge_x(xe):
        dx = xe - cx
        ys = cy - B * dx / torch.clamp(C, min=1e-12)
        dy = torch.minimum(torch.maximum(ys, y0), y1) - cy
        return A * dx * dx + 2 * B * dx * dy + C * dy * dy

    def edge_y(ye):
        dy = ye - cy
        xs = cx - B * dy / torch.clamp(A, min=1e-12)
        dx = torch.minimum(torch.maximum(xs, x0), x1) - cx
        return A * dx * dx + 2 * B * dx * dy + C * dy * dy

    m = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)),
                      torch.minimum(edge_y(y0), edge_y(y1)))
    return torch.where(inside, 0.0, m)


def sorted_pairs(settings, prep: Dict[str, torch.Tensor],
                 ellipse_cull: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Emit and sort. -> (keys [M] int64 sorted, starts [T+1] int32,
    dorder [N] int64).

    With `ellipse_cull`, rect slots whose tile lies wholly outside the
    alpha >= 1/255 ellipse (min of the conic quadratic over the tile's
    pixels > 2 ln(255 op)) are culled: the compositor would give them zero
    weight anyway. Culled slots get the key `num_tiles << 32` and sort past
    the last segment, so the valid pairs are keys[:starts[-1]].

    Gaussians of equal depth keep their index order (the depth sort is
    stable), as the JAX package's top-k takes the lower index first.
    """
    ts = settings.tile_size
    tiles_x = settings.tiles_x
    num_tiles = settings.num_tiles
    dev = prep["depth"].device
    n = prep["depth"].shape[0]

    # front-to-back order; invisible Gaussians sort last and never emit
    dorder = torch.argsort(torch.where(prep["visible"], prep["depth"],
                                       float("inf")), stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[dorder] = torch.arange(n, device=dev)

    rmin = prep["rect_min"].long()
    rmax = prep["rect_max"].long()
    span_x = rmax[:, 0] - rmin[:, 0]
    count = torch.where(prep["visible"], span_x * (rmax[:, 1] - rmin[:, 1]),
                        0)
    end = torch.cumsum(count, 0)
    total = int(end[-1]) if n else 0          # the one host sync
    gid = torch.repeat_interleave(torch.arange(n, device=dev), count,
                                  output_size=total)
    off = torch.arange(total, device=dev) - (end - count)[gid]
    sx = span_x[gid]
    tx = rmin[gid, 0] + off % sx
    ty = rmin[gid, 1] + off // sx

    tile = ty * tiles_x + tx
    if ellipse_cull:
        conic = prep["conic"][gid]
        pix = prep["point_image"][gid]
        t2 = 2.0 * torch.log(torch.clamp(255.0 * prep["opacity"], min=1.0))
        txf = tx.float()
        tyf = ty.float()
        q = tile_min_quad(conic[:, 0], conic[:, 1], conic[:, 2],
                          pix[:, 0], pix[:, 1],
                          txf * float(ts), txf * float(ts) + (ts - 1.0),
                          tyf * float(ts), tyf * float(ts) + (ts - 1.0))
        tile = torch.where(q <= t2[gid], tile, num_tiles)
    keys, _ = torch.sort((tile << RANK_BITS) | rank[gid])
    bounds = torch.arange(num_tiles + 1, device=dev) << RANK_BITS
    starts = torch.searchsorted(keys, bounds).to(torch.int32)
    return keys, starts, dorder


def gather_rows(table: torch.Tensor, keys: torch.Tensor,
                dorder: torch.Tensor) -> torch.Tensor:
    """Row-major [M, PW] stream rows: the rank bits of each key index the
    depth-ordered table."""
    return table[dorder][keys & RANK_MASK]


def build_stream(settings, prep: Dict[str, torch.Tensor],
                 features: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (rows [M, PW] f32, starts [T+1] int32). Tile t's segment is
    rows[starts[t]:starts[t+1]], front to back; culled pairs lie past
    starts[-1]."""
    keys, starts, dorder = sorted_pairs(settings, prep)
    rows = gather_rows(pack_attribute_table(prep, features), keys, dorder)
    return rows, starts


def bin_tiles(settings, prep: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile front-to-back lists for the training path, cut from the
    sorted stream (the port of the JAX package's `bin_tiles`, whose top-k
    cascade exists only because XLA needs static shapes). -> (entries [T, K]
    int64 indices into the Gaussian arrays, valid [T, K] bool), K =
    settings.tile_capacity: the first K Gaussians whose rect covers the tile,
    in depth order, equal depths by lower index; no ellipse cull, as
    `bin_tiles` has none. No gradient flows through the lists.

    An invalid slot holds its own slot number modulo N, not one fixed index:
    its gradient row is zero, but the backward scatter-adds every row, and
    three quarters of a million zero rows aimed at one Gaussian serialise the
    atomic adds (1.76 ms against 0.19 ms for the full-width scatter-add on
    an H100)."""
    prep = {k: prep[k].detach() for k in
            ("depth", "visible", "rect_min", "rect_max")}
    keys, starts, dorder = sorted_pairs(settings, prep, ellipse_cull=False)
    k = settings.tile_capacity
    n = dorder.shape[0]
    col = torch.arange(k, device=keys.device)
    slot = starts[:-1].long()[:, None] + col
    valid = slot < starts[1:].long()[:, None]
    filler = (torch.arange(settings.num_tiles, device=keys.device)[:, None]
              * k + col) % n
    if keys.numel() == 0:
        return filler, valid
    rank = keys[torch.clamp(slot, max=keys.numel() - 1)] & RANK_MASK
    return torch.where(valid, dorder[rank], filler), valid
