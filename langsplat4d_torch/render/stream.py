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


def _depth_order(prep: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back order: (dorder [N] the Gaussians by depth, rank [N]
    each Gaussian's place in it). Invisible Gaussians sort last and never
    emit; Gaussians of equal depth keep their index order (the sort is
    stable), as the JAX package's top-k takes the lower index first."""
    n = prep["depth"].shape[0]
    dorder = torch.argsort(torch.where(prep["visible"], prep["depth"],
                                       float("inf")), stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=dorder.device)
    rank[dorder] = torch.arange(n, device=dorder.device)
    return dorder, rank


def _emit(rmin: torch.Tensor, rmax: torch.Tensor, visible: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One slot per bin of every visible Gaussian's rect [rmin, rmax) (int64
    [N, 2], in tiles or in cells): (gid, bx, by), each [M], Gaussian by
    Gaussian and row-major within a rect. The emitted count M is read on the
    host (the one sync): it sizes the buffers."""
    n = rmin.shape[0]
    dev = rmin.device
    span_x = rmax[:, 0] - rmin[:, 0]
    count = torch.where(visible, span_x * (rmax[:, 1] - rmin[:, 1]), 0)
    end = torch.cumsum(count, 0)
    total = int(end[-1]) if n else 0
    gid = torch.repeat_interleave(torch.arange(n, device=dev), count,
                                  output_size=total)
    off = torch.arange(total, device=dev) - (end - count)[gid]
    sx = span_x[gid]
    return gid, rmin[gid, 0] + off % sx, rmin[gid, 1] + off // sx


def _sort_bins(bin_id: torch.Tensor, rank: torch.Tensor, num_bins: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort the slots by (bin, depth rank). -> (keys [M] int64 sorted,
    starts [num_bins + 1] int32); slots of bin `num_bins` (culled) sort past
    the last segment."""
    keys, _ = torch.sort((bin_id << RANK_BITS) | rank)
    bounds = torch.arange(num_bins + 1, device=keys.device) << RANK_BITS
    return keys, torch.searchsorted(keys, bounds).to(torch.int32)


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
    """
    ts = settings.tile_size
    num_tiles = settings.num_tiles
    dorder, rank = _depth_order(prep)
    gid, tx, ty = _emit(prep["rect_min"].long(), prep["rect_max"].long(),
                        prep["visible"])
    tile = ty * settings.tiles_x + tx
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
    keys, starts = _sort_bins(tile, rank[gid], num_tiles)
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


def build_stream_train(settings, prep: Dict[str, torch.Tensor],
                       ellipse_cull: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stream of the training path (the port of the JAX package's
    `build_stream_train`). -> (src [B] int64, the Gaussian of every slot of
    the (tile, depth)-sorted stream, starts [T+1] int32): tile t's segment
    is src[starts[t]:starts[t+1]], front to back, starts[T] = B. The caller
    gathers its differentiable rows by `src`; no gradient flows through the
    build.

    The stream is dense: the JAX build aligns every segment to a chunk and
    names each chunk's tile because its kernels' grid is sequential, and
    sizes tiers and a slot budget because XLA needs static shapes; here
    nothing can overflow and no slot is padding. Unlike `bin_tiles` it
    keeps the ellipse cull, so the stream holds only the pairs that can
    reach a pixel. Reading B costs the build a second host sync."""
    prep = {k: prep[k].detach() for k in
            ("depth", "visible", "rect_min", "rect_max", "conic",
             "point_image", "opacity")}
    keys, starts, dorder = sorted_pairs(settings, prep, ellipse_cull)
    n_slots = int(starts[-1]) if ellipse_cull else keys.numel()
    return dorder[keys[:n_slots] & RANK_MASK], starts


def bin_cells(settings, prep: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth-ordered candidate lists per cell of `settings.bin_cell_tiles`^2
    tiles (the port of the JAX package's `bin_cells`, by the same emit and
    sort as the tile stream, at cell granularity). -> (src [M] int64,
    cell_starts [n_cells + 1] int32): the candidates of cell c are
    src[cell_starts[c]:cell_starts[c+1]], every visible Gaussian whose tile
    rect touches the cell, front to back, equal depths by lower index. The
    lists have no capacity: they equal the JAX lists wherever its
    `band_capacity` and `cell_capacity` drop nothing."""
    cell = settings.bin_cell_tiles
    visible = prep["visible"].detach()
    dorder, rank = _depth_order({"depth": prep["depth"].detach(),
                                 "visible": visible})
    cmin = prep["rect_min"].detach().long() // cell
    cmax = (prep["rect_max"].detach().long() + (cell - 1)) // cell
    gid, cx, cy = _emit(cmin, cmax, visible)
    keys, cell_starts = _sort_bins(cy * settings.cells_x + cx, rank[gid],
                                   settings.cells_x * settings.cells_y)
    return dorder[keys & RANK_MASK], cell_starts


def pack_cell_rows(prep: Dict[str, torch.Tensor], features: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """The cell kernel's rows [M, PW] (the JAX package's `pack_cell_rows`,
    row-major): the attribute table's row of every candidate, with the
    Gaussian's tile rect in the two spare header columns, 6 = min_x +
    256 min_y and 7 = max_x + 256 max_y (floats; exact while the tile grid
    has fewer than 256 tiles a side, which `RasterSettings` checks)."""
    table = pack_attribute_table(prep, features)
    table[:, 6] = prep["rect_min"][:, 0] + 256.0 * prep["rect_min"][:, 1]
    table[:, 7] = prep["rect_max"][:, 0] + 256.0 * prep["rect_max"][:, 1]
    return table[src]
