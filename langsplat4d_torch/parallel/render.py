"""Rendering by tile-row bands over the gauss axis (port of
langsplat4d/parallel/render.py).

Each rank holds a block of the Gaussian rows and owns a band of
ceil(tiles_y / gauss) tile rows of the image (the last band may be short,
or empty). A frame:
1. the deformation and the preprocess on the rank's own rows;
2. one of two exchanges (`LS4D_BAND_EXCHANGE` selects it in the driver):
   - "allgather" (`render_tiles_sharded`): one all-gather of the
     preprocess outputs and features, then each rank emits and sorts its
     band's (Gaussian, tile) pairs over all the rows;
   - "alltoall" (`render_tiles_scatter`): one all-gather of depth and
     visibility for global depth ranks, emission and sort of the rank's own
     rows over all tiles, one all-to-all of the per-band slot counts and
     one of the slots' keys and rows with uneven splits, and the owner's
     sort of what it received;
3. kernel 3 (`composite_stream` with `tile_row0`) on the band.

The band is bit-equal to the same rows of the single-rank render: its
segments are the whole build's segments, slot for slot (the key order is
total), and the kernel blends in the image's pixel coordinates. The JAX
package shifts pix_y into the band's frame instead, a reassociated
subtraction of up to 5e-7. Nothing is dropped: the all-to-all is sized by
the counts it exchanges first, where the JAX package's buckets have a
static size and an overflow audit; `dropped` stays in the return value and
is 0. The int64 `tile << 32 | rank` key has room for any N and tile count,
so the JAX package's limits (N <= 2^18, padded tiles < 2^14) and its quiet
switch from the all-to-all to the all-gather exchange are gone.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from langsplat4d_torch.ops.composite import composite_stream
from langsplat4d_torch.parallel.mesh import Mesh, gather_columns
from langsplat4d_torch.render.pipeline import prepare_attributes
from langsplat4d_torch.render.raster import preprocess
from langsplat4d_torch.render.stream import (RANK_BITS, build_stream,
                                             pack_attribute_table,
                                             sorted_slots)

EXCHANGES = ("allgather", "alltoall")


def band_of(settings, mesh: Mesh) -> Tuple[int, int, int]:
    """(first tile row, tile rows, pixel rows in the image) of this rank's
    band."""
    band_rows = -(-settings.tiles_y // mesh.gauss)
    ty0 = mesh.gauss_rank * band_rows
    ts = settings.tile_size
    height = max(0, min(band_rows * ts, settings.image_height - ty0 * ts))
    return ty0, band_rows, height


def _preprocess(settings, cam, means3d, opacities, scales, rotations, colors,
                active, shs):
    return preprocess(settings, cam, means3d, opacities, scales, rotations,
                      shs, None if shs is not None else colors,
                      active=active)


def _composite_band(settings, rows, starts, bg, mesh):
    ty0, band_rows, height = band_of(settings, mesh)
    return composite_stream(
        rows, starts, bg, tiles_x=settings.tiles_x, tiles_y=band_rows,
        tile_size=settings.tile_size, height=height,
        width=settings.image_width, hard_cutoffs=settings.hard_cutoffs,
        tile_row0=ty0)


def _mark(timer, name):
    if timer is not None:
        timer(name)


def render_tiles_sharded(settings, cam, means3d, opacities, scales,
                         rotations, colors, features, active, bg,
                         mesh: Mesh, *, shs=None, stats: Optional[dict] = None,
                         timer: Optional[Callable[[str], None]] = None
                         ) -> torch.Tensor:
    """The all-gather exchange. Inputs are this rank's rows (`shs` [n, K, 3]
    evaluated here, else `colors` [n, 3]); -> this rank's band of the image
    [c_out, band height, W], c_out the composite's channel stack (rgb,
    features, depth, padding, alpha). `stats["bytes"]` gets the bytes this
    rank sends; `timer(stage)` is called after each stage."""
    prep = _preprocess(settings, cam, means3d, opacities, scales, rotations,
                       colors, active, shs)
    _mark(timer, "preprocess")
    cols = gather_columns(dict(prep, features=features), mesh)
    if stats is not None:
        stats["bytes"] = (stats.get("bytes", 0) + means3d.shape[0]
                          * (mesh.gauss - 1) * 4
                          * sum(v[0].numel() for v in cols.values()))
    _mark(timer, "exchange")
    ty0, band_rows, _ = band_of(settings, mesh)
    rows, starts = build_stream(settings, cols, cols["features"],
                                tile_band=(ty0, band_rows))
    _mark(timer, "emit+sort+gather")
    img = _composite_band(settings, rows, starts, bg, mesh)
    _mark(timer, "composite")
    return img


def render_tiles_scatter(settings, cam, means3d, opacities, scales,
                         rotations, colors, features, active, bg,
                         mesh: Mesh, *, shs=None, stats: Optional[dict] = None,
                         timer: Optional[Callable[[str], None]] = None
                         ) -> Tuple[torch.Tensor, int]:
    """The all-to-all exchange (arguments and result as
    `render_tiles_sharded`): -> (this rank's band, dropped slots, 0)."""
    n_loc = means3d.shape[0]
    prep = _preprocess(settings, cam, means3d, opacities, scales, rotations,
                       colors, active, shs)
    _mark(timer, "preprocess")
    # global depth ranks, as the one-rank build ranks the whole row set:
    # the visible by depth, equal depths by row, the invisible last
    dv = mesh.all_gather(torch.stack([prep["depth"],
                                      prep["visible"].float()], 1))
    dorder = torch.argsort(torch.where(dv[:, 1] > 0.5, dv[:, 0],
                                       float("inf")), stable=True)
    rank_all = torch.empty_like(dorder)
    rank_all[dorder] = torch.arange(dorder.numel(), device=dorder.device)
    off = mesh.gauss_rank * n_loc
    _mark(timer, "ranks")
    keys, _, gid = sorted_slots(settings, prep, rank_all[off:off + n_loc])
    # the stream is sorted by tile, so band j's slots are one run
    _, band_rows, _ = band_of(settings, mesh)
    band_tiles = band_rows * settings.tiles_x
    first = torch.clamp(torch.arange(mesh.gauss + 1, device=keys.device)
                        * band_tiles, max=settings.num_tiles)
    bounds = torch.searchsorted(keys, first << RANK_BITS)
    send = bounds[1:] - bounds[:-1]
    recv = mesh.all_to_all(send, [1] * mesh.gauss, [1] * mesh.gauss)
    n_send = int(bounds[-1])
    rows_out = pack_attribute_table(prep, features)[gid[:n_send]]
    _mark(timer, "emit+sort")
    send, recv = send.tolist(), recv.tolist()
    keys_in = mesh.all_to_all(keys[:n_send], send, recv)
    rows_in = mesh.all_to_all(rows_out, send, recv)
    if stats is not None:
        mine = send[mesh.gauss_rank]
        stats["bytes"] = (stats.get("bytes", 0)
                          + dv.shape[1] * 4 * n_loc * (mesh.gauss - 1)
                          + 8 * mesh.gauss * (mesh.gauss - 1)
                          + (n_send - mine) * (8 + 4 * rows_out.shape[1]))
    _mark(timer, "exchange")
    # the owner's merge: the keys are unique, so one sort restores the
    # one-rank build's order
    k_sorted, order = torch.sort(keys_in)
    rows = rows_in[order]
    t0 = mesh.gauss_rank * band_tiles
    starts = torch.searchsorted(
        k_sorted, (t0 + torch.arange(band_tiles + 1, device=keys.device))
        << RANK_BITS).to(torch.int32)
    _mark(timer, "merge")
    img = _composite_band(settings, rows, starts, bg, mesh)
    _mark(timer, "composite")
    return img, 0


def render_frame_banded(settings, dcfg, stage: str, cam, time, gs, net,
                        aabb, bg, mesh: Mesh, *, nonormalized: bool = False,
                        grid_spatial=None, exchange: str = "allgather",
                        stats: Optional[dict] = None,
                        timer: Optional[Callable[[str], None]] = None
                        ) -> Dict[str, Optional[torch.Tensor]]:
    """A frame on the mesh: the deformation of this rank's rows (`gs`, a
    `shard_gaussians` block, with `grid_spatial` the spatial-plane cache of
    those rows), then the band build and composite by `exchange`. Returns
    this rank's band of render [3, h, W], language_feature_image [L, h, W]
    (None in base stages), depth [1, h, W], and `dropped` (0)."""
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange {exchange!r} not in {EXCHANGES}")
    (means3d, scales_act, rotations_act, opacity_act, shs, lang,
     _coff) = prepare_attributes(dcfg, stage, time, gs, net, aabb,
                                 nonormalized=nonormalized,
                                 grid_spatial=grid_spatial)
    _mark(timer, "deform")
    feats = (lang if settings.include_feature
             else lang.new_zeros((gs.capacity, 0)))
    args = (settings, cam, means3d, opacity_act, scales_act, rotations_act,
            None, feats, gs.active_mask(), bg, mesh)
    if exchange == "alltoall":
        img, dropped = render_tiles_scatter(*args, shs=shs, stats=stats,
                                            timer=timer)
    else:
        img, dropped = render_tiles_sharded(*args, shs=shs, stats=stats,
                                            timer=timer), 0
    c_lang = feats.shape[1]
    return {
        "render": img[:3],
        "language_feature_image": (img[3:3 + c_lang]
                                   if settings.include_feature else None),
        "depth": img[3 + c_lang:4 + c_lang],
        "dropped": dropped,
    }


def gather_bands(band: torch.Tensor, settings, mesh: Mesh) -> torch.Tensor:
    """Every rank's band [C, h, W] stitched to the image [C, H, W] (a
    collective of the gauss axis; every rank gets the image)."""
    if mesh.gauss == 1:
        return band
    _, band_rows, height = band_of(settings, mesh)
    rows = band_rows * settings.tile_size
    padded = torch.nn.functional.pad(band, (0, 0, 0, rows - height))
    whole = mesh.all_gather(padded.permute(1, 0, 2).contiguous())
    return whole[:settings.image_height].permute(1, 0, 2).contiguous()
