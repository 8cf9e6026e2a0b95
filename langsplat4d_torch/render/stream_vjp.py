"""Stream-layout compositing with a hand-derived backward, for the training
path that never truncates (port of langsplat4d/render/stream_vjp.py:
`_stream_rows`, `composite_stream_train`, `_fwd`, `_bwd`).

The tile-list path (render/composite_vjp.py) pays for padded lists of a
fixed capacity and drops a tile's farthest Gaussians once its list is full.
Here every (Gaussian, tile) pair that survives the ellipse cull owns one
slot of the (tile, depth)-sorted stream (render/stream.py
`build_stream_train`): work and memory follow the pairs, and nothing is
dropped. One differentiable gather `table[src]` feeds the kernels, and its
backward is one scatter-add of the backward kernel's per-slot gradient rows,
which carry d_op (not d_ln_op) and so land on the packed layout directly.
The forward saves the rows and accum only; T_fin and the per-pixel total
come from accum. The mathematics is composite_vjp.py's; forward and backward
are `composite_stream_chunks` and `composite_stream_chunks_backward` of
ops/composite.py.
"""
from __future__ import annotations

import torch

from langsplat4d_torch.ops import composite as ops
from langsplat4d_torch.render.composite_vjp import (drop_padding,
                                                    kernel_table,
                                                    pad_cotangent,
                                                    scatter_rows)


def stream_rows(packed: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """packed [N, 6 + C], src [B] -> the stream's kernel rows [B, PW]
    (`kernel_table` gathered by slot). Every slot is a real pair: there is
    no invalid-slot sentinel."""
    return kernel_table(packed)[src]


class StreamCV(torch.autograd.Function):
    """accum [T, C + 1, px] = composite(packed [N, 6 + C], src [B], starts
    [T + 1], bg [3]); differentiable in `packed` and `bg`."""

    @staticmethod
    def forward(ctx, packed, src, starts, bg, tiles_x, tile_size,
                hard_cutoffs):
        rows = stream_rows(packed, src)
        kw = dict(tiles_x=tiles_x, tile_size=tile_size,
                  hard_cutoffs=hard_cutoffs)
        accum = ops.composite_stream_chunks(rows, starts, bg, **kw)
        ctx.save_for_backward(packed, src, starts, rows, accum)
        ctx.kw = kw
        return drop_padding(accum, packed.shape[1] - 6)

    @staticmethod
    def backward(ctx, g_out):
        packed, src, starts, rows, accum = ctx.saved_tensors
        c_pad = accum.shape[1] - 1
        g_full = pad_cotangent(g_out, c_pad)
        # the alpha channel accumulates sum w = 1 - T_fin
        t_fin = 1.0 - accum[:, c_pad]
        total = torch.sum(accum * g_full, dim=1)              # [T, px]
        d_rows = ops.composite_stream_chunks_backward(
            rows, starts, g_full, total, **ctx.kw)            # [B, PW]
        d_bg = torch.sum(t_fin[:, None, :] * g_out[:, :3], dim=(0, 2))
        return (scatter_rows(d_rows, src, packed), None, None, d_bg, None,
                None, None)


def composite_stream_train(settings, packed, src, starts, bg):
    """`StreamCV` with the tile grid and cutoffs of `settings`."""
    return StreamCV.apply(packed, src, starts, bg, settings.tiles_x,
                          settings.tile_size, settings.hard_cutoffs)
