"""Tile-list compositing with a hand-derived backward, for the training path
(port of langsplat4d/render/composite_vjp.py: `composite_cv`, `_cv_fwd`,
`_cv_bwd`, `_kernel_rows`, `composite_backward_pallas_path`).

    out_c   = sum_i w_i f_{i,c} + T_K bg_c,   w_i = a_i T_i,
    T_{i+1} = T_i (1 - a_i)

    dL/df_{i,c} = w_i g_c
    dL/da_i     = T_i phi_i - S_i / (1 - a_i)
      phi_i = sum_c f_{i,c} g_c + g_alpha
      S_i   = sum_{k>i} w_k phi_k + T_K beta,  beta = sum_c bg_c g_c

S_i needs no second pass: total = <out, g> per pixel comes from the saved
output, and S_i = total - prefix_i(w phi) from the backward's own
front-to-back walk. Forward and backward are the kernels of ops/composite.py;
what surrounds them here (packing the rows, the per-pixel total, the
scatter-add of the gradient rows to the Gaussians) is plain PyTorch.
"""
from __future__ import annotations

import torch

from langsplat4d_torch.ops import composite as ops
from langsplat4d_torch.ops.composite import HDR
from langsplat4d_torch.render.stream import row_width


def kernel_table(packed: torch.Tensor) -> torch.Tensor:
    """packed [N, 6 + C] = [pix(2), conic(3), opacity, feats(C)] -> the
    Gaussians in the kernels' row layout [N, PW] = [pix, conic, ln_op, 0, 0,
    feats, 0..], ln_op = ln(max(opacity, 1e-30))."""
    n, c_all = packed.shape[0], packed.shape[1] - 6
    pw = row_width(c_all)
    ln_op = torch.log(torch.clamp(packed[:, 5:6], min=1e-30))
    return torch.cat([packed[:, :5], ln_op, packed.new_zeros((n, 2)),
                      packed[:, 6:],
                      packed.new_zeros((n, pw - HDR - c_all))], dim=1)


def kernel_rows(packed: torch.Tensor, entries: torch.Tensor,
                valid: torch.Tensor):
    """Gather the per-tile kernel rows. packed [N, 6 + C], entries/valid
    [T, K] -> (rows [T, K, PW] of `kernel_table` with ln_op = -1e30 in
    invalid slots, counts [T] int32)."""
    rows = kernel_table(packed)[entries]
    rows[:, :, 5] = torch.where(valid, rows[:, :, 5], -1e30)
    return rows, valid.sum(dim=1, dtype=torch.int32)


def drop_padding(accum: torch.Tensor, c_all: int) -> torch.Tensor:
    """The kernel's accum [T, PW - 8 + 1, px] without the padded feature
    channels: [T, c_all + 1, px], alpha last."""
    c_pad = accum.shape[1] - 1
    if c_pad == c_all:
        return accum
    return torch.cat([accum[:, :c_all], accum[:, c_pad:]], dim=1)


def pad_cotangent(g_out: torch.Tensor, c_pad: int) -> torch.Tensor:
    """The cotangent of `drop_padding`'s result as the kernel wants it:
    [T, c_pad + 1, px], zero in the padded feature channels."""
    c_all = g_out.shape[1] - 1
    return torch.cat([g_out[:, :c_all],
                      g_out.new_zeros((g_out.shape[0], c_pad - c_all,
                                       g_out.shape[2])),
                      g_out[:, c_all:]], dim=1).contiguous()


def scatter_rows(d_rows: torch.Tensor, entries: torch.Tensor,
                 packed: torch.Tensor) -> torch.Tensor:
    """Scatter-add the gradient rows [..., PW] (one per list slot [T, K] or
    per stream slot [B]) to the Gaussians `entries` names: the gradient of
    `packed` [N, 6 + C]. Rows of invalid slots are zero, so their index does
    not matter."""
    c_all = packed.shape[1] - 6
    flat = d_rows.reshape(-1, d_rows.shape[-1])
    d_sel = torch.cat([flat[:, :6], flat[:, HDR:HDR + c_all]], dim=1)
    return torch.zeros_like(packed).index_add_(0, entries.reshape(-1), d_sel)


class CompositeCV(torch.autograd.Function):
    """accum [T, C + 1, px] = composite(packed [N, 6 + C], entries [T, K],
    valid [T, K], bg [3]); differentiable in `packed` and `bg`."""

    @staticmethod
    def forward(ctx, packed, entries, valid, bg, tiles_x, tile_size,
                hard_cutoffs):
        rows, counts = kernel_rows(packed, entries, valid)
        kw = dict(tiles_x=tiles_x, tile_size=tile_size,
                  hard_cutoffs=hard_cutoffs)
        accum = ops.composite_tiles(rows, counts, bg, **kw)
        ctx.save_for_backward(packed, entries, rows, counts, accum)
        ctx.kw = kw
        return drop_padding(accum, packed.shape[1] - 6)

    @staticmethod
    def backward(ctx, g_out):
        packed, entries, rows, counts, accum = ctx.saved_tensors
        c_pad = accum.shape[1] - 1
        g_full = pad_cotangent(g_out, c_pad)
        # the alpha channel accumulates sum w = 1 - T_fin
        t_fin = 1.0 - accum[:, c_pad]
        total = torch.sum(accum * g_full, dim=1)              # [T, px]
        d_rows = ops.composite_tiles_backward(rows, counts, g_full, total,
                                              **ctx.kw)       # [T, K, PW]
        d_bg = torch.sum(t_fin[:, None, :] * g_out[:, :3], dim=(0, 2))
        return (scatter_rows(d_rows, entries, packed), None, None, d_bg,
                None, None, None)


def composite_cv(settings, packed, entries, valid, bg):
    """`CompositeCV` with the tile grid and cutoffs of `settings`."""
    return CompositeCV.apply(packed, entries, valid, bg, settings.tiles_x,
                             settings.tile_size, settings.hard_cutoffs)
