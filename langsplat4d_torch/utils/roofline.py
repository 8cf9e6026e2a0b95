"""Operations and bytes roofline of the render frame and the training step
on one H100 (port of langsplat4d/utils/roofline.py).

For each stage of a frame or a step the model counts the float32
operations and the device-memory bytes the stage needs, and bounds its time
below by the larger of the bytes over the memory rate and the operations
over the float32 rate. `frame_report` sets measured stage times against
those bounds and gives the whole frame's float32 utilisation.

Peaks: the published figures of one H100 SXM at its full 700 W, HBM3 at
3.35e12 bytes/s and float32 outside the tensor cores at 67e12 operations/s.
The port runs float32 with TF32 off for matrix products too, so a matrix
product's operations count at the float32 rate as well (`mm_flops`, the JAX
module's MXU operations, and `ew_flops`, its vector ones, share one peak).

The JAX module also bounds stages by sort, gather and chunk ceilings that
were measured on its TPU; those are not this card's, so there are none
here: every stage is bounded by its bytes and operations alone, and a
stage's bound reads the same work whatever implements it. The model counts
the dominant terms only; its job is to rank stages by their distance from
the bound, not to predict times.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# Published peaks of one H100 SXM at its full 700 W: HBM bytes/s and float32
# operations/s outside the tensor cores (the compositors are float32 vector
# code with one expf per pair).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

ALPHA_OPS = 20   # one evaluated (Gaussian, pixel) pair: the power chain
                 # (5 fma = 10), + ln_op, expf (counted as 8), min
EMIT_OPS = 40    # one emitted (Gaussian, tile) slot: rect walk and key
                 # (the JAX module's count)
KEY_BYTES = 8    # one sort key, int64: the tile above the depth rank
                 # (render/stream.py `_sort_bins`); the sort carries no value
INDEX_BYTES = 8  # one int64 gather index (the depth order)
FLOAT_BYTES = 4


def forward_ops(evaluated, live, c):
    """float32 operations the forward needs for `evaluated` (Gaussian,
    pixel) pairs of which `live` are blended: every evaluated pair its alpha
    (ALPHA_OPS); a live one besides 1 - alpha, T * (1 - alpha), alpha * T,
    the alpha sum (4) and the c feature fmas (2c). A pair skipped by
    power > 0 or alpha < 1/255 needs none of the latter."""
    return evaluated * ALPHA_OPS + live * (4 + 2 * c)


def backward_ops(evaluated, live, c):
    """The backward's: every evaluated pair its alpha; a live one besides
    1 - alpha and T * (1 - alpha) (2), phi (2c + 1), alpha * T, prefix, S,
    d_alpha, da (9), five basis products, the 6 + c sums over pixels (one
    add per pair each) and the c products w * g_c."""
    return evaluated * ALPHA_OPS + live * (2 + (2 * c + 1) + 9 + 5
                                           + (6 + c) + c)


def bound(n_bytes, n_ops):
    """The least time in ms the card could take: the larger of the bytes
    over the memory rate and the operations over the float32 rate. ->
    (ms, "bytes" or "operations", both times as text)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    parts = (f"{n_bytes / 1e6:.1f} MB in {t_bytes:.4f} ms, "
             f"{n_ops / 1e9:.3f} G operations in {t_ops:.4f} ms")
    return ((t_bytes, "bytes", parts) if t_bytes >= t_ops
            else (t_ops, "operations", parts))


@dataclass
class StageModel:
    name: str
    mm_flops: float = 0.0    # matrix-product operations (float32, TF32 off)
    ew_flops: float = 0.0    # elementwise operations
    hbm_bytes: float = 0.0
    notes: str = ""

    @property
    def ops(self) -> float:
        return self.mm_flops + self.ew_flops

    def bound_s(self) -> Tuple[float, str]:
        """Lower bound of the stage's time in seconds and what binds it,
        "bytes" or "operations"."""
        ms, by, _ = bound(self.hbm_bytes, self.ops)
        return ms * 1e-3, by


def deform_flops(n: int, *, out_dim: int = 16, n_scales: int = 2,
                 net_width: int = 128, defor_depth: int = 0,
                 lang_dim: int = 3, sh_coeffs: int = 48,
                 grid_cached: bool = True) -> StageModel:
    """The fine-stage deformation of `n` Gaussians: 3 time-plane bilinear
    samples per scale and the trunk and head MLPs (reference
    scene/deformation.py:103-182). The operations and the state bytes are
    the JAX module's; the time-plane taps, which it charges against a
    measured TPU gather rate, are charged as the bytes they read: 4 taps of
    `out_dim` floats per plane and scale. With `grid_cached` off (the
    training step) the spatial planes are sampled too; their taps are not
    charged, as the JAX module charges none, which leaves the bound a lower
    bound."""
    feat = out_dim * n_scales
    ew = n * 3 * n_scales * out_dim * 8          # bilerp + product fold
    head_out = 3 + 3 + 4 + 1 + sh_coeffs + lang_dim
    mm = 2.0 * n * (feat * net_width
                    + defor_depth * net_width * net_width
                    + net_width * (net_width + head_out))
    state_bytes = n * 4.0 * head_out * 2         # read and write the state
    tap_bytes = n * 3 * n_scales * 4 * out_dim * FLOAT_BYTES
    return StageModel("deform", mm_flops=mm, ew_flops=ew,
                      hbm_bytes=state_bytes + tap_bytes,
                      notes="time-plane taps + head MLPs"
                            + ("" if grid_cached else ", planes uncached"))


def preprocess_model(n: int, sh_coeffs: int = 48) -> StageModel:
    """Projection, covariance and SH of `n` Gaussians (render/raster.py
    preprocess): ~500 elementwise operations a Gaussian, its attributes read
    and its screen-space rows written."""
    return StageModel("preprocess", ew_flops=n * 500.0,
                      hbm_bytes=n * 4.0 * (14 + sh_coeffs + 16),
                      notes="elementwise chains; no matrix products")


def emit_sort_model(emitted: float) -> StageModel:
    """The stream build's emission and sort of `emitted` (Gaussian, tile)
    slots (render/stream.py `sorted_pairs`): EMIT_OPS a slot; each int64
    key written once, then read and written once by the sort, the least any
    sort must move."""
    return StageModel("emit+sort", ew_flops=emitted * float(EMIT_OPS),
                      hbm_bytes=emitted * KEY_BYTES * 3.0,
                      notes=f"{emitted / 1e6:.2f}M slots, one int64 key each")


def gather_model(valid: float, n: int, row_width: int) -> StageModel:
    """The row gather of the stream build (render/stream.py `gather_rows`):
    the `valid` rows of `row_width` floats it gathers and writes and their
    int64 keys, plus the attribute table of `n` rows it reads and its depth
    order."""
    row = row_width * FLOAT_BYTES
    return StageModel("gather",
                      hbm_bytes=valid * (row + KEY_BYTES)
                      + n * (row + INDEX_BYTES),
                      notes=f"{valid / 1e6:.2f}M rows of {row_width}")


def _image_channels(row_width: int) -> int:
    # the accumulator's channels: a row's features (row_width less its 8
    # header columns) and the alpha sum
    return row_width - 7


def composite_model(evaluated: float, live: float, c: int, rows: float,
                    row_width: int, pixels: float) -> StageModel:
    """A compositor's forward: `forward_ops` of its `evaluated` (Gaussian,
    pixel) pairs of which `live` blend, for `c` feature channels (the counts
    `ops/composite.py`'s plain versions report with `stats=`), plus the
    `rows` it reads and the image of `pixels` it writes."""
    return StageModel(
        "composite", ew_flops=float(forward_ops(evaluated, live, c)),
        hbm_bytes=(rows * row_width + pixels * _image_channels(row_width))
        * FLOAT_BYTES,
        notes=f"{evaluated / 1e6:.1f}M pair-pixels, {live / 1e6:.1f}M live")


def composite_backward_model(evaluated: float, live: float, c: int,
                             rows: float, row_width: int,
                             pixels: float) -> StageModel:
    """A compositor's backward: `backward_ops` of its pairs, plus the rows
    it reads and their gradient rows it writes, and the image's cotangent
    and per-pixel totals it reads."""
    return StageModel(
        "composite-bwd", ew_flops=float(backward_ops(evaluated, live, c)),
        hbm_bytes=(2.0 * rows * row_width
                   + pixels * (_image_channels(row_width) + 1)) * FLOAT_BYTES,
        notes=f"{evaluated / 1e6:.1f}M pair-pixels, {live / 1e6:.1f}M live")


def train_step_model(n: int, forward_pairs: float, backward_pairs: float,
                     live: float, c: int, rows: float, row_width: int,
                     pixels: float, **deform_kw) -> List[StageModel]:
    """The list training step: the uncached deformation, preprocess, the
    list kernels' forward and backward (their evaluated pairs counted
    apart: the forward's tile test drops rows that the backward walks) and
    Adam with the scatter-add over 62 floats a Gaussian, the parameter and
    both moments read and written (the JAX module's count). `deform_kw`
    goes to `deform_flops`."""
    return [deform_flops(n, grid_cached=False, **deform_kw),
            preprocess_model(n, deform_kw.get("sh_coeffs", 48)),
            composite_model(forward_pairs, live, c, rows, row_width, pixels),
            composite_backward_model(backward_pairs, live, c, rows,
                                     row_width, pixels),
            StageModel("adam+scatter", ew_flops=n * 62 * 10.0,
                       hbm_bytes=n * 62 * 4.0 * 4,
                       notes="param + 2 moments rw")]


def frame_report(stages: List[StageModel],
                 measured_ms: Optional[Dict[str, float]] = None,
                 frame_ms: Optional[float] = None) -> Dict:
    """The roofline report: a row per stage with its bound and what binds
    it, its operations and bytes, and where `measured_ms` names the stage,
    its measured time and that time over the bound; then the total
    operations and, given the whole frame's (or step's) time `frame_ms`,
    the achieved rate and `mfu_fp32`, the modelled operations over that
    time over the float32 peak. A measured time below its bound means the
    model counts work the stage does not do: that raises, naming the
    stage."""
    rows = []
    total = 0.0
    for s in stages:
        bound_s, by = s.bound_s()
        row = {"stage": s.name, "bound_ms": bound_s * 1e3, "bound_by": by,
               "notes": s.notes, "mm_gflops": s.mm_flops / 1e9,
               "ew_gflops": s.ew_flops / 1e9, "hbm_mb": s.hbm_bytes / 1e6}
        if measured_ms and s.name in measured_ms:
            m = float(measured_ms[s.name])
            if m < bound_s * 1e3:
                raise ValueError(
                    f"stage {s.name}: measured {m} ms is below its bound "
                    f"{bound_s * 1e3} ms ({by}): the model counts work the "
                    f"stage does not do")
            row["measured_ms"] = m
            row["x_from_roofline"] = (m / (bound_s * 1e3) if bound_s > 0
                                      else None)
        total += s.ops
        rows.append(row)
    rep = {"stages": rows, "total_gflops": total / 1e9}
    if frame_ms:
        rate = total / (frame_ms * 1e-3)
        rep["frame_ms"] = frame_ms
        rep["achieved_tflops"] = rate / 1e12
        rep["mfu_fp32"] = rate / PEAK_F32_OPS_PER_S
    return rep
