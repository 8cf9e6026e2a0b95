"""The port's roofline (langsplat4d_torch/utils/roofline.py) against the JAX
package's module (langsplat4d/utils/roofline.py, which imports no jax) and
against hand reckoning, on the CPU:

- the deformation, preprocess and Adam stages count the JAX module's
  operations and state bytes exactly, for the bench's widths, the
  HyperNeRF preset's and a narrow set; the port's deformation adds the
  time-plane taps' bytes, which the JAX module charges against a TPU gather
  rate instead;
- the compositor stages charge the pairs that `composite_stream_plain(...,
  stats=)` counts on a 64x80 stream from a seed;
- `bound`, a stage's bound and `mfu_fp32` equal hand reckoning;
- a measured time below its bound raises, naming the stage.
"""
import os

import numpy as np
import pytest
import torch

from langsplat4d.utils import roofline as jr
from langsplat4d_torch.config import load_py_config
from langsplat4d_torch.ops.composite import composite_stream_plain
from langsplat4d_torch.utils import roofline as r

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hypernerf_widths():
    hidden = load_py_config(os.path.join(
        REPO, "configs", "hypernerf", "default.py"))["ModelHiddenParams"]
    return dict(out_dim=hidden["kplanes_config"]["output_coordinate_dim"],
                n_scales=len(hidden["multires"]),
                net_width=hidden["net_width"],
                defor_depth=hidden["defor_depth"], lang_dim=6, sh_coeffs=48)


CASES = {
    # the bench frame: 200k Gaussians, the Neu3D-preset deformation
    "bench": (200_000, dict(out_dim=16, n_scales=2, net_width=128,
                            defor_depth=0, lang_dim=3, sh_coeffs=48)),
    # configs/hypernerf/default.py at scripts/train_eval.sh's lang width 6
    "hypernerf": (100_000, _hypernerf_widths()),
    "narrow": (1000, dict(out_dim=8, n_scales=1, net_width=16,
                          defor_depth=2, lang_dim=9, sh_coeffs=3,
                          grid_cached=False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stage_counts_equal_the_jax_module(case):
    n, kw = CASES[case]
    got, want = r.deform_flops(n, **kw), jr.deform_flops(n, **kw)
    assert got.mm_flops + got.ew_flops == want.mxu_flops + want.vpu_flops
    assert (got.mm_flops, got.ew_flops) == (want.mxu_flops, want.vpu_flops)
    taps = n * 3 * kw["n_scales"] * 4 * kw["out_dim"] * 4
    assert got.hbm_bytes - taps == want.hbm_bytes
    sh = kw["sh_coeffs"]
    got, want = r.preprocess_model(n, sh), jr.preprocess_model(n, sh)
    assert (got.mm_flops, got.ew_flops) == (want.mxu_flops, want.vpu_flops)
    assert got.hbm_bytes == want.hbm_bytes
    step = r.train_step_model(n, 1e6, 2e6, 5e5, 7, 1e4, 16, 5e5, **{
        k: v for k, v in kw.items() if k != "grid_cached"})
    assert [s.name for s in step] == ["deform", "preprocess", "composite",
                                      "composite-bwd", "adam+scatter"]
    got, want = step[-1], jr.train_step_model(n, 100, 128, 256, 8)[-1]
    assert want.name == got.name
    assert got.mm_flops + got.ew_flops == want.mxu_flops + want.vpu_flops
    assert got.hbm_bytes == want.hbm_bytes
    assert step[0].ops == r.deform_flops(n, **kw).ops


def _stream(seed=0, tiles_x=5, tiles_y=4, ts=16, pw=16):
    """A (tile, depth)-ordered stream over a 64x80 image: 0-60 Gaussians a
    tile around the tile, PSD conics, opacities in [0.3, 0.99] (so that
    pixels saturate and stop)."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 61, tiles_x * tiles_y)
    seg[3] = 0
    tile = np.repeat(np.arange(seg.size), seg)
    m = int(seg.sum())
    cx = (tile % tiles_x) * ts + rng.uniform(-6, ts + 6, m)
    cy = (tile // tiles_x) * ts + rng.uniform(-6, ts + 6, m)
    sa, sb = rng.uniform(2.0, 8.0, m), rng.uniform(2.0, 8.0, m)
    th = rng.uniform(0, np.pi, m)
    c, s = np.cos(th), np.sin(th)
    cxx = c * c * sa * sa + s * s * sb * sb + 0.3
    cyy = s * s * sa * sa + c * c * sb * sb + 0.3
    cxy = c * s * (sa * sa - sb * sb)
    det = cxx * cyy - cxy * cxy
    rows = np.zeros((m, pw), np.float32)
    rows[:, 0], rows[:, 1] = cx, cy
    rows[:, 2], rows[:, 3], rows[:, 4] = cyy / det, -cxy / det, cxx / det
    rows[:, 5] = np.log(rng.uniform(0.3, 0.99, m))
    rows[:, 8:15] = rng.uniform(size=(m, 7))
    starts = np.concatenate([[0], np.cumsum(seg)]).astype(np.int32)
    return torch.from_numpy(rows), torch.from_numpy(starts), seg


def test_composite_charges_the_plain_pairs():
    rows, starts, seg = _stream()
    h, w, pw, c = 64, 80, 16, 7
    kw = dict(tiles_x=5, tiles_y=4, tile_size=16, height=h, width=w)
    counted = {}
    for hard in (False, True):
        stats = {}
        composite_stream_plain(rows, starts, torch.zeros(3), stats=stats,
                               hard_cutoffs=hard, **kw)
        counted[hard] = stats
    # no cutoffs: every pixel of a tile evaluates every row of its segment
    assert counted[False]["pair_pixels"] == int(seg.sum()) * 256
    ev, live = (counted[True][k] for k in ("pair_pixels",
                                           "live_pair_pixels"))
    assert 0 < live < ev < counted[False]["pair_pixels"]
    m = rows.shape[0]
    fwd = r.composite_model(ev, live, c, m, pw, h * w)
    assert fwd.ew_flops == ev * 20 + live * (4 + 2 * c)
    assert fwd.mm_flops == 0
    assert fwd.hbm_bytes == (m * pw + h * w * 9) * 4
    bwd = r.composite_backward_model(ev, live, c, m, pw, h * w)
    assert bwd.ew_flops == ev * 20 + live * (2 + 2 * c + 1 + 9 + 5 + 6 + 2 * c)
    assert bwd.hbm_bytes == (2 * m * pw + h * w * 10) * 4


def test_bound_and_mfu_by_hand():
    ms, by, _ = r.bound(6.7e9, 67e9)              # 2 ms of bytes, 1 of ops
    assert by == "bytes" and ms == pytest.approx(2.0, rel=1e-12)
    ms, by, _ = r.bound(3.35e9, 134e9)
    assert by == "operations" and ms == pytest.approx(2.0, rel=1e-12)
    s, by = r.StageModel("x", mm_flops=67e9, ew_flops=67e9,
                         hbm_bytes=3.35e9).bound_s()
    assert by == "operations" and s == pytest.approx(2e-3, rel=1e-12)
    rep = r.frame_report([r.StageModel("a", ew_flops=67e9),
                          r.StageModel("b", hbm_bytes=6.7e9)],
                         {"a": 3.0}, frame_ms=4.0)
    a, b = rep["stages"]
    assert a["bound_ms"] == pytest.approx(1.0, rel=1e-12)
    assert a["x_from_roofline"] == pytest.approx(3.0, rel=1e-12)
    assert (b["bound_by"], "measured_ms" in b) == ("bytes", False)
    assert rep["total_gflops"] == pytest.approx(67.0, rel=1e-12)
    # 67e9 operations in 4 ms: 16.75 TFLOP/s, a quarter of 67e12
    assert rep["achieved_tflops"] == pytest.approx(16.75, rel=1e-12)
    assert rep["mfu_fp32"] == pytest.approx(0.25, rel=1e-12)


def test_measured_below_bound_raises():
    stages = [r.StageModel("deform", ew_flops=67e9),
              r.preprocess_model(1000)]
    with pytest.raises(ValueError, match="stage deform: measured 0.5 ms is "
                       "below its bound"):
        r.frame_report(stages, {"deform": 0.5, "preprocess": 1.0})
