"""The cell-list render option, JAX vs the port, on the same numpy scene.

- `bin_cells`: the port's ragged candidate lists (emit and sort at cell
  granularity) equal the JAX package's `bin_cells` lists, cell by cell,
  where its band and cell capacities drop nothing.
- The plain cell compositor (what the CUDA kernel is held to on the card)
  against the TPU kernel `composite_cells_pallas` in interpret mode on the
  same rows, and `rasterize` with the option against the JAX package's
  `pallas_cell_composite=True`, with the cutoffs on and off, and against
  the port's own stream path with them on. The TPU kernel resumes a stopped
  pixel at the next chunk; with `cell_capacity` a multiple of 128 and
  `composite_chunk` equal to it a cell's list is one chunk, where its stop
  rule and the port's coincide.

Bounds: rgb, language and alpha 3e-5, depth 3e-4 (the repo's own,
tests/test_pallas_composite.py:81-86).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from langsplat4d.ops import tile_composite as JTC
from langsplat4d.render import raster as JR
from langsplat4d_torch.ops import composite as TC
from langsplat4d_torch.render import raster as TR
from langsplat4d_torch.render import stream as TS
from tests.test_raster import make_camera, random_scene

H, W, N = 64, 80, 120          # 4 x 5 tiles: 2 x 3 cells of 2 x 2 tiles
CELL, KC = 2, 128
BG = np.asarray([0.2, 0.5, 0.8], np.float32)


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _jax_settings(hard_cutoffs=True, **kw):
    return JR.RasterSettings(
        H, W, sh_degree=0, lang_dim=3, tile_capacity=128,
        composite_chunk=KC, bin_tile_chunk=4, composite_tile_chunk=4,
        bin_cell_tiles=CELL, cell_capacity=KC, band_capacity=256,
        hard_cutoffs=hard_cutoffs, **kw)


def _scene(rng):
    means, scales, quats, opac, colors, lang = random_scene(rng, n=N)
    scales[:8] *= 8.0                       # splats spanning several cells
    means[N - 5:, 2] = -6.0                 # behind the camera: culled
    return means, scales, quats, opac, colors, lang


def _prep(arrs, hard_cutoffs=True):
    means, scales, quats, opac, colors, _ = arrs
    prep = JR.preprocess(_jax_settings(hard_cutoffs), make_camera(H, W),
                         jnp.asarray(means), jnp.zeros((N, 2)),
                         jnp.asarray(opac), jnp.asarray(scales),
                         jnp.asarray(quats), None, jnp.asarray(colors))
    return {k: np.array(v) for k, v in prep.items()}


def _torch_settings(hard_cutoffs=True, **kw):
    return TR.RasterSettings(H, W, sh_degree=0, hard_cutoffs=hard_cutoffs,
                             bin_cell_tiles=CELL, **kw)


def _torch_prep(prep):
    return {k: torch.from_numpy(v) for k, v in prep.items()}


def _assert_image_close(got, want, what):
    """[C, ...] channels [rgb, lang, depth, ...]: 3e-5, depth 3e-4."""
    depth = np.zeros(got.shape[0], bool)
    depth[6] = True
    np.testing.assert_allclose(got[~depth], want[~depth], atol=3e-5,
                               err_msg=what)
    np.testing.assert_allclose(got[depth], want[depth], atol=3e-4,
                               err_msg=what + " depth")


@pytest.mark.parametrize("tie_depths", [False, True])
def test_bin_cells_matches_jax_unsaturated(rng, tie_depths):
    prep = _prep(_scene(rng))
    if tie_depths:
        prep["depth"] = np.round(prep["depth"] * 2.0) / 2.0
    js = _jax_settings()
    jprep = {k: jnp.asarray(v) for k, v in prep.items()}
    sat = JR.binning_saturation(js, jprep)
    assert int(sat["band_max_count"]) < 256
    assert float(sat["cell_full_frac"]) == 0.0
    want_e, want_v, _ = (np.asarray(a) for a in JR.bin_cells(js, jprep))

    ts = _torch_settings(cell_composite=True)
    assert (ts.cells_x, ts.cells_y) == (js.cells_x, js.cells_y) == (3, 2)
    src, starts = TS.bin_cells(ts, _torch_prep(prep))
    src, starts = src.numpy(), starts.numpy()
    assert starts.dtype == np.int32 and starts.shape == (7,)
    assert starts[0] == 0 and starts[-1] == len(src)
    lens = np.diff(starts)
    np.testing.assert_array_equal(lens, want_v.sum(1))
    assert lens.max() > 20 and len(src) > prep["visible"].sum()
    for c in range(6):
        np.testing.assert_array_equal(src[starts[c]:starts[c + 1]],
                                      want_e[c][want_v[c]])
    assert not prep["visible"][N - 5:].any()
    assert not np.isin(np.arange(N - 5, N), src).any()


@pytest.mark.parametrize("hard_cutoffs", [True, False])
def test_plain_cells_match_pallas_kernel(rng, hard_cutoffs):
    arrs = _scene(rng)
    prep = _prep(arrs, hard_cutoffs)
    js = _jax_settings(hard_cutoffs)
    jprep = {k: jnp.asarray(v) for k, v in prep.items()}
    entries, valid, _ = JR.bin_cells(js, jprep)
    jrows, c_feat = JTC.pack_cell_rows(jprep, entries, valid,
                                       jnp.asarray(arrs[5]))
    assert jrows.shape == (6, 15, KC) and c_feat == 7
    want = np.asarray(JTC.composite_cells_pallas(
        jrows, jnp.asarray(BG), cells_x=js.cells_x, cell=CELL, g=KC,
        hard_cutoffs=hard_cutoffs))              # [6, 4, 8, 256]

    ts = _torch_settings(hard_cutoffs, cell_composite=True)
    tprep = _torch_prep(prep)
    src, starts = TS.bin_cells(ts, tprep)
    rows = TS.pack_cell_rows(tprep, torch.from_numpy(arrs[5]), src)
    assert rows.shape == (len(src), 16)
    # the rows are the JAX package's, candidate by candidate
    v = np.asarray(valid)
    np.testing.assert_allclose(
        rows.numpy()[:, :15], np.asarray(jrows).swapaxes(1, 2)[v],
        rtol=2e-7, atol=0)
    got = TC.composite_cells(rows, starts, torch.from_numpy(BG),
                             cells_x=ts.cells_x, cell=CELL,
                             hard_cutoffs=hard_cutoffs).numpy()
    assert got.shape == (6, 4, 9, 256)
    assert want[:, :, 7].max() > 0.5                # real coverage
    _assert_image_close(
        np.moveaxis(got[:, :, [0, 1, 2, 3, 4, 5, 6, 8]], 2, 0),
        np.moveaxis(want, 2, 0), "cells")
    assert np.abs(got[:, :, 7]).max() == 0.0        # the padded channel


@pytest.mark.parametrize("hard_cutoffs", [True, False])
def test_rasterize_cells_matches_jax_and_stream(rng, hard_cutoffs):
    arrs = _scene(rng)
    means, scales, quats, opac, colors, lang = arrs
    js = _jax_settings(hard_cutoffs, pallas_cell_composite=True)
    want = JR.rasterize(
        js, make_camera(H, W), jnp.asarray(means), jnp.zeros((N, 2)),
        jnp.asarray(opac), jnp.asarray(scales), jnp.asarray(quats), None,
        jnp.asarray(colors), jnp.asarray(lang), jnp.asarray(BG))

    cam = make_camera(H, W)
    tcam = TR.CameraParams(*[torch.from_numpy(np.array(getattr(cam, f)))
                             for f in ("viewmatrix", "projmatrix", "campos",
                                       "tanfovx", "tanfovy")])
    t = torch.from_numpy
    args = (tcam, t(means), t(opac), t(scales), t(quats), None, t(colors),
            t(lang), t(BG))
    cells = _torch_settings(hard_cutoffs, cell_composite=True)
    got = TR.rasterize(cells, *args)
    stream = TR.rasterize(dataclasses.replace(cells, cell_composite=False),
                          *args)
    assert got[0].shape == (3, H, W) and got[1].shape == (3, H, W)
    assert got[3].shape == (1, H, W)
    for i, (what, tol) in enumerate((("rgb", 3e-5), ("lang", 3e-5),
                                     ("radii", 0.0), ("depth", 3e-4))):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   atol=tol, err_msg=what + " vs jax")
        # the stream's ellipse cull drops the pairs below alpha = 1/255,
        # which blend only with the cutoffs off
        if hard_cutoffs:
            np.testing.assert_allclose(got[i].numpy(), stream[i].numpy(),
                                       atol=tol, err_msg=what + " vs stream")
    assert float(got[0].abs().max()) > 0.5


def test_uncovered_rows_and_empty_cells():
    """One cell of 2 x 2 tiles beside an empty one: a candidate whose rect
    lies outside the cell changes nothing, a tile that no rect covers shows
    the background, and so does every tile of the empty cell."""
    def row(x, y, rect_min, rect_max):
        r = torch.zeros(16)
        r[0], r[1] = x, y
        r[2], r[4] = 0.02, 0.02                  # a wide round Gaussian
        r[5] = np.log(0.8)
        r[6] = rect_min[0] + 256.0 * rect_min[1]
        r[7] = rect_max[0] + 256.0 * rect_max[1]
        r[8:11] = torch.tensor([1.0, 0.5, 0.25])
        return r

    inside = row(8.0, 8.0, (0, 0), (1, 1))       # covers tile (0, 0) only
    outside = row(8.0, 8.0, (5, 5), (6, 6))      # covers no tile here
    bg = torch.from_numpy(BG)
    kw = dict(cells_x=2, cell=2)
    starts = torch.tensor([0, 2, 2], dtype=torch.int32)
    out = TC.composite_cells(torch.stack([outside, inside]), starts, bg,
                             **kw)
    alone = TC.composite_cells(inside[None],
                               torch.tensor([0, 1, 1], dtype=torch.int32),
                               bg, **kw)
    assert out.shape == (2, 4, 9, 256)
    assert torch.equal(out, alone)
    assert float(out[0, 0, 8].max()) > 0.5       # the covered tile
    shows_bg = torch.zeros((9, 256))
    shows_bg[:3] = bg[:, None]
    for c, lt in ((0, 1), (0, 2), (0, 3), (1, 0), (1, 3)):
        assert torch.equal(out[c, lt], shows_bg), (c, lt)
    stats = {}
    TC.composite_cells_plain(torch.stack([outside, inside]), starts, bg,
                             stats=stats, **kw)
    assert stats["rect_tests"] == 8 and stats["pair_pixels"] == 256


def test_cell_settings():
    s = TR.RasterSettings(1014, 1352, cell_composite=True)
    assert (s.tiles_x, s.tiles_y, s.cells_x, s.cells_y) == (85, 64, 11, 8)
    with pytest.raises(ValueError, match="8 bits"):
        TR.RasterSettings(64, 16 * 256, cell_composite=True)
