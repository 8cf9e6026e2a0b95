"""Stream binning and compositing, JAX vs the port.

- The port's exact emission gives the same sorted (tile, depth-rank) pairs
  and segment starts as the JAX narrow build's valid prefix, exactly, when
  the JAX span tiers clip nothing.
- The plain compositor matches the TPU kernel `composite_stream_pallas`
  (interpret mode, stitched) at atol 3e-5, the repo's kernel bound
  (tests/test_pallas_composite.py:58,126).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from langsplat4d.ops.tile_composite import composite_stream_pallas
from langsplat4d.render import raster as JR
from langsplat4d.render import stream as JS
from langsplat4d_torch.ops.composite import composite_stream_plain
from langsplat4d_torch.render import raster as TR
from langsplat4d_torch.render import stream as TS
from tests.test_raster import make_camera, random_scene

H, W = 64, 80      # 80 = 2x32 + 16: a ragged column at 32-px tiles


def _scene_prep(rng, tile_size, hard_cutoffs=True):
    """JAX preprocess of a random scene with big splats (tiers 2 and 3);
    returns (jax settings, prep as numpy, lang features)."""
    n = 160
    means, scales, quats, opac, colors, lang = random_scene(rng, n=n)
    scales[:6] *= 12.0
    scales[:2] *= 4.0
    settings = JR.RasterSettings(H, W, sh_degree=0, lang_dim=3,
                                 tile_size=tile_size,
                                 hard_cutoffs=hard_cutoffs)
    prep = JR.preprocess(settings, make_camera(H, W), jnp.asarray(means),
                         jnp.zeros((n, 2)), jnp.asarray(opac),
                         jnp.asarray(scales), jnp.asarray(quats), None,
                         jnp.asarray(colors))
    return settings, {k: np.asarray(v) for k, v in prep.items()}, lang


def _torch_prep(prep):
    return {k: torch.from_numpy(v) for k, v in prep.items()}


@pytest.mark.parametrize("tile_size", [16, 32])
def test_exact_emission_matches_jax_pairs(rng, tile_size):
    settings, prep, _ = _scene_prep(rng, tile_size)
    vis = prep["visible"]
    spans = np.maximum(prep["rect_max"] - prep["rect_min"], 0).max(1)[vis]
    tiers = JS.autotune_tiers(spans)
    jprep = {k: jnp.asarray(v) for k, v in prep.items()}
    ov = JS.stream_overflow(settings, jprep, tiers=tiers)
    assert int(ov["span_exceeded"]) == 0
    for i, (_, cap) in enumerate(tiers):
        assert int(ov[f"tier{i + 2}_needed"]) <= cap
    assert spans.max() > 2                      # the big splats need tiers

    n = prep["depth"].shape[0]
    k_sorted, _, n_valid, _ = JS._narrow_sorted_pairs(
        settings, jprep, jnp.arange(n, dtype=jnp.int32), tiers=tiers,
        ellipse_cull=True, carry_src=False)
    k = np.asarray(k_sorted)[: int(n_valid)].astype(np.int64)
    j_tile, j_rank = k >> JS.RANK_BITS, k & (JS.RANK_CAP - 1)
    j_starts = np.searchsorted(j_tile, np.arange(settings.num_tiles + 1))

    keys, starts, _ = TS.sorted_pairs(
        TR.RasterSettings(H, W, tile_size=tile_size), _torch_prep(prep))
    t_valid = keys[: int(starts[-1])].numpy()
    assert len(t_valid) == int(n_valid) > 0
    np.testing.assert_array_equal(t_valid >> TS.RANK_BITS, j_tile)
    np.testing.assert_array_equal(t_valid & TS.RANK_MASK, j_rank)
    np.testing.assert_array_equal(starts.numpy(), j_starts)


@pytest.mark.parametrize("tile_size,hard_cutoffs",
                         [(16, True), (16, False), (32, True), (32, False)])
def test_plain_composite_matches_pallas_kernel(rng, tile_size,
                                               hard_cutoffs):
    _, prep, lang = _scene_prep(rng, tile_size, hard_cutoffs)
    settings = TR.RasterSettings(H, W, tile_size=tile_size,
                                 hard_cutoffs=hard_cutoffs)
    rows, starts = TS.build_stream(settings, _torch_prep(prep),
                                      torch.from_numpy(lang))
    bg = np.asarray([0.3, 0.6, 0.9], np.float32)
    got = composite_stream_plain(
        rows, starts, torch.from_numpy(bg), tiles_x=settings.tiles_x,
        tiles_y=settings.tiles_y, tile_size=tile_size, height=H, width=W,
        hard_cutoffs=hard_cutoffs).numpy()

    # The TPU kernel resets a pixel's T < 1e-4 stop at every g-slot chunk
    # boundary of the stream (its transmittance is a per-chunk cumprod);
    # one chunk spanning the whole stream gives the CUDA reference's
    # per-pixel stop, which the port implements.
    m = rows.shape[0]
    g = -(-m // 128) * 128
    with pltpu.force_tpu_interpret_mode():
        out = composite_stream_pallas(
            jnp.asarray(rows.numpy().T), jnp.asarray(starts.numpy()),
            jnp.asarray(bg), tiles_x=settings.tiles_x,
            num_tiles=settings.num_tiles, tile_size=tile_size, g=g,
            hard_cutoffs=hard_cutoffs)
    c_out, ts = out.shape[1], tile_size
    want = np.asarray(out)[: settings.num_tiles].reshape(
        settings.tiles_y, settings.tiles_x, c_out, ts, ts).transpose(
        2, 0, 3, 1, 4).reshape(c_out, settings.tiles_y * ts,
                               settings.tiles_x * ts)[:, :H, :W]
    assert got.shape == want.shape == (9, H, W)
    assert want[8].max() > 0.5                  # real coverage
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_pack_attribute_table_matches_jax(rng):
    _, prep, lang = _scene_prep(rng, 16)
    want = JS.pack_attribute_table({k: jnp.asarray(v) for k, v in
                                    prep.items()}, jnp.asarray(lang))
    got = TS.pack_attribute_table(_torch_prep(prep), torch.from_numpy(lang))
    # equal but for ln_op, where the two libraries' log may differ by an ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7,
                               atol=0)
