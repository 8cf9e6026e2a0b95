"""Per-tile lists, JAX `bin_tiles` vs the port's (cut from the sorted
stream), on the same preprocess output. Lists must be equal exactly: the
valid masks everywhere, the entries where valid (JAX leaves arbitrary
indices in invalid slots).

- exact top-k (`two_level_binning=False`): unsaturated, and with K small
  enough that most lists are full;
- the default two-level cascade, compared only where `binning_saturation`
  reports nothing full, as its extra capacities can truncate too;
- equal depths come out in index order, as JAX's top-k takes the lower index
  first.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplat4d.render import raster as JR
from langsplat4d_torch.render import raster as TR
from tests.test_raster import make_camera, random_scene

H, W, N = 64, 80, 120


def _prep(rng, n=N, big=8):
    means, scales, quats, opac, colors, _ = random_scene(rng, n=n)
    scales[:big] *= 10.0                     # splats spanning many tiles
    means[n - 5:, 2] = -6.0                  # behind the camera: culled
    settings = JR.RasterSettings(H, W, sh_degree=0, lang_dim=3)
    prep = JR.preprocess(settings, make_camera(H, W), jnp.asarray(means),
                         jnp.zeros((n, 2)), jnp.asarray(opac),
                         jnp.asarray(scales), jnp.asarray(quats), None,
                         jnp.asarray(colors))
    return {k: np.array(v) for k, v in prep.items()}


def _both(prep, k, **jax_kw):
    js = JR.RasterSettings(H, W, sh_degree=0, lang_dim=3, tile_capacity=k,
                           bin_tile_chunk=4, **jax_kw)
    jprep = {key: jnp.asarray(v) for key, v in prep.items()}
    want_e, want_v = (np.asarray(a) for a in JR.bin_tiles(js, jprep))
    ts = TR.RasterSettings(H, W, tile_capacity=k, analytic_vjp=True)
    got_e, got_v = TR.bin_tiles(ts, {key: torch.from_numpy(v)
                                     for key, v in prep.items()})
    return js, jprep, want_e, want_v, got_e.numpy(), got_v.numpy()


def _assert_lists_equal(want_e, want_v, got_e, got_v):
    assert got_e.shape == want_e.shape == got_v.shape
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_e[want_v], want_e[want_v])
    # front-compacted: a valid slot is never preceded by an invalid one
    assert not (got_v[:, 1:] & ~got_v[:, :-1]).any()
    # invalid slots hold in-range indices spread over the Gaussians (their
    # zero gradient rows are scatter-added too, and must not pile on one)
    filler = got_e[~got_v]
    assert filler.min() >= 0 and filler.max() < N
    assert np.bincount(filler, minlength=N).max() <= -(-got_e.size // N)


@pytest.mark.parametrize("k,saturated", [(64, False), (4, True)])
def test_lists_match_exact_topk(rng, k, saturated):
    prep = _prep(rng)
    _, _, want_e, want_v, got_e, got_v = _both(prep, k,
                                               two_level_binning=False)
    assert want_v.any()
    full = want_v[:, -1].mean()
    assert (full >= 0.5) if saturated else (full == 0.0)
    _assert_lists_equal(want_e, want_v, got_e, got_v)


def test_lists_match_default_cascade_unsaturated(rng):
    prep = _prep(rng)
    js, jprep, want_e, want_v, got_e, got_v = _both(
        prep, 64, bin_cell_tiles=2, cell_capacity=256, band_capacity=256,
        tile_row_capacity=128)
    sat = JR.binning_saturation(js, jprep)
    assert int(sat["band_max_count"]) < 256
    assert float(sat["cell_full_frac"]) == 0.0
    assert float(sat["tile_full_frac"]) == 0.0
    _assert_lists_equal(want_e, want_v, got_e, got_v)


def test_equal_depths_keep_index_order(rng):
    prep = _prep(rng)
    # quantise depth: many Gaussians share a depth, within tiles too
    prep["depth"] = np.round(prep["depth"] * 2.0) / 2.0
    assert len(np.unique(prep["depth"][prep["visible"]])) < 12
    _, _, want_e, want_v, got_e, got_v = _both(prep, 64,
                                               two_level_binning=False)
    _assert_lists_equal(want_e, want_v, got_e, got_v)
    d = prep["depth"][got_e]
    tie = got_v[:, 1:] & (d[:, 1:] == d[:, :-1])
    assert tie.sum() > 20
    assert (got_e[:, 1:][tie] > got_e[:, :-1][tie]).all()
