"""The tile-list compositor and its hand-derived backward, JAX vs the port's
plain versions (what the CUDA kernels are held to on the card), on the same
numpy scene and lists.

The TPU kernels restart a stopped pixel at every g-slot chunk; the port keeps
the CUDA reference's per-pixel stop for good. With one chunk per list
(g = composite_chunk = tile_capacity) the two rules coincide, so the JAX side
runs that way, both its jnp path and its Pallas kernels (interpret mode).

Bounds: forward 3e-5 (the repo's kernel bound,
tests/test_pallas_composite.py:58); gradients rtol 2e-3 / atol 2e-4 (the
repo's gradient bound, tests/test_pallas_composite.py:172-175).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from langsplat4d.ops import tile_composite as JTC
from langsplat4d.render import composite_vjp as JCV
from langsplat4d.render import raster as JR
from langsplat4d_torch.ops import composite as TC
from langsplat4d_torch.render import composite_vjp as TCV
from langsplat4d_torch.render import raster as TR
from tests.test_raster import make_camera, random_scene

H, W, K, N = 32, 48, 32, 60
FWD_TOL = 3e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
BG = np.asarray([0.2, 0.5, 0.7], np.float32)


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _scene(rng, hard_cutoffs):
    """-> (jax settings, packed [N, 13], entries [T, K], valid [T, K]) as
    numpy, from the JAX preprocess and exact top-k lists."""
    settings = JR.RasterSettings(
        H, W, sh_degree=0, lang_dim=3, tile_capacity=K, composite_chunk=K,
        bin_tile_chunk=2, pallas_tile_block=1, two_level_binning=False,
        hard_cutoffs=hard_cutoffs)
    means, scales, quats, opac, colors, lang = random_scene(rng, n=N)
    scales[:4] *= 6.0
    prep = JR.preprocess(settings, make_camera(H, W), jnp.asarray(means),
                         jnp.zeros((N, 2)), jnp.asarray(opac),
                         jnp.asarray(scales), jnp.asarray(quats), None,
                         jnp.asarray(colors))
    entries, valid = JR.bin_tiles(settings, prep)
    packed = jnp.concatenate(
        [prep["point_image"], prep["conic"], prep["opacity"][:, None],
         prep["colors"], jnp.asarray(lang), prep["depth"][:, None]], axis=1)
    counts = np.asarray(valid.sum(1))
    assert counts.min() < K and counts.max() > K // 2   # ragged lists
    return settings, np.array(packed), np.array(entries), np.array(valid)


def _torch_rows(packed, entries, valid):
    rows, counts = TCV.kernel_rows(torch.from_numpy(packed),
                                   torch.from_numpy(entries).long(),
                                   torch.from_numpy(valid))
    assert rows.shape == (entries.shape[0], K, 16)   # 15 columns padded
    return rows, counts


@pytest.mark.parametrize("hard_cutoffs", [True, False])
def test_plain_forward_matches_pallas_and_jnp(rng, hard_cutoffs):
    settings, packed, entries, valid = _scene(rng, hard_cutoffs)
    rows, counts = _torch_rows(packed, entries, valid)
    got = TC.composite_tiles(rows, counts, torch.from_numpy(BG),
                             tiles_x=settings.tiles_x,
                             hard_cutoffs=hard_cutoffs).numpy()
    assert got.shape == (settings.num_tiles, 9, 256)
    assert got[:, 8].max() > 0.5                      # real coverage

    # the TPU kernel on the same rows, K on its lanes: [T, PW, K]
    pal = JTC.composite_tiles_pallas(
        jnp.asarray(rows.numpy().swapaxes(1, 2)), jnp.asarray(BG),
        tiles_x=settings.tiles_x, tb=1, g=K, hard_cutoffs=hard_cutoffs,
        counts=jnp.asarray(counts.numpy()))
    np.testing.assert_allclose(got, np.asarray(pal), atol=FWD_TOL)

    # the jnp scan, which has no padded feature channel
    ref = np.asarray(JCV.composite_forward(
        settings, jnp.asarray(packed), jnp.asarray(entries),
        jnp.asarray(valid), jnp.asarray(BG)))
    np.testing.assert_allclose(got[:, [0, 1, 2, 3, 4, 5, 6, 8]], ref,
                               atol=FWD_TOL)
    assert np.abs(got[:, 7]).max() == 0.0


@pytest.mark.parametrize("hard_cutoffs", [True, False])
def test_plain_backward_matches_pallas_rows(rng, hard_cutoffs):
    settings, packed, entries, valid = _scene(rng, hard_cutoffs)
    rows, counts = _torch_rows(packed, entries, valid)
    kw = dict(tiles_x=settings.tiles_x, hard_cutoffs=hard_cutoffs)
    accum = TC.composite_tiles(rows, counts, torch.from_numpy(BG), **kw)
    g_out = rng.normal(size=accum.shape).astype(np.float32)
    total = (accum.numpy() * g_out).sum(1)
    got = TC.composite_tiles_backward(rows, counts, torch.from_numpy(g_out),
                                      torch.from_numpy(total), **kw).numpy()
    want = JTC.composite_backward_pallas(
        jnp.asarray(rows.numpy().swapaxes(1, 2)), jnp.asarray(counts.numpy()),
        jnp.asarray(g_out), jnp.asarray(total), tiles_x=settings.tiles_x,
        tb=1, g=K, hard_cutoffs=hard_cutoffs)
    want = np.asarray(want).swapaxes(1, 2)                  # [T, K, PW]
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, **GRAD_TOL)
    # nothing beyond the walked slots
    beyond = ~valid
    assert np.abs(got[beyond]).max() == 0.0


@pytest.mark.parametrize("hard_cutoffs", [True, False])
def test_composite_cv_grads_match_jax_vjp(rng, hard_cutoffs):
    settings, packed, entries, valid = _scene(rng, hard_cutoffs)
    tgt = rng.normal(size=(settings.num_tiles, 8, 256)).astype(np.float32)

    out, vjp = jax.vjp(
        lambda p, b: JCV.composite_cv(settings, p, jnp.asarray(entries),
                                      jnp.asarray(valid), b),
        jnp.asarray(packed), jnp.asarray(BG))
    want_p, want_bg = vjp(jnp.asarray(tgt))

    ts = TR.RasterSettings(H, W, tile_capacity=K, analytic_vjp=True,
                           hard_cutoffs=hard_cutoffs)
    tp = torch.from_numpy(packed).requires_grad_(True)
    tbg = torch.from_numpy(BG.copy()).requires_grad_(True)
    accum = TCV.composite_cv(ts, tp, torch.from_numpy(entries).long(),
                             torch.from_numpy(valid), tbg)
    np.testing.assert_allclose(accum.detach().numpy(), np.asarray(out),
                               atol=FWD_TOL)
    accum.backward(torch.from_numpy(tgt))
    assert np.abs(np.asarray(want_p)).max() > 1.0
    got_p, want_p = tp.grad.numpy(), np.asarray(want_p)
    if hard_cutoffs:
        np.testing.assert_allclose(got_p, want_p, **GRAD_TOL)
    else:
        # With the cutoffs off a Gaussian is listed in tiles far from its
        # centre (the 3-sigma square, no 1/255 test), where the conic
        # gradient is chained from the coefficient sums as a difference of
        # terms ~|mx my d0|, 10^3 times the result at mx, my of tens of
        # pixels. float32 keeps ~1e-7 of the largest term, and the port sums
        # over pixels in another order than the jnp einsum, so the three
        # conic columns get atol 1e-3 here; every other column keeps the
        # repo's bound.
        conic = [2, 3, 4]
        rest = [c for c in range(got_p.shape[1]) if c not in conic]
        np.testing.assert_allclose(got_p[:, rest], want_p[:, rest],
                                   **GRAD_TOL)
        np.testing.assert_allclose(got_p[:, conic], want_p[:, conic],
                                   rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(tbg.grad.numpy(), np.asarray(want_bg),
                               **GRAD_TOL)


def test_composite_cv_finite_differences(rng):
    """Directional derivatives of sum(accum * tgt) by central differences,
    cutoffs off (they are steps a difference cannot cross). float32 through
    and through, so the bound is loose: 2% of the derivative plus 0.05."""
    settings, packed, entries, valid = _scene(rng, False)
    ts = TR.RasterSettings(H, W, tile_capacity=K, analytic_vjp=True,
                           hard_cutoffs=False)
    tgt = torch.from_numpy(
        rng.normal(size=(settings.num_tiles, 8, 256)).astype(np.float32))
    e, v = torch.from_numpy(entries).long(), torch.from_numpy(valid)
    bg = torch.from_numpy(BG)

    def loss(p):
        return (TCV.composite_cv(ts, p, e, v, bg).double()
                * tgt.double()).sum()

    tp = torch.from_numpy(packed).requires_grad_(True)
    grad, = torch.autograd.grad(loss(tp), tp)
    # one direction per differentiable column group, scaled to the column
    scale = np.abs(packed).mean(0, keepdims=True) + 1e-3
    for cols in ([0, 1], [2, 3, 4], [5], list(range(6, 13))):
        d = np.zeros_like(packed)
        d[:, cols] = (rng.normal(size=(N, len(cols))) * scale[:, cols])
        d = torch.from_numpy(d.astype(np.float32))
        eps = 2e-3
        with torch.no_grad():
            fd = (loss(tp + eps * d) - loss(tp - eps * d)) / (2 * eps)
        an = (grad.double() * d.double()).sum()
        assert abs(float(an)) > 0.1, cols
        assert abs(float(fd - an)) <= 0.02 * abs(float(an)) + 0.05, (
            cols, float(fd), float(an))
