"""Densification, port against the JAX package, row for row: a JAX
TrainState after two JAX training steps on the micro scene (so the gradient
statistics, radii and Adam moments are real), carried over with
`train_state_from_jax`, then each of the nine functions of train/densify.py
on both, with thresholds set so that clone, split and prune all select rows:
every parameter and Adam moment, num_active, max_radii2d,
xyz_gradient_accum, denom, deformation_table and deformation_accum within
1e-6 (exact where integer or boolean). The split's normal draws are JAX's,
fed to the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplat4d.config import Config as JConfig
from langsplat4d.data.scene import Scene as JScene
from langsplat4d.train import densify as JD
from langsplat4d.train import loop as jloop
from langsplat4d.utils.timer import Timer as JTimer
from langsplat4d_torch.field.deformation import DeformConfig
from langsplat4d_torch.interop import train_state_from_jax
from langsplat4d_torch.train import densify as TD
from tests.scene_fixture import make_structured_scene

GAUSS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
         "language_feature")
BUFFERS = ("max_radii2d", "xyz_gradient_accum", "denom",
           "deformation_table", "deformation_accum")


def _cfg(root, model):
    cfg = JConfig()
    cfg.model.source_path = root
    cfg.model.model_path = model
    cfg.optim.max_points = 700
    cfg.optim.densify_from_iter = 10_000
    cfg.optim.batch_size = 2
    cfg.runtime.capacity_granule = 256
    cfg.runtime.tile_capacity = 128
    cfg.runtime.prefetch_depth = 0
    cfg.extras.test_iterations = []
    cfg.extras.save_iterations = []
    cfg.hidden.kplanes_config = {
        "grid_dimensions": 2, "input_coordinate_dim": 4,
        "output_coordinate_dim": 4, "resolution": [8, 8, 8, 4]}
    cfg.hidden.multires = [1]
    cfg.hidden.net_width = 16
    return cfg


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(JAX state after two coarse-base steps, the port's DeformConfig,
    the scene extent, a numpy generator)."""
    root = tmp_path_factory.mktemp("densify")
    scene_dir = str(root / "scene")
    make_structured_scene(scene_dir, n_imgs=8, hw=32, clip_dim=3,
                          n_obj_points=200, n_bg_points=300)
    cfg = _cfg(scene_dir, str(root / "model"))
    scene = JScene(scene_dir)
    state, jd = jloop.init_state_from_scene(cfg, scene, seed=0)
    state = jloop.scene_reconstruction(cfg, scene, state, jd, "coarse-base",
                                       False, 2, JTimer())
    dcfg = DeformConfig.from_config(cfg.hidden, cfg.runtime)
    assert float(jnp.max(state.denom)) > 0
    return state, dcfg, scene.cameras_extent


def _port(jstate, dcfg):
    return train_state_from_jax(jax.device_get(jstate), dcfg, device="cpu")


def _same(t, j, tol=1e-6):
    """The port's state `t` against the JAX state `j`, row for row."""
    assert t.num_active == int(j.num_active)
    assert t.capacity == j.capacity
    for k in GAUSS:
        for name, a, b in (("param", t.params[k], j.params[k]),
                           ("m", t.opt.m[k], j.opt.m[k]),
                           ("v", t.opt.v[k], j.opt.v[k])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=tol, err_msg=f"{name} {k}")
    for k in BUFFERS:
        a, b = getattr(t, k).numpy(), np.asarray(getattr(j, k))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=k)
    assert t.opt.step == int(j.opt.step)


def _thresholds(j, extent):
    """A gradient threshold that a third of the live rows pass, and a
    percent_dense that splits them by size about in half."""
    n = int(j.num_active)
    g = np.nan_to_num(np.asarray(j.xyz_gradient_accum / j.denom)[:n, 0])
    thr = float(np.quantile(g[g > 0], 0.66))
    max_scale = np.exp(np.asarray(j.params["scaling"]))[:n].max(1)
    pd = float(np.median(max_scale)) / extent
    return thr, pd


def test_add_densification_stats(trained):
    j, dcfg, _ = trained
    rng = np.random.default_rng(0)
    cap = j.capacity
    g = rng.normal(size=(cap, 2)).astype(np.float32)
    f = rng.uniform(size=cap) > 0.4
    want = JD.add_densification_stats(j, jnp.asarray(g), jnp.asarray(f))
    got = TD.add_densification_stats(_port(j, dcfg), torch.from_numpy(g),
                                     torch.from_numpy(f))
    _same(got, want)


def test_update_max_radii(trained):
    j, dcfg, _ = trained
    rng = np.random.default_rng(1)
    r = rng.integers(0, 30, size=j.capacity).astype(np.float32)
    v = r > 4
    want = JD.update_max_radii(j, jnp.asarray(r), jnp.asarray(v))
    got = TD.update_max_radii(_port(j, dcfg), torch.from_numpy(r),
                              torch.from_numpy(v))
    _same(got, want)


def test_prune_points(trained):
    j, dcfg, _ = trained
    mask = np.random.default_rng(2).uniform(size=j.capacity) > 0.7
    want = JD.prune_points(j, jnp.asarray(mask))
    got = TD.prune_points(_port(j, dcfg), torch.from_numpy(mask))
    assert got.num_active < int(j.num_active)
    _same(got, want)


def test_densify_and_clone(trained):
    j, dcfg, extent = trained
    thr, pd = _thresholds(j, extent)
    want = JD.densify_and_clone(j, thr, extent, pd)
    got = TD.densify_and_clone(_port(j, dcfg), thr, extent, pd)
    assert got.num_active > int(j.num_active)
    _same(got, want)


def test_densify_and_split(trained):
    j, dcfg, extent = trained
    thr, pd = _thresholds(j, extent)
    key = jax.random.PRNGKey(11)
    draws = [np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                          (j.capacity, 3)))
             for i in range(2)]
    want = JD.densify_and_split(j, thr, extent, pd, key)
    got = TD.densify_and_split(_port(j, dcfg), thr, extent, pd, draws=draws)
    # the split adds two children per selected row and prunes the parent
    assert got.num_active > int(j.num_active)
    _same(got, want)


def test_prune(trained):
    j, dcfg, extent = trained
    n = int(j.num_active)
    op = 1 / (1 + np.exp(-np.asarray(j.params["opacity"])[:n, 0]))
    min_op = float(np.median(op)) + 1e-7       # prunes at least half
    for screen in (0.0, float(np.quantile(np.asarray(j.max_radii2d)[:n],
                                          0.8))):
        want = JD.prune(j, min_op, extent, screen)
        got = TD.prune(_port(j, dcfg), min_op, extent, screen)
        assert got.num_active < n
        _same(got, want)


def test_reset_opacity(trained):
    j, dcfg, _ = trained
    want = JD.reset_opacity(j)
    got = TD.reset_opacity(_port(j, dcfg))
    _same(got, want)


def test_densify(trained):
    """Clone then split: as in the JAX package, the clone resets the
    gradient statistics, so the split that follows selects no row."""
    j, dcfg, extent = trained
    thr, pd = _thresholds(j, extent)
    want = JD.densify(j, thr, extent, pd, jax.random.PRNGKey(3))
    got = TD.densify(_port(j, dcfg), thr, extent, pd,
                     torch.Generator().manual_seed(3))
    clone = TD.densify_and_clone(_port(j, dcfg), thr, extent, pd)
    assert got.num_active == clone.num_active > int(j.num_active)
    _same(got, want)


def test_grow(trained):
    j, dcfg, _ = trained
    for seed in (4, 9):
        want, w_added = JD.grow(j, 0.01, 0.05, seed=seed, voxel_size=0.5)
        got, g_added = TD.grow(_port(j, dcfg), 0.01, 0.05, seed=seed,
                               voxel_size=0.5)
        assert g_added == w_added > 0
        _same(got, want)
