"""The port's initial state against the JAX package's: `mean_knn_dist2`
(the distCUDA2 init) at N = 3, 100 and 5000, with blocks small enough that
several query and key blocks are walked; `create_from_pcd` and
`init_state_from_scene` leaf by leaf; SH degrees 0-4; the covariance
helpers of core/transforms.

Bounds: the log-scales within 5e-4 (the repo's cross-program bound,
tests/test_parallel.py:252: the squared distances are the same expanded
form |q|^2 + |k|^2 - 2 q.k, summed in another order); the knn distances
5e-4 relative; everything else exact or within 1e-6."""
import jax
import numpy as np
import pytest
import torch

from langsplat4d.config import Config as JConfig
from langsplat4d.core import sh as jsh
from langsplat4d.core import state as jstate
from langsplat4d.core import transforms as jtr
from langsplat4d.data.scene import Scene as JScene
from langsplat4d.ops.knn import mean_knn_dist2 as j_knn
from langsplat4d.train import loop as jloop
from langsplat4d_torch.config import Config
from langsplat4d_torch.core import sh as tsh
from langsplat4d_torch.core import state as tstate
from langsplat4d_torch.core import transforms as ttr
from langsplat4d_torch.data.scene import Scene
from langsplat4d_torch.interop import params_from_jax
from langsplat4d_torch.ops.knn import mean_knn_dist2
from langsplat4d_torch.train import loop as tloop
from tests.scene_fixture import make_structured_scene

GAUSS = {"xyz": "xyz", "f_dc": "features_dc", "f_rest": "features_rest",
         "opacity": "opacity", "scaling": "scaling", "rotation": "rotation",
         "language_feature": "language_feature"}


@pytest.mark.parametrize("n,blocks", [(3, {}), (100, {}), (100, dict(
    block_q=16, block_k=32)), (5000, {}), (5000, dict(block_q=700,
                                                      block_k=1500))])
def test_knn_matches_jax(n, blocks):
    pts = np.random.default_rng(n).uniform(-1, 1, size=(n, 3)).astype(
        np.float32)
    want = np.asarray(j_knn(pts))
    got = mean_knn_dist2(pts, device="cpu", **blocks).numpy()
    assert got.shape == (n,)
    if n == 3:
        # fewer than 4 points: a neighbour is missing, inf as in JAX
        assert np.isinf(got).all() and np.isinf(want).all()
        return
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=0)


def test_knn_excludes_self_and_duplicates():
    pts = np.array([[0, 0, 0], [0, 0, 0], [1, 0, 0], [0, 2, 0], [0, 0, 3]],
                   np.float32)
    got = mean_knn_dist2(pts, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(j_knn(pts)), rtol=1e-6)
    assert got[0] == pytest.approx((0 + 1 + 4) / 3)


@pytest.mark.parametrize("n,sh", [(3, 3), (257, 3), (600, 1)])
def test_create_from_pcd_matches_jax(n, sh):
    rng = np.random.default_rng(n)
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    cap = tstate.round_capacity(n, 256)
    j = jstate.create_from_pcd(pts, cols, max_sh_degree=sh, lang_dim=3,
                               capacity=cap)
    t = tstate.create_from_pcd(pts, cols, max_sh_degree=sh, lang_dim=3,
                               capacity=cap, device="cpu")
    assert t.capacity == j.capacity == cap
    assert t.num_active == int(j.num_active) == n
    for f in GAUSS.values():
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.shape == b.shape, f
        tol = 5e-4 if f == "scaling" else 1e-6
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=f)
    if n == 3:
        # with a neighbour missing the distance is inf, and the clamp is a
        # lower bound (1e-7), so the log-scales are inf in both packages
        assert np.isinf(t.scaling[:n].numpy()).all()


def _micro_cfg(cfg, root):
    cfg.model.source_path = root
    cfg.optim.max_points = 1500
    cfg.runtime.capacity_granule = 512
    cfg.hidden.kplanes_config = {
        "grid_dimensions": 2, "input_coordinate_dim": 4,
        "output_coordinate_dim": 8, "resolution": [16, 16, 16, 4]}
    cfg.hidden.multires = [1]
    cfg.hidden.net_width = 32
    return cfg


def test_init_state_from_scene_matches_jax(tmp_path):
    root = str(tmp_path / "scene")
    make_structured_scene(root, n_imgs=8, hw=32, clip_dim=3,
                          n_obj_points=400, n_bg_points=600)
    jcfg, tcfg = _micro_cfg(JConfig(), root), _micro_cfg(Config(), root)
    js, jd = jloop.init_state_from_scene(jcfg, JScene(root), seed=3)
    ts, td = tloop.init_state_from_scene(tcfg, Scene(root), seed=3,
                                         device="cpu")
    assert ts.capacity == js.capacity == 2048
    assert ts.num_active == int(js.num_active) == 1000
    assert ts.active_sh_degree == js.active_sh_degree == 0
    for k in GAUSS:
        tol = 5e-4 if k == "scaling" else 1e-6
        np.testing.assert_allclose(ts.params[k].numpy(),
                                   np.asarray(js.params[k]), rtol=0,
                                   atol=tol, err_msg=k)
        assert not ts.opt.m[k].any() and not ts.opt.v[k].any()
    np.testing.assert_array_equal(ts.aabb.numpy(), np.asarray(js.aabb))
    for name in ("max_radii2d", "xyz_gradient_accum", "denom",
                 "deformation_table", "deformation_accum"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    # the network: the same leaves and shapes (its initial values come from
    # each package's own random generator)
    jsd = params_from_jax(jax.tree.map(np.asarray, js.params["deform"]), td)
    tsd = ts.deform.state_dict()
    assert {k: tuple(v.shape) for k, v in jsd.items()} == \
        {k: tuple(v.shape) for k, v in tsd.items()}
    assert set(ts.opt.m) == set(ts.leaves())


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(300, 3, (deg + 1) ** 2)).astype(np.float32)
    d = rng.normal(size=(300, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    want = np.asarray(jsh.eval_sh(deg, sh, d))
    got = tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if deg == 4:
        with pytest.raises(ValueError):
            tsh.eval_sh(5, torch.from_numpy(sh), torch.from_numpy(d))


def test_covariance_helpers_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    s = rng.uniform(0.01, 2.0, size=(50, 3)).astype(np.float32)
    tq, ts_ = torch.from_numpy(q), torch.from_numpy(s)
    for name, got, want in (
            ("rotmat", ttr.quat_to_rotmat(tq), jtr.quat_to_rotmat(q)),
            ("L", ttr.build_scaling_rotation(ts_, tq),
             jtr.build_scaling_rotation(s, q)),
            ("cov", ttr.covariance_from_scaling_rotation(ts_, 1.3, tq),
             jtr.covariance_from_scaling_rotation(s, 1.3, q))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    m = rng.normal(size=(5, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ttr.strip_symmetric(torch.from_numpy(m)).numpy(),
        np.asarray(jtr.strip_symmetric(m)))
