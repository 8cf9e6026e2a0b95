"""Field parity, JAX vs the port: grid_sample, the HexPlane query with and
without the spatial cache, and deform_forward under each gate. Same numpy
inputs and the same parameters (JAX init, carried over by
params_from_jax). Tolerance 1e-5: fp32 matmul and interpolation rounding in
two frameworks' kernels."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplat4d.field import deformation as JD
from langsplat4d.field import hexplane as JH
from langsplat4d.ops.grid_sample import grid_sample_2d as j_grid_sample
from langsplat4d_torch.field import deformation as TD
from langsplat4d_torch.field import hexplane as TH
from langsplat4d_torch.interop import params_from_jax
from langsplat4d_torch.ops.grid_sample import grid_sample_2d as t_grid_sample

TOL = dict(rtol=1e-5, atol=1e-5)

# Neu3D widths (bench.py:53-56) with small planes
NEU3D_SMALL = dict(lang_dim=3, no_dlang=False, kplanes_out_dim=16,
                   kplanes_resolution=(8, 8, 8, 6), multires=(1, 2),
                   net_width=128, defor_depth=0, no_do=False, no_dshs=False,
                   no_ds=False)


def _nets(overrides, seed=0):
    jcfg = JD.DeformConfig(**{**NEU3D_SMALL, **overrides})
    tcfg = TD.DeformConfig(**{**NEU3D_SMALL, **overrides})
    params = JD.init_deform_params(jax.random.PRNGKey(seed), jcfg)
    # non-constant time planes, so the time axis matters
    rng = np.random.default_rng(seed)
    params["grid"]["grids"] = [
        [np.asarray(p) + rng.uniform(-0.2, 0.2, np.shape(p)).astype(np.float32)
         for p in planes] for planes in params["grid"]["grids"]]
    if "empty_voxel" in params:
        params["empty_voxel"] = np.asarray(params["empty_voxel"]) + rng.uniform(
            -0.5, 0.5, params["empty_voxel"].shape).astype(np.float32)
    params = jax.tree.map(jnp.asarray, params)
    net = TD.DeformNetwork(tcfg)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg), strict=True)
    return jcfg, tcfg, params, net


def _points(rng, n):
    # some points outside the +-1.6 AABB: border padding in the planes,
    # zeros in the dense grid
    xyz = rng.uniform(-1.8, 1.8, (n, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    return xyz, t


def test_grid_sample(rng):
    plane = rng.normal(size=(5, 7, 9)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (300, 2)).astype(np.float32)
    want = np.asarray(j_grid_sample(jnp.asarray(plane), jnp.asarray(coords)))
    got = t_grid_sample(torch.from_numpy(plane), torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("cached", [False, True])
def test_hexplane_query(rng, cached):
    _, _, params, net = _nets({})
    aabb = np.asarray([[1.6] * 3, [-1.6] * 3], np.float32)
    xyz, t = _points(rng, 400)
    j_spatial = (JH.hexplane_spatial(params["grid"], jnp.asarray(aabb),
                                     jnp.asarray(xyz)) if cached else None)
    want = JH.hexplane_query(params["grid"], jnp.asarray(aabb),
                             jnp.asarray(xyz), jnp.asarray(t),
                             spatial=j_spatial)
    grid = net.deformation_net.grid
    args = (torch.from_numpy(aabb), torch.from_numpy(xyz))
    with torch.no_grad():
        t_spatial = TH.hexplane_spatial(grid, *args) if cached else None
        got = TH.hexplane_query(grid, *args, torch.from_numpy(t),
                                spatial=t_spatial)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# fine-lang and fine-base (the render stages), then the remaining gates
GATES = {
    "fine-lang": {},
    "fine-base": dict(no_dlang=True),
    "discrete": dict(use_discrete_lang_f=True),
    "static-mlp+apply-rotation+no-resnet": dict(static_mlp=True,
                                                apply_rotation=True,
                                                no_resnet=True),
    "empty-voxel": dict(empty_voxel=True),
    "no-grid+grid-off-heads": dict(no_grid=True, no_dx=True, no_dr=True,
                                   no_do=True, no_dshs=True),
}


@pytest.mark.parametrize("gate", list(GATES))
def test_deform_forward(rng, gate):
    jcfg, tcfg, params, net = _nets(GATES[gate])
    n = 256
    aabb = np.asarray([[1.6] * 3, [-1.6] * 3], np.float32)
    xyz, t = _points(rng, n)
    L = tcfg.lang_dim * (tcfg.centers_num if tcfg.use_discrete_lang_f else 1)
    inputs = [xyz,
              rng.normal(-4, 1, (n, 3)).astype(np.float32),      # log-scales
              rng.normal(size=(n, 4)).astype(np.float32),        # quats
              rng.normal(size=(n, 1)).astype(np.float32),        # logits
              rng.normal(size=(n, 16, 3)).astype(np.float32),    # SH
              rng.normal(size=(n, L)).astype(np.float32),        # lang
              t]
    want = JD.deform_forward(params, jcfg, jnp.asarray(aabb),
                             *map(jnp.asarray, inputs))
    with torch.no_grad():
        spatial = TD.make_grid_spatial_cache(net, tcfg,
                                             torch.from_numpy(aabb),
                                             torch.from_numpy(xyz))
        got = TD.deform_forward(net, tcfg, torch.from_numpy(aabb),
                                *map(torch.from_numpy, inputs),
                                grid_spatial=spatial)
    names = ("pts", "scales", "rotations", "opacity", "shs", "lang", "coff")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_deform_config_from_config():
    from langsplat4d.config import Config
    cfg = Config()
    cfg.hidden.no_dlang = 0
    cfg.hidden.multires = [1, 2]
    j = JD.DeformConfig.from_config(cfg.hidden, cfg.runtime, max_sh_degree=2,
                                    net_width=32)
    t = TD.DeformConfig.from_config(cfg.hidden, cfg.runtime, max_sh_degree=2,
                                    net_width=32)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
