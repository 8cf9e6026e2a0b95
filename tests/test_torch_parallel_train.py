"""The port's training on a data x gauss mesh of gloo ranks
(tests/torch_parallel_ranks.py): the sharded train step against the JAX
package's `train_step` on its make_mesh(4, data=2, gauss=2) and against the
port's one-rank step; densify, prune and reset_opacity under the mesh
against one rank; `training(cfg)` on the mesh against one rank; the
capacity that the gauss axis does not divide.

The step's state and batch are tests/test_torch_step.py's (the JAX side on
its jnp analytic-VJP path with one composite chunk per list, where its stop
rule and the port's coincide). Bounds: the loss rtol 1e-5, the leaves after
the step rtol 1e-4 / atol 1e-6 (tests/test_parallel.py:113-117), densify's
rows rtol 1e-5 / atol 1e-6 (tests/test_parallel.py:153-157); the loop's
saved state within 5e-4, the repo's cross-program bound (tests/
test_torch_loop.py).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplat4d.parallel import mesh as JM
from langsplat4d.train import step as JS
from langsplat4d_torch.field.deformation import DeformConfig
from langsplat4d_torch.interop import train_state_from_jax
from langsplat4d_torch.parallel.mesh import (Mesh, block_rows, shard_batch,
                                             shard_state)
from langsplat4d_torch.train import densify as D
from langsplat4d_torch.train import step as TS
from langsplat4d_torch.train.trainstate import GAUSSIAN_KEYS
from tests import torch_parallel_ranks as ranks
from tests.test_torch_step import (_batch, _configs, _jax_batch, _jax_state,
                                   _port_leaves, _torch_batch)
from tests.test_train import tiny_state

DATA, GAUSS = 2, 2
BG = np.asarray([0.1, 0.2, 0.3], np.float32)
REG = dict(time_smoothness_weight=0.01, l1_time_planes=1e-4,
           plane_tv_weight=2e-4)
# (stage, batch, extra StepConfig fields): a batch split over the data
# axis; fine-base (where the planes train) with the plane regularizer,
# which reaches the planes on every gauss rank and must count once; a
# batch of one, replicated over the data axis
CASES = {"fine-lang": ("fine-lang", 2, {}),
         "fine-base-reg": ("fine-base", 2, REG),
         "coarse-base-b1": ("coarse-base", 1, {})}


def _step_configs(stage, jd, **extra):
    """tests/test_torch_step.py's configs, fine-base as coarse-base's."""
    jcfg, tcfg = _configs("coarse-base" if stage == "fine-base" else stage,
                          jd, **extra)
    return jcfg._replace(stage=stage), tcfg._replace(stage=stage)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Per case: JAX's step on its mesh, the port's one-rank step and what
    the port's ranks saved."""
    rng = np.random.default_rng(0)
    jstate, jd = _jax_state(rng)
    jmesh = JM.make_mesh(DATA * GAUSS, data=DATA, gauss=GAUSS)
    cases, out = [], {}
    for name, (stage, b, extra) in CASES.items():
        batch = _batch(rng, b)
        jcfg, tcfg = _step_configs(stage, jd, **extra)
        split = b % DATA == 0
        jb = _jax_batch(batch)
        with jmesh:
            jout, jmetrics, *_ = JS.train_step(
                jcfg._replace(vmap_batch=split),
                JM.shard_state(jstate, jmesh),
                JM.shard_batch(jb, jmesh) if split else jb,
                jnp.asarray(BG), jnp.asarray(1), 3)
        tstate = train_state_from_jax(jstate, tcfg.dcfg, device="cpu")
        tbatch = _torch_batch(batch)
        one, metrics, *_ = TS.train_step(
            tcfg, copy.deepcopy(tstate), tbatch, torch.from_numpy(BG), 1, 3)
        cases.append(dict(state=tstate, cfg=tcfg, batch=tbatch))
        # the same step without the regularizer: what it adds to the moments
        plain, *_ = TS.train_step(
            _step_configs(stage, jd)[1], copy.deepcopy(tstate), tbatch,
            torch.from_numpy(BG), 1, 3)
        out[name] = dict(
            jax=_port_leaves(jax.device_get(jout.params), tcfg.dcfg),
            jax_loss=float(jmetrics["loss"]),
            one={k: v.detach().numpy() for k, v in one.leaves().items()},
            one_m={k: v.numpy() for k, v in one.opt.m.items()},
            plain_m={k: v.numpy() for k, v in plain.opt.m.items()},
            one_loss=float(metrics["loss"]), cap=tstate.capacity)
    base = tmp_path_factory.mktemp("steps")
    torch.save(dict(data=DATA, gauss=GAUSS, cases=cases,
                    bg=torch.from_numpy(BG), sh_degree=3), base / "in.pt")
    ranks.spawn(ranks.train_steps, DATA * GAUSS, base, str(base / "in.pt"),
                str(base / "out.pt"))
    got = [torch.load(f"{base / 'out.pt'}.{r}", weights_only=False)
           for r in range(DATA * GAUSS)]
    for i, name in enumerate(CASES):
        out[name]["ranks"] = [g[i] for g in got]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_jax_and_one_rank(steps, case):
    s = steps[case]
    for r, got in enumerate(s["ranks"]):
        np.testing.assert_allclose(got["metrics"]["loss"], s["jax_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["loss"], s["one_loss"],
                                   rtol=1e-5)
        assert got["step"] == 1
        for name, want in s["jax"].items():
            x = got["params"][name].numpy()
            np.testing.assert_allclose(x, want, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} vs JAX, rank {r}")
            np.testing.assert_allclose(x, s["one"][name], rtol=1e-4,
                                       atol=1e-6,
                                       err_msg=f"{name} vs one rank, "
                                               f"rank {r}")
        for name, want in s["one_m"].items():
            scale = max(np.abs(want).max(), 1e-30)
            np.testing.assert_allclose(got["m"][name].numpy(), want,
                                       rtol=2e-3, atol=2e-4 * scale,
                                       err_msg=f"Adam m of {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_block(steps, case):
    """Rank (d, g) holds rows [g * n, (g + 1) * n) of every Gaussian leaf
    and its Adam moment, n = capacity / gauss; data ranks hold the same."""
    s = steps[case]
    n = block_rows(s["cap"], GAUSS)
    for r, got in enumerate(s["ranks"]):
        g = r % GAUSS
        assert got["row_offset"] == g * n
        for k in GAUSSIAN_KEYS:
            assert got["blocks"][k].shape[0] == n
            assert torch.equal(got["blocks"][k],
                               got["params"][k][g * n:(g + 1) * n]), k
            assert torch.equal(got["m_blocks"][k],
                               got["m"][k][g * n:(g + 1) * n]), k
            assert torch.equal(got["params"][k],
                               s["ranks"][0]["params"][k]), k


def test_regularizer_counts_once(steps):
    """What the plane regularizer adds to the planes' Adam moments is beyond
    the comparison's bound, so the comparison above, which holds the mesh's
    moments to one rank's, would fail had the gauss ranks counted it twice;
    and the mesh's moments are one rank's, not those without it."""
    s = steps["fine-base-reg"]
    grids = [k for k in s["one_m"] if ".grid.grids." in k]
    assert grids
    beyond = False
    for k in grids:
        want, plain = s["one_m"][k], s["plain_m"][k]
        bound = 2e-3 * np.abs(want) + 2e-4 * np.abs(want).max()
        beyond |= bool((np.abs(want - plain) > bound).any())
        got = s["ranks"][0]["m"][k].numpy()
        assert np.abs(got - want).max() < np.abs(got - plain).max(), k
    assert beyond


@pytest.fixture(scope="module")
def densified(tmp_path_factory):
    """tests/test_parallel.py:124-160's inputs through densify, prune and
    reset_opacity, on one rank and on the mesh."""
    rng = np.random.default_rng(1)
    jstate, jd = tiny_state(rng, n=48, cap=64)
    dcfg = DeformConfig(**{f.name: getattr(jd, f.name)
                           for f in dataclasses.fields(DeformConfig)})
    state = train_state_from_jax(jstate, dcfg, device="cpu")
    state.xyz_gradient_accum = torch.from_numpy(
        rng.uniform(0, 1e-2, size=(64, 1)).astype(np.float32))
    state.denom = torch.ones((64, 1))
    state.max_radii2d = torch.from_numpy(
        rng.uniform(0, 30, size=(64,)).astype(np.float32))
    base = tmp_path_factory.mktemp("densify")
    torch.save(dict(data=DATA, gauss=GAUSS, state=state), base / "in.pt")
    ranks.spawn(ranks.densify_ops, DATA * GAUSS, base, str(base / "in.pt"),
                str(base / "out.pt"))
    got = [torch.load(f"{base / 'out.pt'}.{r}", weights_only=False)
           for r in range(DATA * GAUSS)]
    one = copy.deepcopy(state)
    one = D.densify(one, 1e-4, 1.6, 0.01, torch.Generator().manual_seed(3))
    one = D.prune(one, 0.3, 1.6, 20.0)
    return D.reset_opacity(one), got


def test_densify_prune_reset_under_mesh(densified):
    one, got = densified
    n = one.num_active
    for r, g in enumerate(got):
        assert g["num_active"] == n
        assert g["local_rows"] == block_rows(one.capacity, GAUSS)
        for k in ("xyz", "opacity", "scaling", "language_feature"):
            np.testing.assert_allclose(g["params"][k][:n].numpy(),
                                       one.params[k][:n].numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k}, rank {r}")
        np.testing.assert_array_equal(g["m"]["opacity"].numpy(),
                                      one.opt.m["opacity"].numpy())
        np.testing.assert_array_equal(g["max_radii2d"].numpy(),
                                      one.max_radii2d.numpy())


def test_capacity_rounds_up():
    """A capacity that the gauss axis does not divide is padded up to a
    multiple of it with inactive rows and zero moments; unsharding cuts
    them off (here by hand: the blocks of three ranks, concatenated)."""
    rng = np.random.default_rng(2)
    jstate, jd = tiny_state(rng, n=40, cap=64)
    dcfg = DeformConfig(**{f.name: getattr(jd, f.name)
                           for f in dataclasses.fields(DeformConfig)})
    whole = train_state_from_jax(jstate, dcfg, device="cpu")
    blocks = [shard_state(whole, Mesh(1, 3, rank=r)) for r in range(3)]
    n = block_rows(64, 3)
    assert n == 22 and [b.row_offset for b in blocks] == [0, 22, 44]
    for k in GAUSSIAN_KEYS:
        cat = torch.cat([b.params[k] for b in blocks])
        assert cat.shape[0] == 66
        assert torch.equal(cat[:64], whole.params[k])
        assert torch.equal(torch.cat([b.opt.v[k] for b in blocks])[:64],
                           whole.opt.v[k])
        assert not torch.cat([b.opt.m[k] for b in blocks])[64:].any()
    last = blocks[2].gaussians()
    assert not last.active_mask()[-4:].any()          # padding is inactive
    assert torch.equal(blocks[1].gaussians().active_mask(),
                       torch.arange(22, 44) < whole.num_active)
    assert blocks[2].full_capacity == 64


def test_shard_batch():
    batch = _torch_batch(_batch(np.random.default_rng(3), 4))
    halves = [shard_batch(batch, Mesh(2, 1, rank=r)) for r in range(2)]
    assert torch.equal(torch.cat([h.gt_images for h in halves]),
                       batch.gt_images)
    assert torch.equal(halves[1].cams.viewmatrix, batch.cams.viewmatrix[2:])
    assert shard_batch([1, 2, 3, 4], Mesh(2, 2, rank=3)) == [3, 4]
    with pytest.raises(ValueError, match="batch of 3 cameras"):
        shard_batch([1, 2, 3], Mesh(2, 1))


LOOP_CONFIG = dict(
    coarse_base_iterations=8, coarse_lang_iterations=2,
    fine_base_iterations=4, fine_lang_iterations=2, densify_from_iter=3,
    densification_interval=4, pruning_from_iter=4, pruning_interval=4,
    min_points_for_prune=10, opacity_reset_interval=10000, max_points=200,
    batch_size=2)


def test_training_on_mesh_matches_one_rank(tmp_path):
    """training(cfg) with data_parallel 2 x gaussian_shards 2 (batch 2
    split over the data axis, densify and prune in the base stages) ends
    with the one-rank run's state, and rank 0 alone writes."""
    from langsplat4d_torch.config import Config
    from langsplat4d_torch.parallel.mesh import make_mesh, unshard_state
    from langsplat4d_torch.train.loop import training
    from tests.scene_fixture import make_nerfies_scene

    root = str(tmp_path / "scene")
    make_nerfies_scene(root, n_imgs=6, hw=32, n_points=100)

    def config(name, data, gauss):
        cfg = Config()
        cfg.model.source_path = root
        cfg.model.model_path = str(tmp_path / name)
        cfg.model.language_features_name = "language_features"
        cfg.model.feature_level = 1
        for k, v in LOOP_CONFIG.items():
            setattr(cfg.optim, k, v)
        cfg.runtime.capacity_granule = 128
        cfg.runtime.tile_capacity = 128
        cfg.runtime.data_parallel = data
        cfg.runtime.gaussian_shards = gauss
        cfg.extras.save_iterations = [2]
        cfg.extras.test_iterations = []
        cfg.extras.checkpoint_iterations = [2]
        cfg.hidden.kplanes_config = {
            "grid_dimensions": 2, "input_coordinate_dim": 4,
            "output_coordinate_dim": 4, "resolution": [8, 8, 8, 4]}
        cfg.hidden.multires = [1]
        cfg.hidden.net_width = 16
        cfg.hidden.posebase_pe = 2
        cfg.hidden.no_dlang = 0
        return cfg
    torch.save(config("mesh", DATA, GAUSS), tmp_path / "cfg.pt")
    ranks.spawn(ranks.train_loop, DATA * GAUSS, tmp_path,
                str(tmp_path / "cfg.pt"), str(tmp_path / "out.pt"))
    got = [torch.load(f"{tmp_path / 'out.pt'}.{r}", weights_only=False)
           for r in range(DATA * GAUSS)]
    one = unshard_state(training(config("one", 1, 1), device="cpu"),
                        make_mesh())
    n = one.num_active
    for r, g in enumerate(got):
        assert g["num_active"] == n
        assert g["local_rows"] == block_rows(one.capacity, GAUSS)
        for k, v in one.leaves().items():
            np.testing.assert_allclose(g["params"][k][:n].numpy()
                                       if k in GAUSSIAN_KEYS
                                       else g["params"][k].numpy(),
                                       (v[:n] if k in GAUSSIAN_KEYS
                                        else v).detach().numpy(),
                                       rtol=0, atol=5e-4,
                                       err_msg=f"{k}, rank {r}")
    import os
    for name in ("one", "mesh"):
        assert os.path.exists(tmp_path / name / "point_cloud" /
                              "fine-lang_iteration_2" / "point_cloud.ply")
        assert os.path.exists(tmp_path / name /
                              "chkpnt_fine-lang_2.pth")
