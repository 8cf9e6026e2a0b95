"""The discrete `fine-lang-discrete` stage (phase B of
scripts/train_eval.sh) in the port against the JAX package, on a nerfies
scene that tests/scene_fixture.py writes, on the CPU:

- `deform_forward(..., init_centers=True)` against JAX's, within 1e-5;
- `prepare_discrete_stage` from `fine-base`: the language features bit-equal
  (the same numpy noise on the same normalised features), fresh moments;
- from `fine-lang`: the deformed samples that K-Means clusters within 1e-5
  of those the JAX package hands scikit-learn, and ops/kmeans.py against
  scikit-learn on them, seeded alike (each Gaussian's inertia within 1% of
  scikit-learn's, the median ratio at most 1.0001, the centres equal as
  sets within 1e-4) and on planted clusters (the same bounds), and against
  its plain version;
- 4 iterations of fine-lang-discrete from one state in both packages: every
  loss within 1e-5 relative, every leaf within rtol 2e-3 / atol 2e-4 of the
  leaf's largest entry (the repo's gradient bound, after 4 Adam steps);
- `training(cfg)` resuming from a checkpoint into the stage, its budget cut
  as tests/test_e2e.py:145-157 cuts it;
- the discrete model saved, loaded by both packages' loaders and rendered
  at fine-lang-discrete within 5e-4 of the JAX render (the repo's
  cross-program bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans

from langsplat4d.checkpoint import load_trained_model as j_load
from langsplat4d.config import Config as JConfig
from langsplat4d.data.scene import Scene as JScene
from langsplat4d.field import deformation as JD
from langsplat4d.render import pipeline as JP
from langsplat4d.render import raster as JR
from langsplat4d.train import loop as jloop
from langsplat4d.utils.timer import Timer as JTimer
from langsplat4d_torch.checkpoint import load_trained_model
from langsplat4d_torch.config import Config
from langsplat4d_torch.data.scene import Scene
from langsplat4d_torch.field import deformation as TD
from langsplat4d_torch.interop import params_from_jax, train_state_from_jax
from langsplat4d_torch.ops.kmeans import kmeans, kmeans_plain
from langsplat4d_torch.render import pipeline as TP
from langsplat4d_torch.render import raster as TR
from langsplat4d_torch.train import loop as tloop
from langsplat4d_torch.utils.timer import Timer
from tests.scene_fixture import make_nerfies_scene

HW = 32
GAUSS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
         "language_feature")


def _cfg(cfg, root):
    cfg.model.source_path = root
    cfg.model.model_path = ""
    cfg.model.language_features_name = "language_features"
    cfg.model.feature_level = 1
    cfg.optim.max_points = 100
    cfg.optim.densify_until_iter = 0
    cfg.runtime.capacity_granule = 128
    cfg.runtime.tile_capacity = 128
    cfg.runtime.use_discrete_lang_f = True
    cfg.runtime.centers_num = 3
    cfg.extras.test_iterations = []
    cfg.extras.save_iterations = []
    cfg.extras.checkpoint_iterations = []
    cfg.hidden.kplanes_config = {
        "grid_dimensions": 2, "input_coordinate_dim": 4,
        "output_coordinate_dim": 4, "resolution": [8, 8, 8, 4]}
    cfg.hidden.multires = [1]
    cfg.hidden.net_width = 16
    cfg.hidden.no_dlang = 0
    return cfg


class _Recorder:
    """Stands in for sklearn.cluster.KMeans inside the JAX package's
    prepare_discrete_stage: keeps every Gaussian's samples and fits the
    real KMeans on them."""
    seen = []

    def __init__(self, **kw):
        self.km = KMeans(**kw)

    def fit(self, x):
        _Recorder.seen.append(np.array(x))
        self.km.fit(x)
        self.cluster_centers_ = self.km.cluster_centers_
        self.inertia_ = self.km.inertia_
        return self


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("discrete") / "scene")
    make_nerfies_scene(root, n_imgs=8, hw=HW, n_points=100)
    jcfg, tcfg = _cfg(JConfig(), root), _cfg(Config(), root)
    jscene, tscene = JScene(root), Scene(root)
    jstate, jd = jloop.init_state_from_scene(jcfg, jscene, seed=0)
    # trained-looking language features on the live rows, and time planes
    # that vary, so that the deformed samples move with time
    rng = np.random.default_rng(8)
    lf = np.zeros(jstate.params["language_feature"].shape, np.float32)
    lf[:100] = rng.normal(size=(100, 3))
    deform = jax.tree.map(np.asarray, jstate.params["deform"])
    deform["grid"]["grids"] = [
        [p + rng.uniform(-0.3, 0.3, p.shape).astype(np.float32)
         for p in planes] for planes in deform["grid"]["grids"]]
    jstate = jstate.replace(params=dict(
        jstate.params, language_feature=jnp.asarray(lf),
        deform=jax.tree.map(jnp.asarray, deform)))
    td = TD.DeformConfig.from_config(tcfg.hidden, tcfg.runtime)
    assert td.use_discrete_lang_f and jd.use_discrete_lang_f
    return dict(root=root, jcfg=jcfg, tcfg=tcfg, jscene=jscene,
                tscene=tscene, jstate=jstate, jd=jd, td=td)


def _port_state(setup):
    return train_state_from_jax(jax.device_get(setup["jstate"]), setup["td"],
                                device="cpu")


def test_deform_forward_init_centers_matches_jax(setup):
    """The samples' path: the discrete mix skipped, the language MLP on the
    normalised features; a config without the MLP is refused."""
    jd = dataclasses.replace(setup["jd"], no_dlang=False)
    td = dataclasses.replace(setup["td"], no_dlang=False)
    js = setup["jstate"]
    ts = _port_state(setup)
    rng = np.random.default_rng(3)
    cap = ts.capacity
    t = rng.random((cap, 1)).astype(np.float32)
    lang = rng.normal(size=(cap, 3)).astype(np.float32)
    g = js.gaussians()
    want = JD.deform_forward(js.params["deform"], jd, js.aabb, g.xyz,
                             g.scaling, g.rotation, g.opacity,
                             g.get_features(), jnp.asarray(lang),
                             jnp.asarray(t), init_centers=True)
    tg = ts.gaussians()
    with torch.no_grad():
        got = TD.deform_forward(ts.deform, td, ts.aabb, tg.xyz, tg.scaling,
                                tg.rotation, tg.opacity, tg.get_features(),
                                torch.from_numpy(lang), torch.from_numpy(t),
                                init_centers=True)
    assert got[6] is None and want[6] is None
    for name, a, b in zip(("pts", "scales", "rot", "opacity", "shs", "lang"),
                          got[:6], want[:6]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="no_dlang"):
        TD.deform_forward(ts.deform, dataclasses.replace(td, no_dlang=True),
                          ts.aabb, tg.xyz, tg.scaling, tg.rotation,
                          tg.opacity, tg.get_features(),
                          torch.from_numpy(lang), torch.from_numpy(t),
                          init_centers=True)


def test_prepare_from_fine_base_is_bit_equal(setup):
    js = jloop.prepare_discrete_stage(setup["jcfg"], setup["jstate"],
                                      setup["jd"], init_from_stage="fine-base")
    ts = tloop.prepare_discrete_stage(setup["tcfg"], _port_state(setup),
                                      setup["td"], init_from_stage="fine-base")
    want = np.asarray(js.params["language_feature"])
    got = ts.params["language_feature"].numpy()
    assert got.shape == want.shape == (128, 9)
    np.testing.assert_array_equal(got, want)
    for moments in (ts.opt.m, ts.opt.v):
        assert not moments["language_feature"].any()
        assert moments["language_feature"].shape == (128, 9)
    again = tloop.prepare_discrete_stage(setup["tcfg"], ts, setup["td"])
    assert again.params["language_feature"] is ts.params["language_feature"]


@pytest.fixture(scope="module")
def kmeans_mode(setup):
    """Both packages' prepare_discrete_stage from `fine-lang` (K-Means on
    100 deformed samples of each live Gaussian); the JAX package's
    scikit-learn calls recorded."""
    import sklearn.cluster
    mp = pytest.MonkeyPatch()
    _Recorder.seen = []
    mp.setattr(sklearn.cluster, "KMeans", _Recorder)
    try:
        js = jloop.prepare_discrete_stage(setup["jcfg"], setup["jstate"],
                                          setup["jd"],
                                          init_from_stage="fine-lang")
    finally:
        mp.undo()
    ts = _port_state(setup)
    lf = ts.params["language_feature"].numpy()
    lf_n = lf / (np.linalg.norm(lf, axis=-1, keepdims=True) + 1e-9)
    samples = tloop.deformed_lang_samples(ts, setup["td"],
                                          torch.from_numpy(lf_n))
    ts = tloop.prepare_discrete_stage(setup["tcfg"], ts, setup["td"],
                                      init_from_stage="fine-lang")
    return dict(js=js, ts=ts, seen=np.stack(_Recorder.seen),
                samples=samples)


def test_prepare_from_fine_lang_samples_match_jax(kmeans_mode):
    seen, samples = kmeans_mode["seen"], kmeans_mode["samples"]
    assert seen.shape == (100, 100, 3) and samples.shape == (128, 100, 3)
    np.testing.assert_allclose(samples[:100].numpy(), seen, rtol=0,
                               atol=1e-5)
    got = kmeans_mode["ts"].params["language_feature"]
    assert got.shape == (128, 9) and torch.isfinite(got).all()
    assert not got[100:].any()


@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_against_scikit_learn_on_the_samples(kmeans_mode, seed):
    """ops/kmeans.py seeded as KMeans(random_state=seed, n_init=10) seeds
    itself, on the stage's samples: each Gaussian's inertia within 1% of
    scikit-learn's, the median ratio at most 1.0001, and its centres equal
    to scikit-learn's as sets within 1e-4. Seed 0 is the stage's (the JAX
    package's call): the port's layout of the stage's centres. The plain
    per-Gaussian version against the batched one (inertia within 1e-5
    relative: sums in another order)."""
    x = kmeans_mode["samples"][:100]
    fits = [KMeans(n_clusters=3, random_state=seed, n_init=10).fit(s)
            for s in x.numpy()]
    want = np.array([f.inertia_ for f in fits])
    c, inertia = kmeans(x, 3, seed=seed)
    ratio = inertia.numpy() / want
    assert ratio.max() <= 1.01 and np.median(ratio) <= 1.0001, ratio
    for g, f in enumerate(fits):
        np.testing.assert_allclose(np.sort(c[g].numpy(), 0),
                                   np.sort(f.cluster_centers_, 0), rtol=0,
                                   atol=1e-4, err_msg=str(g))
    if seed == 0:
        lf = kmeans_mode["ts"].params["language_feature"][:100]
        np.testing.assert_array_equal(
            lf.reshape(100, 3, 3).permute(0, 2, 1), c)
    pc, pi = kmeans_plain(x[:20], 3, seed=seed)
    np.testing.assert_allclose(pi.numpy(), inertia[:20].numpy(), rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(pc.numpy(), c[:20].numpy(), rtol=0,
                               atol=1e-5)


def test_kmeans_finds_planted_clusters():
    """Well-separated clusters: the centres equal scikit-learn's as sets,
    within 1e-4, and each set's inertia within 1% of scikit-learn's."""
    rng = np.random.default_rng(5)
    n, s, k = 40, 100, 3
    cent = rng.normal(size=(n, k, 3)) * 3
    lab = rng.integers(0, k, (n, s))
    lab[:, :k] = np.arange(k)                       # no cluster is empty
    x = (cent[np.arange(n)[:, None], lab]
         + rng.normal(size=(n, s, 3)) * 0.1).astype(np.float32)
    c, inertia = kmeans(torch.from_numpy(x), k, seed=5)
    for g in range(n):
        fit = KMeans(n_clusters=k, random_state=5, n_init=10).fit(x[g])
        np.testing.assert_allclose(np.sort(c[g].numpy(), 0),
                                   np.sort(fit.cluster_centers_, 0), rtol=0,
                                   atol=1e-4)
        assert float(inertia[g]) <= 1.01 * fit.inertia_


@pytest.fixture(scope="module")
def discrete_runs(setup):
    """4 iterations of fine-lang-discrete in both packages from the state
    that prepare_discrete_stage (fine-base) makes."""
    js = jloop.prepare_discrete_stage(setup["jcfg"], setup["jstate"],
                                      setup["jd"])
    ts = train_state_from_jax(jax.device_get(js), setup["td"], device="cpu")
    losses = {"jax": [], "port": []}
    mp = pytest.MonkeyPatch()
    for name, mod in (("jax", jloop), ("port", tloop)):
        inner = mod.train_step_packed

        def step(*a, _inner=inner, _out=losses[name], **k):
            out = _inner(*a, **k)
            _out.append(float(out[1]["loss"]))
            return out
        mp.setattr(mod, "train_step_packed", step)
    try:
        js = jloop.scene_reconstruction(setup["jcfg"], setup["jscene"], js,
                                        setup["jd"], "fine-lang-discrete",
                                        False, 4, JTimer())
        ts = tloop.scene_reconstruction(setup["tcfg"], setup["tscene"], ts,
                                        setup["td"], "fine-lang-discrete",
                                        False, 4, Timer())
    finally:
        mp.undo()
    return dict(js=js, ts=ts, losses=losses)


def test_discrete_stage_matches_jax(setup, discrete_runs):
    js, ts = discrete_runs["js"], discrete_runs["ts"]
    jl, tl = discrete_runs["losses"]["jax"], discrete_runs["losses"]["port"]
    assert len(jl) == len(tl) == 4
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    want = {k: np.asarray(js.params[k]) for k in GAUSS}
    want.update({"deform." + k: v.numpy() for k, v in params_from_jax(
        jax.device_get(js.params["deform"]), setup["td"]).items()})
    got = ts.leaves()
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=2e-3,
                                   atol=2e-4 * max(np.abs(w).max(), 1e-12),
                                   err_msg=k)
    # the stage trains the mixing network and the centres
    start = tloop.prepare_discrete_stage(setup["tcfg"], _port_state(setup),
                                         setup["td"])
    for k in ("language_feature",
              "deform.deformation_net.discrete_coff_generator.1.weight"):
        assert not torch.equal(got[k].detach(), start.leaves()[k]), k


def test_resume_through_training(setup, tmp_path, monkeypatch):
    """training(cfg) with resume_from_final_stage 1: the checkpoint read
    back, its features expanded from fine-base, then fine-lang-discrete for
    fine_lang_iterations + 10000 iterations, cut here to 3 as
    tests/test_e2e.py:145-157 cuts the JAX package's."""
    ts = _port_state(setup)
    ckpt = tloop.save_checkpoint(ts, 7, "fine-lang", str(tmp_path),
                                 setup["td"])
    cfg = _cfg(Config(), setup["root"])
    cfg.model.model_path = str(tmp_path / "model")
    cfg.extras.resume_from_final_stage = 1
    cfg.extras.init_from_stage = "fine-base"
    cfg.extras.start_checkpoint = ckpt
    cfg.optim.fine_lang_iterations = 5
    calls = []
    inner = tloop.scene_reconstruction

    def shortened(cfg2, scene, state, dcfg, stage, joint, iters, timer,
                  **kw):
        calls.append((stage, iters, dcfg.use_discrete_lang_f,
                      state.params["language_feature"].shape[1]))
        return inner(cfg2, scene, state, dcfg, stage, joint, min(iters, 3),
                     timer, **kw)
    monkeypatch.setattr(tloop, "scene_reconstruction", shortened)
    state = tloop.training(cfg, device="cpu")
    assert calls == [("fine-lang-discrete", 10005, True, 9)]
    assert state.params["language_feature"].shape == (128, 9)
    assert torch.isfinite(state.params["language_feature"]).all()
    assert state.opt.step == ts.opt.step + 3


def test_discrete_model_renders_as_jax(setup, discrete_runs, tmp_path):
    """save_scene of the trained discrete state (a 9-column language PLY),
    read by both packages' load_trained_model (core/state.from_arrays keeps
    the width), rendered at fine-lang-discrete through the mixed
    prototypes."""
    ts, td, jd = discrete_runs["ts"], setup["td"], setup["jd"]
    model_path = str(tmp_path / "model")
    tloop.save_scene(setup["tcfg"], ts, 4, "fine-lang-discrete", model_path)
    aabb = ts.aabb.numpy()
    tm, it = load_trained_model(model_path, "fine-lang-discrete", -1, td,
                                aabb=aabb, device="cpu")
    jm, jit_ = j_load(model_path, "fine-lang-discrete", -1, jd, aabb=aabb)
    assert it == jit_ == 4
    assert tm.gaussians.language_feature.shape[1] == 9
    np.testing.assert_array_equal(
        tm.gaussians.language_feature[:100].numpy(),
        ts.params["language_feature"][:100].detach().numpy())
    cam = setup["tscene"].getVideoCameras()[2]
    js = JR.RasterSettings(HW, HW, sh_degree=3, lang_dim=3,
                           tile_capacity=128, composite_chunk=128,
                           two_level_binning=False)
    want = JP.render(js, jd, "fine-lang-discrete",
                     setup["jscene"].getVideoCameras()[2].camera_params(),
                     jnp.float32(cam.time), jm.gaussians(),
                     jm.params["deform"], jm.aabb, jnp.ones(3))
    with torch.no_grad():
        got = TP.render(TR.RasterSettings(HW, HW, sh_degree=3), td,
                        "fine-lang-discrete", cam.camera_params("cpu"),
                        cam.time, tm.gaussians, tm.deform, tm.aabb,
                        torch.ones(3))
    assert got["coff"] is not None and got["coff"].shape[1] == 3
    for key in ("render", "language_feature_image"):
        w = np.asarray(want[key])
        assert np.abs(w).max() > 0.05, key
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=5e-4,
                                   err_msg=key)
