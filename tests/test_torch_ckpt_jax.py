"""The JAX package's training checkpoints read by the port
(langsplat4d_torch/train/ckpt_jax.py through `load_checkpoint`), on a
nerfies scene that tests/scene_fixture.py writes at 32 px, on the CPU:

- the JAX package's own `save_checkpoint` writes a fine-lang checkpoint
  after 2 JAX iterations; a process whose import system refuses jax, flax
  and the JAX package reads it through the port's `load_checkpoint`: every
  leaf, both Adam moments and the step, the buffers, `aabb` and the counts
  equal the JAX state bit for bit;
- both packages take the next 2 fine-lang iterations from that checkpoint:
  the losses within 1e-5 relative, every parameter within 5e-4 (the
  repo's cross-program bound; tests/test_torch_loop.py's treatment of
  entries whose gradients nearly vanish);
- phase B, `training(cfg)` resuming fine-lang-discrete from the JAX file,
  equals the same run from the port's own file of that state, bit for
  bit;
- chip_smoke.py's writer of the JAX layout (the card has no jax) writes a
  file that the JAX package's loader reads as the state it came from;
- a pickle holding a jax Array, a truncated file, a deform leaf of the
  wrong shape, an orbax directory and a file of neither layout raise and
  name the file or the class;
- a file that does not fit the config (aabb [3, 2], active_sh_degree 4
  under sh_degree 3, f_rest or language_feature of another width) raises
  and names the file and the leaf.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplat4d.config import Config as JConfig
from langsplat4d.data.scene import Scene as JScene
from langsplat4d.train import loop as jloop
from langsplat4d.utils.timer import Timer as JTimer
from langsplat4d_torch.config import Config
from langsplat4d_torch.data.scene import Scene
from langsplat4d_torch.field.deformation import DeformConfig
from langsplat4d_torch.interop import params_from_jax
from langsplat4d_torch.train import ckpt_jax
from langsplat4d_torch.train import loop as tloop
from langsplat4d_torch.utils.timer import Timer
from tests.scene_fixture import make_nerfies_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 32
GAUSS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
         "language_feature")
BUFFERS = ("max_radii2d", "xyz_gradient_accum", "denom",
           "deformation_table", "deformation_accum", "aabb")


def _cfg(cfg, root):
    cfg.model.source_path = root
    cfg.model.model_path = ""
    cfg.model.language_features_name = "language_features"
    cfg.model.feature_level = 1
    cfg.optim.max_points = 100
    cfg.optim.densify_until_iter = 0          # densification off
    cfg.runtime.capacity_granule = 128
    cfg.runtime.tile_capacity = 128
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


def _capture(module, mp):
    losses = []
    inner = module.train_step_packed

    def step(*a, **k):
        out = inner(*a, **k)
        losses.append(float(out[1]["loss"]))
        return out
    mp.setattr(module, "train_step_packed", step)
    return losses


def _flat(tree, td):
    """A JAX params-shaped tree -> the port's named leaves, as numpy."""
    out = {k: np.asarray(tree[k]) for k in GAUSS}
    out.update({"deform." + k: v.numpy() for k, v in params_from_jax(
        jax.device_get(tree["deform"]), td).items()})
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX state after 2 fine-lang iterations, its checkpoint written
    by the JAX package, then 2 more iterations in each package from it."""
    work = tmp_path_factory.mktemp("ckpt_jax")
    root = str(work / "scene")
    make_nerfies_scene(root, n_imgs=8, hw=HW, n_points=100)
    jcfg, tcfg = _cfg(JConfig(), root), _cfg(Config(), root)
    jscene, tscene = JScene(root), Scene(root)
    td = DeformConfig.from_config(tcfg.hidden, tcfg.runtime)
    jstate, jd = jloop.init_state_from_scene(jcfg, jscene, seed=0)
    jstate = jloop.scene_reconstruction(jcfg, jscene, jstate, jd,
                                        "fine-lang", False, 2, JTimer())
    jloop.save_checkpoint(jstate, 2, "fine-lang", str(work))
    ckpt = str(work / "chkpnt_fine-lang_2.pth")
    mp = pytest.MonkeyPatch()
    jl, tl = _capture(jloop, mp), _capture(tloop, mp)
    try:
        tstate, _ = tloop.load_checkpoint(ckpt, device="cpu", dcfg=td)
        jnext = jloop.scene_reconstruction(jcfg, jscene, jstate, jd,
                                           "fine-lang", False, 2, JTimer())
        tnext = tloop.scene_reconstruction(tcfg, tscene, tstate, td,
                                           "fine-lang", False, 2, Timer())
    finally:
        mp.undo()
    return dict(work=work, root=root, td=td, ckpt=ckpt,
                jstate=jax.device_get(jstate), jnext=jnext, tnext=tnext,
                jl=jl, tl=tl)


def test_checkpoint_unpickles_under_the_restriction(setup):
    """The JAX package's file names no class beyond the allowed numpy
    ones, and its payload has the fields the loader maps."""
    payload = ckpt_jax.read_jax_payload(setup["ckpt"])
    assert set(payload) == set(ckpt_jax.PAYLOAD_KEYS)
    assert set(payload["params"]) == {*GAUSS, "deform"}
    assert payload["stage"] == "fine-lang" and payload["iteration"] == 2
    assert ckpt_jax.checkpoint_format(setup["ckpt"]) == "jax"


def test_load_in_a_process_without_jax_is_bit_equal(setup):
    """A process that cannot import jax, flax or the JAX package reads the
    checkpoint; its state equals the JAX state bit for bit."""
    out = str(setup["work"] / "loaded.npz")
    dcfg = json.dumps(dataclasses.asdict(setup["td"]))
    code = textwrap.dedent(f"""
        import sys

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                          "langsplat4d"):
                    raise ImportError("refused: " + name)

        sys.meta_path.insert(0, Refuse())
        import json
        import numpy as np
        from langsplat4d_torch.field.deformation import DeformConfig
        from langsplat4d_torch.train.loop import load_checkpoint
        kw = {{k: tuple(v) if isinstance(v, list) else v
              for k, v in json.loads({dcfg!r}).items()}}
        state, _ = load_checkpoint({setup["ckpt"]!r}, device="cpu",
                                   dcfg=DeformConfig(**kw))
        arrays = {{"leaf " + k: v.detach().numpy()
                  for k, v in state.leaves().items()}}
        arrays.update({{"m " + k: v.numpy() for k, v in state.opt.m.items()}})
        arrays.update({{"v " + k: v.numpy() for k, v in state.opt.v.items()}})
        for k in {BUFFERS!r}:
            arrays[k] = getattr(state, k).numpy()
        arrays["counts"] = np.array([state.opt.step, state.num_active,
                                     state.active_sh_degree])
        np.savez({out!r}, **arrays)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "langsplat4d"))
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    got = dict(np.load(out))
    js, td = setup["jstate"], setup["td"]
    want = {}
    for tag, tree in (("leaf", js.params), ("m", js.opt.m), ("v", js.opt.v)):
        want.update({f"{tag} {k}": v for k, v in _flat(tree, td).items()})
    want.update({k: np.asarray(getattr(js, k)) for k in BUFFERS})
    want["counts"] = np.array([int(js.opt.step), int(js.num_active),
                               js.active_sh_degree])
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert int(js.opt.step) == 2
    assert np.abs(js.opt.v["language_feature"]).max() > 0


def test_next_steps_match_jax(setup):
    """2 fine-lang iterations from the checkpoint in both packages."""
    jl, tl = setup["jl"], setup["tl"]
    assert len(jl) == len(tl) == 2
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    js, ts, td = setup["jnext"], setup["tnext"], setup["td"]
    assert ts.opt.step == int(js.opt.step) == 4
    want, want_m, want_v = (_flat(t, td) for t in (js.params, js.opt.m,
                                                   js.opt.v))
    got = ts.leaves()
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        v = want_v[k]
        small = v <= 1e-6 * v.max()
        np.testing.assert_allclose(g[~small], w[~small], rtol=0, atol=5e-4,
                                   err_msg=k)
        m_max = np.abs(want_m[k]).max()
        np.testing.assert_allclose(ts.opt.m[k].numpy()[small],
                                   want_m[k][small], rtol=2e-3,
                                   atol=2e-4 * m_max, err_msg=k)


def _phase_b(setup, ckpt, model_path, monkeypatch):
    cfg = _cfg(Config(), setup["root"])
    cfg.runtime.use_discrete_lang_f = True
    cfg.model.model_path = model_path
    cfg.extras.resume_from_final_stage = 1
    cfg.extras.init_from_stage = "fine-base"
    cfg.extras.start_checkpoint = ckpt
    cfg.optim.fine_lang_iterations = 5
    inner = tloop.scene_reconstruction

    def shortened(cfg2, scene, state, dcfg, stage, joint, iters, timer,
                  **kw):
        return inner(cfg2, scene, state, dcfg, stage, joint, min(iters, 3),
                     timer, **kw)
    monkeypatch.setattr(tloop, "scene_reconstruction", shortened)
    # no TensorBoard sink (its import loads TensorFlow where installed,
    # ~10 s); the telemetry goes without it, as where it does not import
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    losses = _capture(tloop, monkeypatch)
    state = tloop.training(cfg, device="cpu")
    monkeypatch.undo()
    return state, losses


def test_phase_b_from_the_jax_file_equals_the_port_file(setup, monkeypatch):
    """training(cfg) into fine-lang-discrete from the JAX file and from the
    port's own file of the same state: the same losses and state, bit for
    bit."""
    work, td = setup["work"], setup["td"]
    state, _ = tloop.load_checkpoint(setup["ckpt"], device="cpu", dcfg=td)
    os.makedirs(work / "port_ckpt")
    port_ckpt = tloop.save_checkpoint(state, 2, "fine-lang",
                                      str(work / "port_ckpt"), td)
    assert ckpt_jax.checkpoint_format(port_ckpt) == "torch"
    a, la = _phase_b(setup, setup["ckpt"], str(work / "b_jax"), monkeypatch)
    b, lb = _phase_b(setup, port_ckpt, str(work / "b_port"), monkeypatch)
    assert len(la) == 3 and la == lb
    assert a.params["language_feature"].shape == (128, 9)
    assert a.opt.step == b.opt.step == 5
    for name, x, y in [("leaf " + k, v, b.leaves()[k])
                       for k, v in a.leaves().items()] + \
            [("m " + k, v, b.opt.m[k]) for k, v in a.opt.m.items()] + \
            [("v " + k, v, b.opt.v[k]) for k, v in a.opt.v.items()] + \
            [(k, getattr(a, k), getattr(b, k)) for k in BUFFERS]:
        assert torch.equal(x.detach(), y.detach()), name


def test_smoke_writer_writes_the_jax_layout(setup, tmp_path):
    """chip_smoke.write_jax_checkpoint, from the port's state: the JAX
    package's loader reads the state the JAX file held, and the port's
    loader reads it back bit for bit."""
    sys.path.insert(0, REPO)
    import chip_smoke
    td = setup["td"]
    state, _ = tloop.load_checkpoint(setup["ckpt"], device="cpu", dcfg=td)
    path = chip_smoke.write_jax_checkpoint(state, str(tmp_path / "c.pth"),
                                           2, "fine-lang")
    back, _ = jloop.load_checkpoint(path)
    want = setup["jstate"]
    for a, b in ((back.params, want.params), (back.opt.m, want.opt.m),
                 (back.opt.v, want.opt.v)):
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for k in BUFFERS:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(want, k)))
    assert int(back.opt.step) == 2 and back.num_active == want.num_active
    again, _ = tloop.load_checkpoint(path, device="cpu", dcfg=td)
    for k, v in state.leaves().items():
        assert torch.equal(again.leaves()[k], v.detach()), k


def test_refusals_name_the_file_or_class(setup, tmp_path):
    td = setup["td"]
    with open(setup["ckpt"], "rb") as f:
        data = f.read()
    # a pickle holding a jax Array
    bad = str(tmp_path / "jax_array.pth")
    with open(bad, "wb") as f:
        pickle.dump(dict(params=jnp.zeros(3)), f)
    with pytest.raises(ckpt_jax.RefusedClass, match=r"jax_array\.pth: "
                       r"refused jax\..*"):
        tloop.load_checkpoint(bad, device="cpu", dcfg=td)
    # a truncated file
    cut = str(tmp_path / "cut.pth")
    with open(cut, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(ValueError, match=r"cut\.pth: not a readable JAX"):
        tloop.load_checkpoint(cut, device="cpu", dcfg=td)
    # a deform leaf of the wrong shape
    payload = ckpt_jax.read_jax_payload(setup["ckpt"])
    for tree in ("params", "opt_m", "opt_v"):
        layer = payload[tree]["deform"]["pos_deform"][1]
        layer["w"] = np.zeros((layer["w"].shape[0], 5), np.float32)
    wrong = str(tmp_path / "wrong.pth")
    with open(wrong, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(ValueError, match=r"wrong\.pth: deform leaf "
                       r"deformation_net\.pos_deform\.3\.weight"):
        tloop.load_checkpoint(wrong, device="cpu", dcfg=td)
    # a DeformConfig that is not the checkpoint's
    with pytest.raises(ValueError, match="chkpnt_fine-lang_2.pth: deform "
                       "leaf"):
        tloop.load_checkpoint(setup["ckpt"], device="cpu",
                              dcfg=dataclasses.replace(td, net_width=32))
    # no DeformConfig for a JAX file
    with pytest.raises(ValueError, match="holds no DeformConfig"):
        tloop.load_checkpoint(setup["ckpt"], device="cpu")
    # an orbax directory
    orbax = tmp_path / "chkpnt_orbax"
    orbax.mkdir()
    with pytest.raises(ValueError, match=r"chkpnt_orbax is a directory.*"
                       r"reads no orbax"):
        tloop.load_checkpoint(str(orbax), device="cpu", dcfg=td)
    # neither layout
    junk = str(tmp_path / "junk.pth")
    with open(junk, "wb") as f:
        f.write(b"junk data")
    with pytest.raises(ValueError, match=r"junk\.pth is neither"):
        tloop.load_checkpoint(junk, device="cpu", dcfg=td)


def _aabb_transposed(payload, cap):
    payload["aabb"] = np.ascontiguousarray(payload["aabb"].T)


def _sh_degree_4(payload, cap):
    payload["active_sh_degree"] = 4


def _f_rest_degree_2(payload, cap):
    for tree in ("params", "opt_m", "opt_v"):
        payload[tree]["f_rest"] = np.zeros((cap, 8, 3), np.float32)


def _language_width_5(payload, cap):
    for tree in ("params", "opt_m", "opt_v"):
        payload[tree]["language_feature"] = np.zeros((cap, 5), np.float32)


@pytest.mark.parametrize("mutate, match", [
    (_aabb_transposed, r"aabb is float32 \(3, 2\), not float32 \(2, 3\)"),
    (_sh_degree_4, r"active_sh_degree 4 is not an integer in 0\.\.3"),
    (_f_rest_degree_2, r"f_rest holds \(8, 3\) per Gaussian; sh_degree 3 "
                       r"gives \(15, 3\)"),
    (_language_width_5, r"language_feature holds \(5,\) per Gaussian; stage "
                        r"'fine-lang' at lang_dim 3 gives \(3,\)"),
], ids=["aabb", "active_sh_degree", "f_rest", "language_feature"])
def test_config_mismatch_names_the_leaf(setup, tmp_path, mutate, match):
    """A JAX file whose leaves do not fit the config the caller trains with
    raises, naming the file and the leaf; nothing is coerced."""
    payload = ckpt_jax.read_jax_payload(setup["ckpt"])
    mutate(payload, payload["params"]["xyz"].shape[0])
    bad = str(tmp_path / "misfit.pth")
    with open(bad, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(ValueError, match=r"misfit\.pth: " + match):
        tloop.load_checkpoint(bad, device="cpu", dcfg=setup["td"])
