"""The port's tile-band render on gloo ranks against the JAX package's band
renderer on the conftest's forced 8-device CPU mesh, and bit for bit
against the port's one-rank render; `render_frame_banded`; the render CLI
under two ranks; and the faults (a world of the wrong size, a band request
on one rank).

The ranks are processes that torch.multiprocessing.spawn starts
(tests/torch_parallel_ranks.py), gloo over a file:// store, one thread
each, no JAX. The JAX side renders in Pallas interpret mode with tiers
that take every Gaussian (nothing clipped), a budget and a bucket of every
(Gaussian, tile) pair, and one composite chunk spanning each tile, where
its per-chunk T < 1e-4 stop and the port's per-pixel stop coincide
(ROADMAP queue 3). Bounds: the JAX band tests' own, rtol 5e-3 / atol 5e-4
(tests/test_parallel.py:255-265), against JAX; bit-equality against the
port's one-rank render (the band's segments are the whole build's, and
kernel 3 blends a band in the image's pixel coordinates); the render CLI's
files within 5e-4, tests/test_torch_cli.py's bound.
"""
import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from langsplat4d.parallel import mesh as JM
from langsplat4d.parallel import render as JPR
from langsplat4d.render import raster as JR
from langsplat4d_torch.field.deformation import DeformConfig
from langsplat4d_torch.interop import train_state_from_jax
from langsplat4d_torch.ops.composite import composite_stream
from langsplat4d_torch.parallel.mesh import make_mesh
from langsplat4d_torch.render import pipeline as TP
from langsplat4d_torch.render import raster as TR
from langsplat4d_torch.render.stream import build_stream
from tests import torch_parallel_ranks as ranks
from tests.test_raster import make_camera, random_scene
from tests.test_train import tiny_state

D = 4                    # ranks, and the JAX mesh's gauss axis
JAX_TOL = dict(rtol=5e-3, atol=5e-4)
# (H, W, seed, Gaussians): tests/test_parallel.py's two band scenes; 80 px
# is 5 tile rows, an uneven split over 4 ranks (bands of 2, 2, 1 and 0)
SCENES = {"64x64": (64, 64, 7, 96), "80x64": (80, 64, 11, 64)}


def _torch_cam(cam):
    return TR.CameraParams(*[torch.from_numpy(np.array(getattr(cam, f)))
                             for f in ("viewmatrix", "projmatrix", "campos",
                                       "tanfovx", "tanfovy")])


def _jax_band(h, w, seed, n):
    """The JAX package's two exchanges on its 4-rank gauss mesh and the
    scene's inputs."""
    rng = np.random.default_rng(seed)
    means, scales, quats, opac, colors, lang = random_scene(rng, n=n)
    cam = make_camera(h, w)
    tiers = ((3, n), (6, n), (16, n))
    budget = -(-n * (-(-h // 16)) * (-(-w // 16)) // 128) * 128
    settings = JR.RasterSettings(h, w, sh_degree=0, lang_dim=3,
                                 include_feature=True, tile_capacity=64,
                                 composite_chunk=budget)
    args = tuple(map(jnp.asarray, (means, opac, scales, quats, colors, lang)))
    mesh = JM.make_mesh(D, data=1, gauss=D)
    with pltpu.force_tpu_interpret_mode():
        img = JPR.render_tiles_sharded(
            settings, cam, *args, jnp.ones(n, bool), jnp.zeros(3), mesh,
            tiers=tiers, budget=budget)
        img2, dropped = JPR.render_tiles_scatter(
            settings, cam, *args, jnp.ones(n, bool), jnp.zeros(3), mesh,
            tiers=tiers, bucket=budget)
    assert int(dropped) == 0
    inputs = dict(means=means, opac=opac, scales=scales, quats=quats,
                  colors=colors, lang=lang)
    return (dict({k: torch.from_numpy(v) for k, v in inputs.items()},
                 active=torch.ones(n, dtype=torch.bool), bg=torch.zeros(3),
                 cam=_torch_cam(cam),
                 settings=TR.RasterSettings(h, w, sh_degree=0,
                                            tile_size=16)),
            np.asarray(img), np.asarray(img2))


def _one_rank_render(d):
    """The port's render of the whole row set on one rank: preprocess, the
    stream build, kernel 3 over the image -> [c_out, H, W]."""
    st = d["settings"]
    prep = TR.preprocess(st, d["cam"], d["means"], d["opac"], d["scales"],
                         d["quats"], None, d["colors"], active=d["active"])
    rows, starts = build_stream(st, prep, d["lang"])
    return composite_stream(rows, starts, d["bg"], tiles_x=st.tiles_x,
                            tiles_y=st.tiles_y, tile_size=16,
                            height=st.image_height, width=st.image_width)


@pytest.fixture(scope="module")
def bands(tmp_path_factory):
    """Per scene: the inputs, JAX's two images, the port's one-rank image
    and what the port's ranks saved."""
    out = {}
    for name, (h, w, seed, n) in SCENES.items():
        base = tmp_path_factory.mktemp(f"band_{name}")
        inputs, j_gather, j_scatter = _jax_band(h, w, seed, n)
        torch.save(inputs, base / "in.pt")
        ranks.spawn(ranks.band_render, D, base, str(base / "in.pt"),
                    str(base / "out.pt"))
        got = [torch.load(f"{base / 'out.pt'}.{r}", weights_only=False)
               for r in range(D)]
        out[name] = dict(jax={"allgather": j_gather, "alltoall": j_scatter},
                         one=_one_rank_render(inputs), ranks=got,
                         settings=inputs["settings"])
    return out


@pytest.mark.parametrize("exchange", ["allgather", "alltoall"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_band_render_matches_jax_and_one_rank(bands, scene, exchange):
    b = bands[scene]
    one = b["one"]
    assert float(one[:3].abs().max()) > 0.1          # a real image
    for r, got in enumerate(b["ranks"]):
        assert got["dropped"] == 0
        # every rank stitches the same image, bit-equal to one rank's
        assert torch.equal(got[exchange], one), (scene, exchange, r)
    np.testing.assert_allclose(b["ranks"][0][exchange].numpy(),
                               b["jax"][exchange], **JAX_TOL)


@pytest.mark.parametrize("scene", list(SCENES))
def test_each_rank_holds_its_band(bands, scene):
    """Rank r's band is rows [r * band, (r + 1) * band) of the image, cut
    at its height (the last of 80 px over 4 ranks is empty)."""
    b = bands[scene]
    st = b["settings"]
    band_px = -(-st.tiles_y // D) * 16
    heights = []
    for r, got in enumerate(b["ranks"]):
        for band in got["bands"]:
            lo = min(r * band_px, st.image_height)
            hi = min(lo + band_px, st.image_height)
            assert band.shape[1] == hi - lo
            assert torch.equal(band, b["one"][:, lo:hi])
        heights.append(got["bands"][0].shape[1])
    assert sum(heights) == st.image_height


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """tests/test_parallel.py's render_frame_banded set-up: JAX on its
    4-rank gauss mesh, the port on 4 gloo ranks, and the port's one-rank
    pipeline render."""
    rng = np.random.default_rng(5)
    jstate, jd = tiny_state(rng, n=64, cap=64)
    # language features to render (tiny_state's are zero)
    lang = rng.normal(size=(64, 3)).astype(np.float32)
    jstate = jstate.replace(params=dict(jstate.params,
                                        language_feature=jnp.asarray(lang)))
    h = w = 64
    cam = make_camera(h, w)
    budget = 1024
    js = JR.RasterSettings(h, w, sh_degree=3, lang_dim=3,
                           include_feature=True, tile_capacity=64,
                           composite_chunk=budget)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    t = 0.6
    want = {}
    with pltpu.force_tpu_interpret_mode():
        for ex in ("allgather", "alltoall"):
            want[ex] = JPR.render_frame_banded(
                js, jd, "fine-lang", cam, jnp.asarray(t, jnp.float32),
                jstate.gaussians(), jstate.params["deform"], jstate.aabb,
                jnp.asarray(bg), JM.make_mesh(D, data=1, gauss=D),
                tiers=((3, 64), (6, 64), (16, 64)), budget=budget,
                exchange=ex)
    dcfg = DeformConfig(**{f.name: getattr(jd, f.name)
                           for f in dataclasses.fields(DeformConfig)})
    tstate = train_state_from_jax(jstate, dcfg, device="cpu")
    d = dict(settings=TR.RasterSettings(h, w, sh_degree=3, tile_size=16),
             dcfg=dcfg, stage="fine-lang", cam=_torch_cam(cam), time=t,
             gs=tstate.gaussians(), net=tstate.deform, aabb=tstate.aabb,
             bg=torch.from_numpy(bg))
    base = tmp_path_factory.mktemp("frame")
    torch.save(d, base / "in.pt")
    ranks.spawn(ranks.frame_banded, D, base, str(base / "in.pt"),
                str(base / "out.pt"))
    got = torch.load(f"{base / 'out.pt'}.0", weights_only=False)
    with torch.no_grad():
        one = TP.render(d["settings"], dcfg, "fine-lang", d["cam"], t,
                        d["gs"], d["net"], d["aabb"], d["bg"])
    return want, got, one


@pytest.mark.parametrize("exchange", ["allgather", "alltoall"])
def test_frame_banded_matches_jax(frames, exchange):
    want, got, one = frames
    for key in ("render", "language_feature_image", "depth"):
        w = np.asarray(want[exchange][key])
        assert np.abs(w).max() > 0.1, key
        np.testing.assert_allclose(got[exchange][key].numpy(), w,
                                   **JAX_TOL, err_msg=key)
        # the deformation of a block of rows is elementwise, as is the
        # preprocess: the frame is the one-rank render's, bit for bit
        assert torch.equal(got[exchange][key], one[key]), key
    assert got[exchange]["dropped"] == 0


CLI_CONFIG = """
ModelHiddenParams = dict(
    kplanes_config=dict(grid_dimensions=2, input_coordinate_dim=4,
                        output_coordinate_dim=4, resolution=[8, 8, 8, 4]),
    multires=[1], net_width=16, posebase_pe=2, no_dlang=0)
OptimizationParams = dict(max_points=100)
capacity_granule = 128
render_tile_size = 16
gaussian_shards = {shards}
"""


def test_render_cli_on_two_ranks_matches_one(tmp_path):
    """`python -m langsplat4d_torch.render` (its main) on two gloo ranks
    with gaussian_shards = 2 writes the one-process CLI's files."""
    from langsplat4d_torch.config import Config, apply_overrides
    from langsplat4d_torch.config import load_py_config, save_cfg_args
    from langsplat4d_torch.data.scene import Scene
    from langsplat4d_torch.render.__main__ import main as render_main
    from langsplat4d_torch.train.loop import init_state_from_scene, save_scene
    from tests.scene_fixture import make_nerfies_scene

    root = str(tmp_path / "scene")
    make_nerfies_scene(root, n_imgs=8, hw=32, n_points=100)
    cfg_files = {}
    for shards in (1, 2):
        cfg_files[shards] = str(tmp_path / f"cfg{shards}.py")
        with open(cfg_files[shards], "w") as f:
            f.write(CLI_CONFIG.format(shards=shards))
    models = {}
    for shards in (1, 2):
        cfg = Config()
        apply_overrides(cfg, load_py_config(cfg_files[shards]))
        cfg.model.source_path = root
        cfg.model.language_features_name = "language_features"
        cfg.model.feature_level = 1
        cfg.model.model_path = models[shards] = str(tmp_path / f"m{shards}")
        state, _ = init_state_from_scene(cfg, Scene(root), device="cpu")
        g = torch.Generator().manual_seed(1)
        lf = state.params["language_feature"]
        lf[:state.num_active] = torch.randn(
            (state.num_active, lf.shape[1]), generator=g)
        save_scene(cfg, state, 0, "fine-lang", cfg.model.model_path)
        save_cfg_args(cfg, cfg.model.model_path)

    def argv(shards):
        return ["--model_path", models[shards], "--source_path", root,
                "--configs", cfg_files[shards], "--mode", "lang",
                "--skip_train", "--skip_video", "--novideo", "1",
                "--device", "cpu"]
    render_main(argv(1))
    ranks.spawn(ranks.render_cli, 2, tmp_path, argv(2),
                str(tmp_path / "fps.pt"))
    one = sorted(glob.glob(os.path.join(models[1], "test_lang", "ours_0",
                                        "renders_npy", "*.npy")))
    two = sorted(glob.glob(os.path.join(models[2], "test_lang", "ours_0",
                                        "renders_npy", "*.npy")))
    assert one and [os.path.basename(p) for p in one] == [
        os.path.basename(p) for p in two]
    for a, b in zip(one, two):
        x, y = np.load(a), np.load(b)
        assert np.abs(x).max() > 0.1
        np.testing.assert_allclose(y, x, rtol=0, atol=5e-4)
    pngs = glob.glob(os.path.join(models[2], "test_lang", "ours_0",
                                  "renders", "*.png"))
    assert len(pngs) == len(one)
    fps = [torch.load(f"{tmp_path / 'fps.pt'}.{r}", weights_only=False)
           for r in range(2)]
    assert set(fps[0]) == set(fps[1]) == {"test"}


def test_faults_raise(tmp_path):
    """A world of another size than data x gauss raises, on every rank; a
    band request on one rank raises, in make_mesh and in render_set,
    before any frame."""
    ranks.spawn(ranks.mesh_faults, 2, tmp_path, str(tmp_path / "m.pt"))
    for r in range(2):
        msgs = torch.load(f"{tmp_path / 'm.pt'}.{r}", weights_only=False)
        assert msgs[0] and "needs 3 ranks but the world has 2" in msgs[0]
        assert msgs[1] and "needs 4 ranks but the world has 2" in msgs[1]
    with pytest.raises(ValueError, match="not fall back to one device"):
        make_mesh(1, 2)

    from langsplat4d_torch.config import Config
    from langsplat4d_torch.render.driver import render_set
    cfg = Config()
    cfg.model.model_path = str(tmp_path / "model")
    cfg.runtime.gaussian_shards = 2
    with pytest.raises(ValueError, match="needs 2 ranks but the world has 1"):
        render_set(cfg, None, None, None, "video", 0, [None])
    assert not os.path.exists(cfg.model.model_path)
