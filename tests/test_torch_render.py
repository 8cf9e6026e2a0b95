"""The slice as a whole: the committed golden checkpoint rendered by the JAX
package's stream path (the accelerator's path; Pallas in interpret mode) and
by the port, compared at 5e-4, the repo's cross-program bound
(tests/test_parallel.py:252); and one run of the port's render_set."""
import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from langsplat4d.checkpoint import load_trained_model as j_load
from langsplat4d.config import (Config, apply_overrides, load_cfg_args,
                                load_py_config)
from langsplat4d.data.cameras import HostCamera as JCamera
from langsplat4d.field.deformation import DeformConfig as JDeformConfig
from langsplat4d.render import pipeline as JP
from langsplat4d.render import raster as JR
from langsplat4d.render import stream as JS
from langsplat4d_torch.checkpoint import load_trained_model
from langsplat4d_torch.data.cameras import HostCamera
from langsplat4d_torch.field.deformation import DeformConfig
from langsplat4d_torch.render import pipeline as TP
from langsplat4d_torch.render import raster as TR
from langsplat4d_torch.render.driver import render_set

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "golden_quality")
HW = 64
FOV = 2 * np.arctan(0.5)        # the fixture scene's intrinsics at 64 px


def _cfg():
    cfg = Config()
    apply_overrides(cfg, load_py_config(os.path.join(FIXTURE,
                                                     "quality_cfg.py")))
    return load_cfg_args(FIXTURE, cfg)


def _orbit_pose(angle):
    """Camera on the fixture's radius-5 orbit, looking at the origin."""
    c = np.array([5 * np.sin(angle), 0.0, -5 * np.cos(angle)])
    z = -c / np.linalg.norm(c)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    r_w2c = np.stack([x, np.cross(z, x), z])
    return r_w2c.T, -r_w2c @ c


VIEWS = ((-0.3, 0.1), (0.25, 0.6), (0.0, 0.95))     # (angle, time)


@pytest.fixture(scope="module")
def golden():
    cfg = _cfg()
    jd = JDeformConfig.from_config(cfg.hidden, cfg.runtime)
    td = DeformConfig.from_config(cfg.hidden, cfg.runtime)
    jstate, it = j_load(FIXTURE, "fine-lang", -1, jd)
    model, it2 = load_trained_model(FIXTURE, "fine-lang", -1, td,
                                    device="cpu")
    assert it == it2 == 1200
    return cfg, jd, td, jstate, model


def _jax_stream_settings(jd, jstate, cam, time, tile_size, stage):
    """RasterSettings for the JAX stream path on this frame: span tiers
    autotuned on the frame's own deformed Gaussians (so nothing is clipped)
    and one composite chunk spanning the stream. The TPU kernel resets a
    pixel's T < 1e-4 stop at every g-slot chunk boundary; a single chunk
    gives the CUDA reference's per-pixel stop, which the port implements."""
    base = JR.RasterSettings(HW, HW, sh_degree=3, lang_dim=jd.lang_dim,
                             include_feature="base" not in stage,
                             tile_size=tile_size)
    gs = jstate.gaussians()
    a = JP.prepare_attributes(jd, stage, jnp.float32(time), gs,
                              jstate.params["deform"], jstate.aabb)
    prep = JR.preprocess(base, cam, a[0], jnp.zeros((gs.capacity, 2)), a[3],
                         a[1], a[2], a[4], None, active=gs.active_mask())
    vis = np.asarray(prep["visible"])
    spans = np.max(np.asarray(prep["rect_max"] - prep["rect_min"]), 1)[vis]
    tiers = JS.autotune_tiers(spans)
    ov = JS.stream_overflow(base, prep, tiers=tiers)
    assert int(ov["span_exceeded"]) == 0
    n_valid = int(JS.narrow_valid_count(base, prep, tiers=tiers))
    budget = -(-n_valid // 128) * 128
    return dataclasses.replace(
        base, stream_binning=True, stream_narrow_sort=True,
        stream_tiers=tiers, stream_budget=budget, composite_chunk=budget)


@pytest.mark.parametrize("stage,tile_size", [
    ("fine-lang", 16), ("fine-lang", 32), ("fine-base", 16)])
def test_golden_render_matches_jax_stream_path(golden, stage, tile_size):
    cfg, jd, td, jstate, model = golden
    bg = np.ones(3, np.float32)              # white_background
    for angle, t in VIEWS[:2]:
        R, T = _orbit_pose(angle)
        jcam = JCamera(colmap_id=0, R=R, T=T, fovx=FOV, fovy=FOV, image=None,
                       image_name="", uid=0, time=t, width=HW, height=HW)
        cam = jcam.camera_params()
        with pltpu.force_tpu_interpret_mode():
            js = _jax_stream_settings(jd, jstate, cam, t, tile_size, stage)
            want = JP.render(js, jd, stage, cam, jnp.float32(t),
                             jstate.gaussians(), jstate.params["deform"],
                             jstate.aabb, jnp.asarray(bg))
        tcam = HostCamera(R=R, T=T, fovx=FOV, fovy=FOV, width=HW, height=HW,
                          time=t).camera_params("cpu")
        ts = TR.RasterSettings(HW, HW, sh_degree=3,
                               include_feature="base" not in stage,
                               tile_size=tile_size)
        with torch.no_grad():
            got = TP.render(ts, td, stage, tcam, t, model.gaussians,
                            model.deform, model.aabb, torch.from_numpy(bg))
        keys = ["render", "depth"]
        if stage == "fine-lang":
            keys.append("language_feature_image")
        else:
            assert got["language_feature_image"] is None
        for key in keys:
            w = np.asarray(want[key])
            assert np.abs(w).max() > 0.1, key         # a real image
            np.testing.assert_allclose(got[key].numpy(), w, atol=5e-4,
                                       err_msg=f"{key} view {angle}")
        np.testing.assert_array_equal(got["visibility_filter"].numpy(),
                                      np.asarray(want["visibility_filter"]))


@pytest.mark.parametrize("mode", ["lang", "rgb"])
def test_render_set(golden, tmp_path, capsys, mode):
    cfg, _, td, _, model = golden
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, model_path=str(tmp_path)))
    views = []
    for angle, t in VIEWS:
        R, T = _orbit_pose(angle)
        views.append(HostCamera(R=R, T=T, fovx=FOV, fovy=FOV, width=HW,
                                height=HW, time=t))
    views[0].image = np.full((3, HW, HW), 0.5, np.float32)
    fps = render_set(cfg, model, td, None, "video", 1200, views, mode=mode,
                     load_stage="fine-lang", novideo=True)
    out = capsys.readouterr().out
    m = re.search(r"^FPS: (\S+)$", out, re.M)
    assert m and float(m.group(1)) == fps > 0
    base = tmp_path / f"video_{mode}" / "ours_1200"
    npys = sorted(os.listdir(base / "renders_npy"))
    assert npys == [f"{i:05d}.npy" for i in range(len(VIEWS))]
    assert sorted(os.listdir(base / "renders")) == [
        f"{i:05d}.png" for i in range(len(VIEWS))]
    frame = np.load(base / "renders_npy" / npys[-1])
    assert frame.shape == (HW, HW, 3) and np.isfinite(frame).all()
    # the saved frame is the pipeline's render of that view
    settings = TR.RasterSettings(HW, HW, sh_degree=3,
                                 tile_size=cfg.runtime.render_tile_size)
    with torch.no_grad():
        direct = TP.render(settings, td, "fine-lang",
                           views[-1].camera_params("cpu"), views[-1].time,
                           model.gaussians, model.deform, model.aabb,
                           torch.ones(3))
    key = "render" if mode == "rgb" else "language_feature_image"
    np.testing.assert_array_equal(frame,
                                  direct[key].permute(1, 2, 0).numpy())
    if mode == "rgb":
        assert os.listdir(base / "gt_npy") == ["00000.npy"]
