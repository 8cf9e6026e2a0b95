"""The port's train and render CLIs (`python -m langsplat4d_torch.train` /
`.render`, their `main(argv)`) against the root train.py and render.py on a
tiny nerfies scene that tests/scene_fixture.py writes, on the CPU.

Both trainings start from the same state: the JAX CLI's initial state
(whose deformation weights come from JAX's generator) is carried into the
port's run through `interop.train_state_from_jax`. The config keeps the
runs short and comparable: coarse-lang 100 iterations (the rgb|gt|lang|gt_lang
grid comes at iteration 100), fine-lang 10, the other stages off,
densification off, render-process snapshots on (the hypernerf presets' own
setting), tile capacity 128 = the JAX composite chunk and 16-px tiles in
both packages' renders, where the two stop rules coincide (ROADMAP queue 3).
Compared: the saved point clouds, `deformation.pth` and the rendered .npy
maps in rgb and lang, within 5e-4 (the loop's and the render's bound,
tests/test_torch_loop.py, the repo's cross-program bound); the output tree
(`training_output_img/`, `render_process/`, `log/`, `renders*/`); the
strict train parser and the render parser that passes unknown flags on;
and the viewer bridge, as tests/test_e2e.py checks the JAX package's, on a
free port.
"""
import glob
import json
import os
import socket
import struct

import jax
import numpy as np
import pytest
import torch

import render as j_render
import train as j_train
from langsplat4d.train import loop as jloop
from langsplat4d_torch.core import plyio
from langsplat4d_torch.field.deformation import DeformConfig
from langsplat4d_torch.interop import train_state_from_jax
from langsplat4d_torch.render import __main__ as t_render
from langsplat4d_torch.train import __main__ as t_train
from langsplat4d_torch.train import loop as tloop
from tests.scene_fixture import make_nerfies_scene

TOL = 5e-4
ITER = 10            # fine-lang's budget: its save and checkpoint mark
CONFIG = """
ModelHiddenParams = dict(
    kplanes_config=dict(grid_dimensions=2, input_coordinate_dim=4,
                        output_coordinate_dim=4, resolution=[8, 8, 8, 4]),
    multires=[1], net_width=16, posebase_pe=2, no_dlang=0)
ModelParams = dict(render_process=True)
OptimizationParams = dict(coarse_base_iterations=0,
                          coarse_lang_iterations=100,
                          fine_base_iterations=0, fine_lang_iterations=10,
                          densify_until_iter=0, max_points=100)
capacity_granule = 128
tile_capacity = 128
render_tile_size = 16
"""


def _train_argv(root, model, cfg_file, expname):
    return ["--source_path", root, "--model_path", model,
            "--language_features_name", "language_features",
            "--feature_level", "1", "--expname", expname,
            "--configs", cfg_file, "--save_iterations", str(ITER),
            "--checkpoint_iterations", str(ITER), "--port", "-1"]


def _render_argv(root, model, mode, cfg_file):
    # --configs again: cfg_args keeps no runtime field (tile sizes and
    # capacities); --not_a_flag: render.py hands unknown flags to the
    # config parser, which ignores them
    return ["--model_path", model, "--source_path", root, "--mode", mode,
            "--configs", cfg_file, "--skip_train", "--skip_video",
            "--novideo", "1", "--not_a_flag", "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    root = str(base / "scene")
    make_nerfies_scene(root, n_imgs=8, hw=32, n_points=100)
    cfg_file = str(base / "tiny.py")
    with open(cfg_file, "w") as f:
        f.write(CONFIG)
    models = {k: str(base / k) for k in ("jax", "port")}
    mp = pytest.MonkeyPatch()
    mp.setenv("ExpsDir", str(base / "exps"))
    init = {}
    j_init = jloop.init_state_from_scene

    def keep_init(cfg, scene, seed=0):
        init["state"], init["dcfg"] = j_init(cfg, scene, seed=seed)
        return init["state"], init["dcfg"]

    def same_init(cfg, scene, seed=0, device=None):
        dcfg = DeformConfig.from_config(cfg.hidden, cfg.runtime,
                                        max_sh_degree=cfg.model.sh_degree)
        return (train_state_from_jax(jax.device_get(init["state"]), dcfg,
                                     device=device), dcfg)
    loggers = [__import__("logging").getLogger(n)
               for n in ("langsplat4d", "langsplat4d_torch")]
    handlers = [list(lg.handlers) for lg in loggers]
    mp.setattr(jloop, "init_state_from_scene", keep_init)
    mp.setattr(tloop, "init_state_from_scene", same_init)
    try:
        j_train.main(_train_argv(root, models["jax"], cfg_file, "jax"))
        t_train.main(_train_argv(root, models["port"], cfg_file, "port")
                     + ["--device", "cpu"])
        for mode in ("rgb", "lang"):
            j_render.main(_render_argv(root, models["jax"], mode, cfg_file))
            t_render.main(_render_argv(root, models["port"], mode, cfg_file)
                          + ["--device", "cpu"])
    finally:
        mp.undo()
        for lg, hs in zip(loggers, handlers):
            for h in lg.handlers[len(hs):]:
                lg.removeHandler(h)
                h.close()
    return dict(root=root, models=models, exps=str(base / "exps"),
                cfg_file=cfg_file)


def _tree(path):
    return sorted(os.path.relpath(p, path)
                  for p in glob.glob(os.path.join(path, "**"),
                                     recursive=True) if p != path + os.sep)


def test_saved_models_match_jax(runs):
    """The fine-lang point cloud and deformation.pth of both CLIs."""
    m = runs["models"]
    rel = os.path.join("point_cloud", f"fine-lang_iteration_{ITER}")
    j = plyio.read_ply(os.path.join(m["jax"], rel, "point_cloud.ply"))
    t = plyio.read_ply(os.path.join(m["port"], rel, "point_cloud.ply"))
    assert sorted(j) == sorted(t) and len(j["x"]) == 100
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=TOL, err_msg=k)
    js = torch.load(os.path.join(m["jax"], rel, "deformation.pth"),
                    weights_only=True)
    ts = torch.load(os.path.join(m["port"], rel, "deformation.pth"),
                    weights_only=True)
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=0,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("mode", ["rgb", "lang"])
def test_rendered_maps_match_jax(runs, mode):
    m = runs["models"]
    rel = os.path.join(f"test_{mode}", f"ours_{ITER}", "renders_npy")
    names = sorted(os.listdir(os.path.join(m["jax"], rel)))
    assert names and sorted(os.listdir(os.path.join(m["port"], rel))) == names
    for n in names:
        want = np.load(os.path.join(m["jax"], rel, n))
        got = np.load(os.path.join(m["port"], rel, n))
        assert got.shape == want.shape == (32, 32, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=n)


def test_output_trees_match(runs):
    """The same files under training_output_img/ (the grid at iteration
    100), render_process/ (the triptychs at iterations 9, 19, ... of each
    stage, one per split), each split's renders/ and renders_npy/, and one
    log file under <ExpsDir>/<expname>/log. The port's triptychs are JPEG,
    the grid PNG, as the JAX package writes them."""
    m = runs["models"]
    for sub in ("training_output_img", "render_process", "point_cloud",
                *(os.path.join(f"test_{mode}", f"ours_{ITER}", d)
                  for mode in ("rgb", "lang")
                  for d in ("renders", "renders_npy", "gt", "gt_npy"))):
        want = _tree(os.path.join(m["jax"], sub))
        assert want, sub
        assert _tree(os.path.join(m["port"], sub)) == want, sub
    assert _tree(os.path.join(m["port"], "training_output_img")) == [
        "output_coarse-lang_100.png"]
    snaps = _tree(os.path.join(m["port"], "render_process"))
    assert "coarse-langtest_99.jpg" in snaps and "fine-langtrain_9.jpg" in \
        snaps
    with open(os.path.join(m["port"], "render_process", snaps[0]),
              "rb") as f:
        assert f.read(2) == b"\xff\xd8"
    for name in ("jax", "port"):
        logs = os.listdir(os.path.join(runs["exps"], name, "log"))
        assert len(logs) == 1 and logs[0].endswith("_train.log")
        with open(os.path.join(runs["exps"], name, "log", logs[0])) as f:
            assert "Optimizing" in f.read()


def test_parsers_and_device(runs, tmp_path):
    """train.py parses strictly in both packages; without --device the
    port's CLIs go to the GPU and raise where there is none."""
    argv = _train_argv(runs["root"], str(tmp_path / "m"), runs["cfg_file"],
                       "x")
    for main in (j_train.main, t_train.main):
        with pytest.raises(SystemExit):
            main(argv + ["--not_a_flag", "1"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLIs would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_render.main(_render_argv(runs["root"], runs["models"]["port"],
                                   "rgb", runs["cfg_file"]))
    assert not os.path.exists(tmp_path / "m")


def test_viewer_bridge_sends_the_frame(runs):
    """A viewer on the TCP bridge (network_gui's protocol: a 4-byte
    little-endian length and JSON in; the RGB bytes, then the source path's
    length and text out) gets the frame of the camera it asked for,
    rendered from the state at the cycled video time: byte for byte the
    port's render of that camera."""
    from langsplat4d_torch.config import load_cfg_args, Config
    from langsplat4d_torch.data.cameras import MiniCam
    from langsplat4d_torch.data.scene import Scene
    from langsplat4d_torch.render.pipeline import render
    from langsplat4d_torch.render.raster import CameraParams
    from langsplat4d_torch.train.optim import LRConfig
    from langsplat4d_torch.train.step import StepConfig
    from langsplat4d_torch.render.raster import RasterSettings
    from langsplat4d_torch.utils import network_gui
    model = runs["models"]["port"]
    cfg = load_cfg_args(model, Config())
    state, _ = tloop.load_checkpoint(
        os.path.join(model, f"chkpnt_fine-lang_{ITER}.pth"), device="cpu")
    scene = Scene(runs["root"], model_path=model)
    dcfg = DeformConfig.from_config(cfg.hidden, cfg.runtime)
    step_cfg = StepConfig(
        settings=RasterSettings(image_height=32, image_width=32,
                                sh_degree=0, tile_capacity=128),
        dcfg=dcfg, lr_cfg=LRConfig.from_optim(cfg.optim, 1.0),
        stage="fine-lang")
    cam = scene.getTrainCameras()[1]
    w, h = 40, 24
    view = cam.world_view_transform.astype(np.float32).copy()
    proj = cam.full_proj_transform.astype(np.float32).copy()
    view[:, 1:3] *= -1           # the viewer's convention, undone on receipt
    proj[:, 1] *= -1
    msg = json.dumps({
        "resolution_x": w, "resolution_y": h, "train": True,
        "fov_y": cam.fovy, "fov_x": cam.fovx, "z_near": 0.01, "z_far": 100.0,
        "shs_python": False, "rot_scale_python": False, "keep_alive": True,
        "scaling_modifier": 1.0, "view_matrix": view.reshape(-1).tolist(),
        "view_projection_matrix": proj.reshape(-1).tolist()}).encode()
    network_gui.init("127.0.0.1", 0)
    client = socket.create_connection(network_gui.listener.getsockname())
    try:
        client.sendall(struct.pack("<I", len(msg)) + msg)
        bg = torch.ones(3)
        ctx = {}
        tloop._gui_poll(cfg, scene, state, step_cfg, "fine-lang", 1, ITER,
                        bg, ctx)
        client.settimeout(10)
        src = cfg.model.source_path
        want = w * h * 3 + 4 + len(src)
        buf = b""
        while len(buf) < want:
            part = client.recv(65536)
            assert part, "the bridge closed before the whole frame"
            buf += part
        assert struct.unpack("<I", buf[w * h * 3:w * h * 3 + 4])[0] == \
            len(src) and buf[w * h * 3 + 4:].decode() == src
        frame = np.frombuffer(buf[:w * h * 3], np.uint8).reshape(h, w, 3)
        mini = MiniCam(w, h, cam.fovy, cam.fovx, 0.01, 100.0,
                       cam.world_view_transform.astype(np.float32),
                       cam.full_proj_transform.astype(np.float32))
        video = scene.getVideoCameras()
        t = float(video[1 % len(video)].time)          # the first request
        cp = CameraParams(
            viewmatrix=torch.from_numpy(mini.world_view_transform),
            projmatrix=torch.from_numpy(mini.full_proj_transform),
            campos=torch.from_numpy(mini.camera_center.astype(np.float32)),
            tanfovx=torch.tensor(np.tan(cam.fovx * 0.5), dtype=torch.float32),
            tanfovy=torch.tensor(np.tan(cam.fovy * 0.5), dtype=torch.float32))
        settings = RasterSettings(image_height=h, image_width=w, sh_degree=0,
                                  tile_capacity=128)
        with torch.no_grad():
            out = render(settings, dcfg, "fine-lang", cp, t,
                         state.gaussians(), state.deform, state.aabb, bg)
        img = torch.clamp(out["render"], 0, 1).numpy()
        np.testing.assert_array_equal(
            frame, (img * 255).astype(np.uint8).transpose(1, 2, 0))
        assert frame.std() > 0 and ctx["count"] == 1
        client.close()
        tloop._gui_poll(cfg, scene, state, step_cfg, "fine-lang", 2, ITER,
                        bg, ctx)                # a hang-up drops the viewer
        assert network_gui.conn is None
    finally:
        client.close()
        network_gui.close()
