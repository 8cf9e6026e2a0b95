"""The port's utils that the train CLI imports (logging, profiling, the
viewer bridge's messages, the snapshots of utils/scene_vis) and the loop's
default outputs: the rgb|gt|lang|gt_lang grid against the JAX package's, the
render-process cadence, and the NaN forensics window."""
import io
import json
import logging
import os
import pickle
import socket
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from langsplat4d.train import loop as jloop
from langsplat4d.utils import scene_vis as jvis
from langsplat4d_torch.train import loop as tloop
from langsplat4d_torch.utils import scene_vis as tvis


def _read_text(canvas, n_chars, x=4, y=4):
    """The characters stamped at (x, y), matched glyph by glyph."""
    out = []
    for i in range(n_chars):
        x0 = x + i * tvis.ADVANCE
        cell = canvas[y:y + tvis.GLYPH_H * tvis.SCALE:tvis.SCALE,
                      x0:x0 + tvis.GLYPH_W * tvis.SCALE:tvis.SCALE, 0] > 127
        hits = [c for c, g in tvis.FONT.items() if np.array_equal(g, cell)]
        out.append(hits[0] if hits else "?")
    return "".join(out)


def test_snapshot_label_and_jpeg(tmp_path):
    """The triptych: GT | render | depth under a 24-px strip that carries
    the JAX package's label text (read back glyph by glyph), saved as
    {stage}_{iteration}.jpg; PIL decodes it, and it lies no farther from
    the canvas than PIL's own quality-75 file of the same canvas (mean and
    largest error; the port keeps the chroma at full resolution where PIL
    halves it)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:40, :56] / 12.0
    gt = np.stack([0.5 + 0.4 * np.sin(xx + c) * np.cos(yy)
                   for c in range(3)]).astype(np.float32)
    ren = np.clip(gt + 0.05, 0, 1)
    depth = rng.uniform(1, 3, size=(1, 40, 56)).astype(np.float32)
    label = tvis.label_text("fine-langtrain", 129, 75.5, 12345)
    assert label == "stage:fine-langtrain iter:129 time:01:15 points:12345"
    canvas = tvis.training_image(gt, ren, depth, label)
    assert canvas.shape == (40 + tvis.STRIP, 3 * 56, 3)
    np.testing.assert_array_equal(canvas[tvis.STRIP:, :56],
                                  jvis.to_image_u8(gt))
    np.testing.assert_array_equal(canvas[tvis.STRIP:, 112:],
                                  jvis.depth_colormap(depth))
    visible = (3 * 56 - 4) // tvis.ADVANCE
    assert _read_text(canvas, visible) == label[:visible]
    path = tvis.render_training_image(str(tmp_path), "fine-langtrain", 129,
                                      75.5, gt, ren, depth, 12345)
    assert os.path.basename(path) == "fine-langtrain_129.jpg"
    dec = np.asarray(Image.open(path)).astype(np.int64)
    buf = io.BytesIO()
    Image.fromarray(canvas).save(buf, format="JPEG")
    pil = np.asarray(Image.open(buf)).astype(np.int64)
    err, pil_err = np.abs(dec - canvas), np.abs(pil - canvas)
    assert dec.shape == canvas.shape
    assert err.mean() <= pil_err.mean() and err.max() <= pil_err.max(), (
        err.mean(), pil_err.mean(), err.max(), pil_err.max())


def test_glyphs_are_distinct():
    shapes = {c: g.tobytes() for c, g in tvis.FONT.items()}
    assert len(set(shapes.values())) == len(shapes)
    canvas = np.zeros((20, 30, 3), np.uint8)
    tvis.draw_text(canvas, "stage:9 beyond the edge", 4, 4)   # clipped
    assert canvas.any()


@pytest.mark.parametrize("mode,channels", [("rgb", 3), ("lang", 3),
                                           ("lang", 6)])
def test_image2save_matches_jax(mode, channels):
    """The grid's panels: rgb clipped, language maps taken to (x + 1) / 2
    and, wider than 3, to their top 3 principal components (scikit-learn's
    PCA in the JAX package, `pca3` in the port): within 1 grey level (the
    float rounding before the truncation to uint8)."""
    rng = np.random.default_rng(1)
    arr = rng.normal(size=(channels, 12, 17)).astype(np.float32)
    want = np.asarray(jloop._image2save(arr, mode)).astype(np.int64)
    got = tloop._image2save(arr, mode).astype(np.int64)
    assert got.shape == want.shape == (12, 17, 3)
    assert np.abs(got - want).max() <= 1


def test_debug_image_dump_matches_jax(tmp_path):
    from langsplat4d_torch.data.png import read_png
    rng = np.random.default_rng(2)
    imgs = [rng.uniform(size=(3, 9, 11)).astype(np.float32) for _ in range(2)]
    langs = [rng.normal(size=(3, 9, 11)).astype(np.float32) for _ in range(2)]
    jloop._debug_image_dump(str(tmp_path / "j"), "fine-lang", 100, *imgs,
                            *langs)
    path = tloop._debug_image_dump(str(tmp_path / "t"), "fine-lang", 100,
                                   *imgs, *langs)
    assert path == str(tmp_path / "t" / "training_output_img"
                       / "output_fine-lang_100.png")
    want = np.asarray(Image.open(tmp_path / "j" / "training_output_img"
                                 / "output_fine-lang_100.png"))
    got = read_png(path)
    assert got.shape == want.shape == (9, 44, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_render_process_cadence():
    """train.py:376-382: every 10 iterations below 1000, every 50 below
    3000, every 100 below 60000."""
    due = [i for i in range(1, 3200) if tloop.render_process_due(i)]
    assert due[:3] == [9, 19, 29] and 999 in due and 1049 in due
    assert 1009 not in due and 3099 in due and 3049 not in due


def test_host_writer_writes_every_job_and_raises(tmp_path):
    """The loop's writer processes: every job runs, on the tensors' values
    at submit time (a later in-place change does not reach it); at most
    MAX_PENDING wait; the processes run with one BLAS thread and leave the
    caller's environment as it was; a job's failure is raised on the
    caller's thread, at the next submit or at the stage's end."""
    import functools
    n = tloop.HostWriter.MAX_PENDING + 3
    t = torch.zeros(3)
    env = {k: os.environ.get(k) for k in tloop.HostWriter.WORKER_ENV}
    with tloop.HostWriter() as w:
        for i in range(n):
            t.fill_(i)
            w.submit([t], functools.partial(np.save,
                                            str(tmp_path / f"{i}.npy")))
            assert len(w._jobs) <= tloop.HostWriter.MAX_PENDING
    for i in range(n):
        np.testing.assert_array_equal(np.load(tmp_path / f"{i}.npy"),
                                      np.full(3, i, np.float32))
    assert {k: os.environ.get(k) for k in env} == env
    pool = tloop.HostWriter._pool()
    assert len(pool._processes) == tloop.HostWriter.WORKERS
    got = pool.submit(os.getenv, "OPENBLAS_NUM_THREADS").result()
    assert got == "1"
    missing = functools.partial(np.save, str(tmp_path / "no" / "x.npy"))
    with pytest.raises(FileNotFoundError):
        with tloop.HostWriter() as w:
            w.submit([t], missing)
    w = tloop.HostWriter()
    w.submit([t], missing)
    w._jobs[0].exception(120)
    with pytest.raises(FileNotFoundError):
        w.submit([t], missing)
    w.__exit__(ValueError, None, None)


def test_logging_and_seeds(tmp_path):
    from langsplat4d_torch.utils import logging as L
    logger = L.get_logger()
    assert logger is L.get_logger() and logger.level == logging.INFO
    path = L.add_file_sink(str(tmp_path / "log"), "run.log")
    try:
        logging.getLogger("langsplat4d_torch.train.loop").info("hello %d", 7)
        for h in logger.handlers:
            h.flush()
        with open(path) as f:
            assert "| INFO | hello 7" in f.read()
    finally:
        for h in list(logger.handlers):
            if getattr(h, "baseFilename", None) == path:
                logger.removeHandler(h)
                h.close()
    L.safe_state(5)
    a = (np.random.rand(), torch.rand(3))
    L.safe_state(5)
    b = (np.random.rand(), torch.rand(3))
    assert a[0] == b[0] and torch.equal(a[1], b[1])


def test_profiling(tmp_path):
    from langsplat4d_torch.utils import profiling as P
    P.enable_nan_debug(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        P.enable_nan_debug(False)
    assert not torch.is_anomaly_enabled()
    with P.trace(str(tmp_path / "trace")):
        with P.annotate("region"):
            torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "region" in f.read()
    timer = P.StepTimer(ema=0.5)
    timer.start()
    ms = timer.stop(torch.ones(2))
    assert ms >= 0 and timer.ema_ms == ms


def test_network_gui_messages():
    """A message of resolution 0 asks for no frame; a full one gives the
    MiniCam with the viewer's y and z axes turned back."""
    from langsplat4d_torch.utils import network_gui as G
    a, b = socket.socketpair()
    saved = G.conn
    G.conn = b
    try:
        for res in (0, 16):
            view = np.arange(16, dtype=np.float32).reshape(4, 4)
            msg = json.dumps({
                "resolution_x": res, "resolution_y": res, "train": False,
                "fov_y": 0.5, "fov_x": 0.6, "z_near": 0.1, "z_far": 9.0,
                "shs_python": False, "rot_scale_python": False,
                "keep_alive": True, "scaling_modifier": 1.0,
                "view_matrix": view.reshape(-1).tolist(),
                "view_projection_matrix": view.reshape(-1).tolist()}).encode()
            a.sendall(struct.pack("<I", len(msg)) + msg)
            out = G.receive()
            if res == 0:
                assert out == (None,) * 6
                continue
            cam = out[0]
            assert (cam.width, cam.height, cam.fovx) == (16, 16, 0.6)
            want = view.copy()
            want[:, 1:3] *= -1
            np.testing.assert_array_equal(cam.world_view_transform, want)
        G.send(b"xyz", "src")
        assert a.recv(64) == b"xyz" + struct.pack("<I", 3) + b"src"
    finally:
        G.conn = saved
        a.close()
        b.close()


def test_nan_forensics_window(tmp_path, monkeypatch):
    """With LS4D_NAN_FORENSICS set the loop keeps the last 12 steps'
    inputs (the state copied before each step) and checks the parameters
    at every 10th iteration; a non-finite one dumps the window as numpy
    arrays in one pickle and trips the watchdog."""
    from langsplat4d_torch.config import Config
    from langsplat4d_torch.data.scene import Scene
    from langsplat4d_torch.utils.timer import Timer
    from tests.scene_fixture import make_nerfies_scene
    root = str(tmp_path / "scene")
    make_nerfies_scene(root, n_imgs=8, hw=32, n_points=100)
    cfg = Config()
    cfg.model.source_path = root
    cfg.model.model_path = str(tmp_path / "model")
    os.makedirs(cfg.model.model_path)
    cfg.runtime.capacity_granule = 128
    cfg.runtime.tile_capacity = 128
    cfg.runtime.watchdog_execv = False
    cfg.optim.batch_size = 2
    cfg.optim.max_points = 100
    cfg.optim.densify_until_iter = 0
    cfg.extras.test_iterations = []
    cfg.hidden.kplanes_config = {
        "grid_dimensions": 2, "input_coordinate_dim": 4,
        "output_coordinate_dim": 4, "resolution": [8, 8, 8, 4]}
    cfg.hidden.multires = [1]
    cfg.hidden.net_width = 16
    scene = Scene(root)
    state, dcfg = tloop.init_state_from_scene(cfg, scene, device="cpu")
    inner = tloop.train_step_packed
    seen = []

    def poisoned(step_cfg, st, *a, **k):
        out = inner(step_cfg, st, *a, **k)
        seen.append(len(seen) + 1)
        if len(seen) == 14:
            st.params["opacity"][3] = float("nan")
        return out
    monkeypatch.setattr(tloop, "train_step_packed", poisoned)
    monkeypatch.setenv("LS4D_NAN_FORENSICS", "1")
    with pytest.raises(RuntimeError, match="params non-finite at "
                                           "iteration 20"):
        tloop.scene_reconstruction(cfg, scene, state, dcfg, "coarse-base",
                                   False, 30, Timer())
    dump = tmp_path / "model" / "nan_forensics_coarse-base_20.pkl"
    with open(dump, "rb") as f:
        data = pickle.load(f)
    window = data["window"]
    assert [w[0] for w in window] == list(range(9, 21))
    it, snap, batch = window[0]
    assert isinstance(snap["params"]["opacity"], np.ndarray)
    assert np.isfinite(snap["params"]["opacity"]).all()
    assert not np.isfinite(window[-1][1]["params"]["opacity"]).all()
    assert batch["gt_images"].shape == (2, 3, 32, 32)
    assert data["stage"] == "coarse-base"
