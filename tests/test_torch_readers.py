"""Every scene format through both packages' Scene, field by field: COLMAP
(binary and text models, JPEG frames), Blender / D-NeRF (RGBA frames
composited and resized to 800x800, with and without fused.ply), HyperNeRF
(nerfies), Neu3D (dynerf), MultipleView and PanopticSports (JPEG frames),
each written tiny by the writers of chip_smoke.py's phases 26-27 from a
seeded workload rendered by the port. Compared exactly: the splits, every
camera's R, T (or K and w2c), fields of view, time, size, name, path and
matrices, every decoded image, the nerf normalization, the point cloud and
the video cameras. Also Neu3DDataset at 64x48 with its spiral, the dynerf
language files, a Panoptic camera's CameraParams and a render through both
packages, preprocess_neu3d, and the reference faults the port keeps for
parity (ROADMAP queue 3): the 300-frame mapping, the cut at the path's
first dot, and PanopticSports' missing camera_params_np."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke as S
from langsplat4d.data import panoptic as JPAN
from langsplat4d.data import readers as JR
from langsplat4d.data import scene as JS
from langsplat4d.preprocess import preprocess_neu3d as j_pre
from langsplat4d_torch.data import panoptic as TPAN
from langsplat4d_torch.data import readers as TR
from langsplat4d_torch.data import scene as TS
from langsplat4d_torch.preprocess import preprocess_neu3d as t_pre
from tests.scene_fixture import make_nerfies_scene

SPLITS = ("getTrainCameras", "getTestCameras", "getVideoCameras")
CAM_FIELDS = ("fovx", "fovy", "time", "width", "height", "image_name",
              "image_path", "colmap_id", "uid", "cam_name", "image_resize",
              "image_filt")
DYNERF_DOWNSAMPLE = 21.125          # the reader's 1352x1014 -> 64x48


@pytest.fixture(scope="module")
def workload():
    # 200 Gaussians: the CPU compositor loops over a tile's longest list,
    # so the scenes' ~60 renders stay cheap
    gs, dcfg, net, aabb, _ = S.bench_workload(torch.device("cpu"), frames=1,
                                              n=200, hw=(40, 48))
    return gs, dcfg, net, aabb


WRITERS = {
    "colmap": lambda d, w: S.write_colmap_scene(d, CPU, w, n_imgs=10),
    "colmap_text": lambda d, w: S.write_colmap_scene(d, CPU, w, n_imgs=9,
                                                     text=True),
    "blender": lambda d, w: S.write_blender_scene(d, CPU, w),
    "blender_seeded_cloud": lambda d, w: S.write_blender_scene(
        d, CPU, w, fused=False),
    "nerfies": lambda d, w: make_nerfies_scene(d, n_imgs=8, hw=40,
                                               n_points=60),
    "dynerf": lambda d, w: S.write_dynerf_scene(
        d, CPU, w, cams=4, frames=3, downsample=DYNERF_DOWNSAMPLE,
        n_init=300),
    "multipleview": lambda d, w: S.write_multipleview_scene(d, CPU, w),
    "panoptic": lambda d, w: S.write_panoptic_scene(d, CPU, w),
}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scenes(workload, tmp_path_factory):
    base = tmp_path_factory.mktemp("formats")
    out = {}
    for name, write in WRITERS.items():
        out[name] = str(base / name)
        write(out[name], workload)
    return out


def _same_camera(a, b, where, image=True):
    if isinstance(a, JPAN.PanopticCamera):
        assert isinstance(b, TPAN.PanopticCamera), where
        np.testing.assert_array_equal(b.K, a.K)
        np.testing.assert_array_equal(b.w2c, a.w2c)
        fields = ("time", "width", "height", "image_name", "image_path",
                  "colmap_id", "uid")
    else:
        np.testing.assert_array_equal(b.R, a.R, err_msg=where)
        np.testing.assert_array_equal(b.T, a.T, err_msg=where)
        fields = CAM_FIELDS
    for f in fields:
        assert getattr(b, f) == getattr(a, f), (where, f)
    for m in ("world_view_transform", "full_proj_transform",
              "camera_center"):
        np.testing.assert_array_equal(getattr(b, m), getattr(a, m),
                                      err_msg=f"{where} {m}")
    if image and a.image_path is not None:
        ai, bi = a.image, b.image
        assert bi.dtype == np.float32 and bi.shape == ai.shape, where
        np.testing.assert_array_equal(bi, ai, err_msg=where)


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_scene_matches_jax(name, scenes):
    root = scenes[name]
    np.random.seed(27)              # Blender's cloud without fused.ply
    j = JS.Scene(root)
    np.random.seed(27)
    t = TS.Scene(root)
    assert t.dataset_type == j.dataset_type
    assert t.maxtime == j.maxtime
    assert t.cameras_extent == j.cameras_extent
    for k, v in j.scene_info.nerf_normalization.items():
        np.testing.assert_array_equal(t.scene_info.nerf_normalization[k], v)
    assert t.scene_info.ply_path == j.scene_info.ply_path
    np.testing.assert_array_equal(t.aabb, j.aabb)
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(t.point_cloud, f),
                                      getattr(j.point_cloud, f))
    for split in SPLITS:
        jc, tc = getattr(j, split)(), getattr(t, split)()
        assert len(tc) == len(jc), split
        for i in range(len(jc)):
            # Neu3D decodes each frame resized to 1352x1014 (lanczos): two
            # cameras a split are enough for the images
            image = name != "dynerf" or i < 2
            _same_camera(jc[i], tc[i], f"{name} {split} {i}", image=image)
    if name.startswith("blender"):
        assert t.getTrainCameras()[0].image.shape == (3, 800, 800)
    if name == "dynerf":
        assert t.getTrainCameras()[0].image.shape == (3, 1014, 1352)


def test_neu3d_dataset_at_64x48_with_its_spiral(scenes):
    root = scenes["dynerf"]
    for split in ("train", "test"):
        j = JR.Neu3DDataset(root, split, downsample=DYNERF_DOWNSAMPLE)
        t = TR.Neu3DDataset(root, split, downsample=DYNERF_DOWNSAMPLE)
        assert t.img_wh == j.img_wh == (64, 48)
        for f in ("image_paths", "image_times", "cams", "focal"):
            assert getattr(t, f) == getattr(j, f), f
        for f in ("val_poses", "near_fars", "poses_all"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        assert t.val_poses.shape == (300, 3, 4)
        for (rj, tj), (rt, tt) in zip(j.image_poses, t.image_poses):
            np.testing.assert_array_equal(rt, rj)
            np.testing.assert_array_equal(tt, tj)
        for i in range(len(j)):
            _same_camera(j[i], t[i], f"{split} {i}")
        for a, b in ((j.cam_infos(), t.cam_infos()),
                     (j.video_cam_infos(), t.video_cam_infos())):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y.R, x.R)
                np.testing.assert_array_equal(y.T, x.T)
                assert (y.FovX, y.FovY, y.time, y.width, y.height,
                        y.image_name) == (x.FovX, x.FovY, x.time, x.width,
                                          x.height, x.image_name)


def test_dynerf_language_files(scenes):
    """Both packages read each camera's language pair from the same file:
    the segments and features of every train and test camera agree, and
    the port's names are `cam_name-frame`."""
    root = scenes["dynerf"]
    lf = os.path.join(root, "language_features")
    for split in ("train", "test"):
        jd = JS.CameraDataset(JR.Neu3DDataset(root, split,
                                              DYNERF_DOWNSAMPLE), "dynerf")
        td = TS.CameraDataset(TR.Neu3DDataset(root, split,
                                              DYNERF_DOWNSAMPLE), "dynerf")
        for i in range(len(jd)):
            js_, jf = jd[i].get_language_feature_compact(lf, 1, split,
                                                         "dynerf")
            ts_, tf = td[i].get_language_feature_compact(lf, 1, split,
                                                         "dynerf")
            np.testing.assert_array_equal(ts_, js_)
            np.testing.assert_array_equal(tf, jf)
            cam = td[i]
            assert cam.language_feature_name(lf, split, "dynerf") == \
                os.path.join(lf, f"{cam.cam_name}-{i % 300:04}")
        assert td[0].language_feature_name(lf, "video", "dynerf") is None


def test_the_300_frame_mapping(scenes):
    """Queue 3: Neu3DDataset assumes 300 frames a camera (readers.py:489,
    534, 573 in the JAX package): with 3 frames a camera, every training
    frame is named after the first training camera and timed idx / 300, in
    both packages. The port follows it for parity."""
    root = scenes["dynerf"]
    for mod in (JR, TR):
        ds = mod.Neu3DDataset(root, "train", DYNERF_DOWNSAMPLE)
        assert ds.cams == ["cam01", "cam02", "cam03"]
        assert {ds[i].cam_name for i in range(len(ds))} == {"cam01"}
        assert ds.image_times[:4] == [0.0, 1 / 300, 2 / 300, 0.0]


def test_the_cut_at_the_first_dot(scenes, tmp_path):
    """Queue 3: the image directory is `video_path.split(".")[0]`
    (readers.py:524), cut at the first dot anywhere in the path. Under a
    dotted directory the JAX package looks for the frames elsewhere, finds
    a video it cannot open and gives an empty split; the port, which
    decodes no video, raises and names the video."""
    dotted = str(tmp_path / "scene.v1")
    shutil.copytree(scenes["dynerf"], dotted)
    j = JR.Neu3DDataset(dotted, "train", DYNERF_DOWNSAMPLE)
    assert len(j) == 0 and os.path.isdir(str(tmp_path / "scene" / "images"))
    shutil.rmtree(str(tmp_path / "scene"))
    with pytest.raises(NotImplementedError,
                       match=r"scene\.v1/cam01\.mp4.*extract the frames"):
        TR.Neu3DDataset(dotted, "train", DYNERF_DOWNSAMPLE)


def test_panoptic_has_no_camera_params_np(scenes):
    """Queue 3: a PanopticCamera has no camera_params_np in the JAX package
    (langsplat4d/data/panoptic.py:22-86), so its loop's `build_batch`
    cannot take one; the port's has none either and its `build_batch`
    fails alike."""
    from langsplat4d_torch.config import Config
    from langsplat4d_torch.train import loop
    scene = TS.Scene(scenes["panoptic"])
    cam = scene.getTrainCameras()[0]
    assert not hasattr(cam, "camera_params_np")
    assert not hasattr(JS.Scene(scenes["panoptic"]).getTrainCameras()[0],
                       "camera_params_np")
    with pytest.raises(AttributeError, match="camera_params_np"):
        loop.build_batch([cam], Config(), scene, 1, "cpu")


def test_panoptic_camera_params_and_render_match_jax():
    """A Panoptic camera with its principal point off the centre: the five
    CameraParams fields equal, and the golden checkpoint rendered through
    it by both packages within 5e-4 (the repo's cross-program bound)."""
    from langsplat4d.checkpoint import load_trained_model as j_load
    from langsplat4d.field.deformation import DeformConfig as JDC
    from langsplat4d.render import pipeline as JP
    from langsplat4d_torch.checkpoint import load_trained_model
    from langsplat4d_torch.field.deformation import DeformConfig
    from langsplat4d_torch.render import pipeline as TP
    from langsplat4d_torch.render import raster as TRR
    from tests.test_torch_render import (FIXTURE, HW, _cfg,
                                         _jax_stream_settings, _orbit_pose)
    R, T = _orbit_pose(0.2)
    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = R.T, T
    K = np.array([[64.0, 0, HW / 2 + 2.5], [0, 66.0, HW / 2 - 1.5],
                  [0, 0, 1]])
    kw = dict(width=HW, height=HW, K=K, w2c=w2c, time=0.4, image_path=None)
    jc, tc = JPAN.PanopticCamera(**kw), TPAN.PanopticCamera(**kw)
    jp, tp = jc.camera_params(), tc.camera_params("cpu")
    for f in tp._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    cfg = _cfg()
    jd = JDC.from_config(cfg.hidden, cfg.runtime)
    td = DeformConfig.from_config(cfg.hidden, cfg.runtime)
    jstate, _ = j_load(FIXTURE, "fine-lang", -1, jd)
    model, _ = load_trained_model(FIXTURE, "fine-lang", -1, td, device="cpu")
    bg = np.ones(3, np.float32)
    with pltpu.force_tpu_interpret_mode():
        js = _jax_stream_settings(jd, jstate, jp, 0.4, 16, "fine-lang")
        want = JP.render(js, jd, "fine-lang", jp, jnp.float32(0.4),
                         jstate.gaussians(), jstate.params["deform"],
                         jstate.aabb, jnp.asarray(bg))
    ts = TRR.RasterSettings(HW, HW, sh_degree=3, tile_size=16)
    with torch.no_grad():
        got = TP.render(ts, td, "fine-lang", tp, 0.4, model.gaussians,
                        model.deform, model.aabb, torch.from_numpy(bg))
    for key in ("render", "depth", "language_feature_image"):
        w = np.asarray(want[key])
        assert np.abs(w).max() > 0.1, key
        np.testing.assert_allclose(got[key].numpy(), w, atol=5e-4,
                                   err_msg=key)


def test_preprocess_neu3d_counts_as_jax(scenes, capsys):
    root = scenes["dynerf"]
    j_pre.main(["--datadir", root])
    want = capsys.readouterr().out
    assert t_pre.main(["--datadir", root]) == (9, 3)
    assert capsys.readouterr().out == want
    assert "train 9 images, test 3 images" in want


def test_load_callbacks_match_jax():
    assert sorted(TR.SCENE_LOAD_CALLBACKS) == sorted(JR.SCENE_LOAD_CALLBACKS)
    assert [m for m, _ in TS.MARKERS] == [
        "sparse", "transforms_train.json", "poses_bounds.npy",
        "dataset.json", "train_meta.json", "points3D_multipleview.ply"]
