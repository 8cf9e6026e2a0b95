"""The port's scene input against the JAX package's, on the fixture scenes
that tests/scene_fixture.py writes (make_structured_scene,
make_nerfies_scene): splits, cameras (R, T, fields of view, times, sizes,
names, ids), the extent, the AABB and the point cloud, every decoded image,
every compact language pair and every gathered language map, and the
samplers' order for one seed. Everything is compared exactly: the same
bytes decode to the same float32 values (k / 255), and the rest is the same
host arithmetic. Also: the format sniffing on each marker, and both
packages refusing a directory that holds a marker and nothing else alike
(the other formats' readers: tests/test_torch_readers.py)."""
import os

import numpy as np
import pytest

from langsplat4d.data import scene as JS
from langsplat4d_torch.data import scene as TS
from langsplat4d_torch.data.cameras import (HostCamera, MiniCam,
                                            rotate_camera_around_center)
from tests.scene_fixture import make_nerfies_scene, make_structured_scene

SPLITS = ("getTrainCameras", "getTestCameras", "getVideoCameras")


@pytest.fixture(scope="module", params=["structured", "nerfies"])
def scene_dir(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(request.param) / "scene")
    if request.param == "structured":
        make_structured_scene(root, n_imgs=8, hw=48, clip_dim=3,
                              n_obj_points=40, n_bg_points=60)
    else:
        make_nerfies_scene(root, n_imgs=8, hw=40, n_points=60)
    return root


def test_scene_matches_jax(scene_dir):
    j, t = JS.Scene(scene_dir), TS.Scene(scene_dir)
    assert t.dataset_type == j.dataset_type == "nerfies"
    assert t.cameras_extent == j.cameras_extent
    assert t.maxtime == j.maxtime
    np.testing.assert_array_equal(t.aabb, j.aabb)
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(t.point_cloud, f),
                                      getattr(j.point_cloud, f))
    for split in SPLITS:
        jc, tc = getattr(j, split)(), getattr(t, split)()
        assert len(tc) == len(jc) > 0
        for i in range(len(jc)):
            a, b = jc[i], tc[i]
            np.testing.assert_array_equal(b.R, a.R)
            np.testing.assert_array_equal(b.T, a.T)
            for f in ("fovx", "fovy", "time", "width", "height",
                      "image_name", "colmap_id", "uid", "image_path"):
                assert getattr(b, f) == getattr(a, f), (split, i, f)
            np.testing.assert_array_equal(b.world_view_transform,
                                          a.world_view_transform)
            np.testing.assert_array_equal(b.full_proj_transform,
                                          a.full_proj_transform)
            assert b.image_file_backed and not b.image_materialized
            assert b.image.dtype == np.float32
            np.testing.assert_array_equal(b.image, a.image)
            assert b.image_file_backed and b.image_materialized


def test_language_ground_truth_matches_jax(scene_dir):
    j, t = JS.Scene(scene_dir), TS.Scene(scene_dir)
    lf = os.path.join(scene_dir, "language_features")
    names = {"getTrainCameras": "train", "getTestCameras": "test",
             "getVideoCameras": "video"}
    for split, name in names.items():
        jc, tc = getattr(j, split)(), getattr(t, split)()
        for i in range(len(jc)):
            for level in (0, 1, 3):
                a = jc[i].get_language_feature_compact(lf, level, name)
                b = tc[i].get_language_feature_compact(lf, level, name)
                assert b[0].dtype == a[0].dtype == np.int16
                np.testing.assert_array_equal(b[0], a[0])
                np.testing.assert_array_equal(b[1], a[1])
            fa, ma = jc[i].get_language_feature(lf, 1, name)
            fb, mb = tc[i].get_language_feature(lf, 1, name)
            assert fb.dtype == np.float32 and mb.dtype == bool
            np.testing.assert_array_equal(fb, fa)
            np.testing.assert_array_equal(mb, ma)
    assert tc[0].get_language_feature_compact(None, 1) == (None, None)


def test_samplers_match_jax(scene_dir):
    j, t = JS.Scene(scene_dir), TS.Scene(scene_dir)
    jc, tc = j.getVideoCameras(), t.getVideoCameras()
    assert (TS.FineSampler(tc, seed=3).sample_list
            == JS.FineSampler(jc, seed=3).sample_list)
    assert (TS.FineSampler(tc, num_poses=2, seed=1).sample_list
            == JS.FineSampler(jc, num_poses=2, seed=1).sample_list)
    for sampler in (None, "fine"):
        tl = TS.BatchLoader(tc, 3, seed=5, sampler=(
            TS.FineSampler(tc, seed=2) if sampler else None))
        jl = JS.BatchLoader(jc, 3, seed=5, sampler=(
            JS.FineSampler(jc, seed=2) if sampler else None))
        got = [[c.image_name for c in b] for b in tl]
        want = [[c.image_name for c in b] for b in jl]
        assert got == want
    assert TS.get_stamp_list(tc, 1, 2) == JS.get_stamp_list(jc, 1, 2)


@pytest.mark.parametrize("marker,kind", TS.MARKERS)
def test_sniff_each_marker(marker, kind, tmp_path):
    path = tmp_path / marker
    if "." in marker:
        path.write_text("")
    else:
        path.mkdir()
    assert TS.sniff_dataset_type(str(tmp_path)) == kind
    assert JS.sniff_dataset_type(str(tmp_path)) == kind
    # every reader is ported: a marker alone fails in both packages alike
    with pytest.raises(Exception) as j_err:
        JS.Scene(str(tmp_path))
    with pytest.raises(type(j_err.value)):
        TS.Scene(str(tmp_path))


def test_sniff_unknown(tmp_path):
    with pytest.raises(ValueError, match="Could not recognize"):
        TS.sniff_dataset_type(str(tmp_path))


def test_camera_helpers_match_jax():
    from langsplat4d.data import cameras as JC
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    kw = dict(R=q, T=rng.normal(size=3), fovx=0.9, fovy=0.7)
    a = JC.HostCamera(colmap_id=0, image=None, image_name="a", uid=0,
                      width=20, height=10, **kw)
    b = HostCamera(width=20, height=10, **kw)
    for angle, axis in ((17.0, "x"), (-40.0, "y"), (90.0, "z")):
        ra = JC.rotate_camera_around_center(a, angle, np.ones(3), axis)
        rb = rotate_camera_around_center(b, angle, np.ones(3), axis)
        np.testing.assert_array_equal(rb.R, ra.R)
        np.testing.assert_array_equal(rb.T, ra.T)
        assert rb is not b and np.array_equal(b.R, q)
    m = MiniCam(20, 10, 0.7, 0.9, 0.01, 100.0, b.world_view_transform,
                b.full_proj_transform, time=0.5)
    np.testing.assert_array_equal(m.camera_center, b.camera_center)


def test_eager_image_and_mask():
    """An image given to the constructor is clipped, sized and masked as in
    the JAX package; assigning one marks the camera as no longer
    file-backed."""
    from langsplat4d.data import cameras as JC
    rng = np.random.default_rng(1)
    img = rng.uniform(-0.2, 1.2, size=(4, 6, 5)).astype(np.float32)
    mask = (rng.uniform(size=(1, 6, 5)) > 0.5).astype(np.float32)
    a = JC.HostCamera(colmap_id=0, R=np.eye(3), T=np.zeros(3), fovx=1.0,
                      fovy=1.0, image=img, image_name="x", uid=0, mask=mask)
    b = HostCamera(R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=1.0,
                   image=img, mask=mask, image_path="x.png")
    np.testing.assert_array_equal(b.image, a.image)
    assert (b.height, b.width) == (a.height, a.width) == (6, 5)
    assert not b.image_file_backed
    b.image = img[:3]
    assert not b.image_file_backed
