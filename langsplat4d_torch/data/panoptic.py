"""PanopticSports reader (port of langsplat4d/data/panoptic.py; reference
readPanopticSportsinfos, scene/dataset_readers.py:543-608): per-frame
intrinsics K and world-to-camera matrices from train_meta.json and
test_meta.json, images under ims/, the initial cloud from init_pt_cld.npz.

A camera carries its explicit (K, w2c); the principal point enters through
the projection matrix as the reference's `setup_camera`
(dataset_readers.py:491-516) builds it. Like the JAX package's, a
PanopticCamera has no `camera_params_np`, so the training loop's
`build_batch` cannot take one: the JAX package reads and renders a
PanopticSports scene but does not train on it (ROADMAP, queue 3), and
neither does the port.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

ZNEAR, ZFAR = 0.01, 100.0


@dataclass
class PanopticCamera:
    """A camera with explicit intrinsics, in HostCamera's interface for
    rendering."""
    width: int
    height: int
    K: np.ndarray           # [3, 3]
    w2c: np.ndarray         # [4, 4]
    time: float
    image_path: Optional[str]
    colmap_id: int = 0
    uid: int = 0
    cam_name: Optional[str] = None
    image_name: str = ""
    _image: Optional[np.ndarray] = None

    @property
    def image(self) -> Optional[np.ndarray]:
        if self._image is None and self.image_path is not None:
            from langsplat4d_torch.data.readers import load_image
            self._image = load_image(self.image_path)[:3]
        return self._image

    @property
    def world_view_transform(self) -> np.ndarray:
        return self.w2c.T.astype(np.float32)

    @property
    def projection_matrix(self) -> np.ndarray:
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        w, h = self.width, self.height
        near, far = ZNEAR, ZFAR
        P = np.array([
            [2 * fx / w, 0.0, -(w - 2 * cx) / w, 0.0],
            [0.0, 2 * fy / h, -(h - 2 * cy) / h, 0.0],
            [0.0, 0.0, far / (far - near), -(far * near) / (far - near)],
            [0.0, 0.0, 1.0, 0.0],
        ], dtype=np.float32)
        return P.T

    @property
    def full_proj_transform(self) -> np.ndarray:
        return self.world_view_transform @ self.projection_matrix

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.w2c)[:3, 3].astype(np.float32)

    def camera_params(self, device):
        """The five tensors of render.raster.CameraParams on `device`."""
        from langsplat4d_torch.render.raster import CameraParams
        return CameraParams(
            viewmatrix=torch.as_tensor(self.world_view_transform,
                                       device=device),
            projmatrix=torch.as_tensor(self.full_proj_transform,
                                       device=device),
            campos=torch.as_tensor(self.camera_center, device=device),
            tanfovx=torch.as_tensor(np.float32(self.width
                                               / (2 * self.K[0, 0])),
                                    device=device),
            tanfovy=torch.as_tensor(np.float32(self.height
                                               / (2 * self.K[1, 1])),
                                    device=device))

    def get_language_feature(self, *a, **k):
        # no language ground truth for PanopticSports in the reference
        # either (scene/cameras.py:89-90 raises for unknown data types)
        return None, None


def read_panoptic_meta(datadir: str, json_path: str):
    """The cameras of one split (frame-major), the frame count and the
    extent of the first frame's camera centres."""
    with open(os.path.join(datadir, json_path)) as f:
        meta = json.load(f)
    w, h = meta["w"], meta["h"]
    max_time = len(meta["fn"])
    cams: List[PanopticCamera] = []
    uid = 0
    for index in range(max_time):
        time = index / max_time
        for K, w2c, fn in zip(meta["k"][index], meta["w2c"][index],
                              meta["fn"][index]):
            cams.append(PanopticCamera(
                width=w, height=h, K=np.asarray(K, np.float64),
                w2c=np.asarray(w2c, np.float64), time=time,
                image_path=os.path.join(datadir, "ims", fn),
                image_name=fn, uid=uid, colmap_id=uid))
            uid += 1
    centers = np.linalg.inv(np.asarray(meta["w2c"][0]))[:, :3, 3]
    radius = 1.1 * np.max(np.linalg.norm(
        centers - centers.mean(0)[None], axis=-1))
    return cams, max_time, radius


def read_panoptic_scene(datadir: str):
    """The train and test splits (the test split again as the video), the
    initial cloud, written to pointd3D.ply as the reference writes it."""
    from langsplat4d_torch.data.readers import (BasicPointCloud, SceneInfo,
                                                store_ply)
    train_cams, max_time, radius = read_panoptic_meta(datadir,
                                                      "train_meta.json")
    test_cams, _, _ = read_panoptic_meta(datadir, "test_meta.json")
    data = np.load(os.path.join(datadir, "init_pt_cld.npz"))["data"]
    xyz, rgb = data[:, :3], data[:, 3:6]
    pcd = BasicPointCloud(points=xyz, colors=rgb,
                          normals=np.ones((len(xyz), 3)))
    ply_path = os.path.join(datadir, "pointd3D.ply")
    store_ply(ply_path, xyz, rgb * 255.0)
    return SceneInfo(pcd, train_cams, test_cams, test_cams,
                     {"radius": radius, "translate": np.zeros(3)},
                     ply_path, maxtime=max_time)
