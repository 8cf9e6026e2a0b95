"""Scene readers (port of langsplat4d/data/readers.py; reference
scene/dataset_readers.py and scene/hyper_loader.py). So far the HyperNeRF
(nerfies) format only; the COLMAP, Blender, Neu3D, multipleview and
panoptic readers are still to port, and `data/scene.py` raises
NotImplementedError for them.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from langsplat4d_torch.core import plyio
from langsplat4d_torch.core.transforms import focal2fov, world_to_view
from langsplat4d_torch.data.cameras import HostCamera
from langsplat4d_torch.data.png import read_png


@dataclass
class BasicPointCloud:
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


@dataclass
class CameraInfo:
    """Lazy camera record (reference CameraInfo, dataset_readers.py:33-45)."""
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovY: float
    FovX: float
    image: Optional[np.ndarray]        # [3, H, W] float32, or None if lazy
    image_path: Optional[str]
    image_name: Optional[str]
    width: int
    height: int
    time: float
    mask: Optional[np.ndarray] = None


@dataclass
class SceneInfo:
    point_cloud: BasicPointCloud
    train_cameras: list
    test_cameras: list
    video_cameras: list
    nerf_normalization: Dict
    ply_path: str
    maxtime: float


def load_image(path: str, resize=None, filt: str = "bicubic") -> np.ndarray:
    """[C, H, W] float32 in [0, 1]: k / 255 in float32 for each byte k, as
    the JAX package's codec gives (reference PILtoTorch,
    utils/general_utils.py:21-33). PNG only (`data/png.py`); a `resize`
    (the reference's antialiased PIL resize) is not ported yet and
    raises."""
    if resize is not None:
        raise NotImplementedError(
            f"{path}: resizing on load is not ported (filter {filt})")
    if not path.lower().endswith(".png"):
        raise NotImplementedError(f"{path}: only PNG images are read")
    arr = read_png(path)
    return np.ascontiguousarray(arr.transpose(2, 0, 1)).astype(
        np.float32) / np.float32(255.0)


def get_nerfpp_norm(cam_infos) -> Dict:
    """Camera-extent normalization (dataset_readers.py:56-77)."""
    centers = []
    for cam in cam_infos:
        w2c = world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = np.linalg.norm(centers - avg, axis=0).max()
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def fetch_ply(path: str) -> BasicPointCloud:
    props = plyio.read_ply(path)
    points = np.stack([props["x"], props["y"], props["z"]], axis=1)
    colors = np.stack([props["red"], props["green"], props["blue"]],
                      axis=1) / 255.0
    if "nx" in props:
        normals = np.stack([props["nx"], props["ny"], props["nz"]], axis=1)
    else:
        normals = np.zeros_like(points)
    return BasicPointCloud(points, colors, normals)


def store_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    arrays = {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": np.zeros(len(xyz)), "ny": np.zeros(len(xyz)),
        "nz": np.zeros(len(xyz)),
        "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
    }
    plyio.write_ply(path, arrays)


def add_points(pcd: BasicPointCloud, xyz_min, xyz_max,
               n: int = 100000) -> BasicPointCloud:
    """Random point augmentation (dataset_readers.py:428-440), drawn from
    numpy's global generator as the JAX package draws them."""
    extra = np.random.random((n, 3)) * (xyz_max - xyz_min) + xyz_min
    return BasicPointCloud(
        points=np.vstack([pcd.points, extra.astype(np.float32)]),
        colors=np.vstack([pcd.colors,
                          np.random.random((n, 3)).astype(np.float32)]),
        normals=np.vstack([pcd.normals,
                           np.random.random((n, 3)).astype(np.float32)]))


class HyperDataset:
    """Lazy HyperNeRF loader (scene/hyper_loader.py:37-186). Images load on
    demand from rgb/<1/ratio>x; time = normalized warp_id; the train/test
    split is every 4th image and the ones two after it (or the explicit
    val ids)."""

    def __init__(self, datadir, ratio=0.5, split="train"):
        datadir = os.path.expanduser(datadir)
        with open(f"{datadir}/scene.json") as f:
            scene_json = json.load(f)
        with open(f"{datadir}/metadata.json") as f:
            meta_json = json.load(f)
        with open(f"{datadir}/dataset.json") as f:
            dataset_json = json.load(f)

        self.near = scene_json["near"]
        self.far = scene_json["far"]
        self.coord_scale = scene_json["scale"]
        self.scene_center = scene_json["center"]
        self.all_img_ids = dataset_json["ids"]
        self.val_id = dataset_json["val_ids"]
        self.split = split
        if len(self.val_id) == 0:
            self.i_train = np.array(
                [i for i in np.arange(len(self.all_img_ids)) if i % 4 == 0])
            self.i_test = (self.i_train + 2)[:-1]
        else:
            train_id = dataset_json["train_ids"]
            self.i_test = [i for i, iid in enumerate(self.all_img_ids)
                           if iid in self.val_id]
            self.i_train = [i for i, iid in enumerate(self.all_img_ids)
                            if iid in train_id]

        all_time = [meta_json[i]["warp_id"] for i in self.all_img_ids]
        max_t = max(all_time)
        self.all_time = [t / max_t for t in all_time]
        self.max_time = max(self.all_time)
        self.ratio = ratio
        self.all_cam_params = []
        for im in self.all_img_ids:
            with open(f"{datadir}/camera/{im}.json") as f:
                cj = json.load(f)
            self.all_cam_params.append(dict(
                orientation=np.asarray(cj["orientation"]),
                position=np.asarray(cj["position"]),
                focal_length=cj["focal_length"] * ratio,
                image_size=np.asarray(cj["image_size"]),
            ))
        self.all_img = [f"{datadir}/rgb/{int(1 / ratio)}x/{i}.png"
                        for i in self.all_img_ids]
        # nerfies stores image_size as (W, H), at full resolution
        size = self.all_cam_params[0]["image_size"]
        self.w = int(size[0] * ratio)
        self.h = int(size[1] * ratio)
        cov = os.path.join(datadir, "covisible")
        self.image_mask = ([f"{datadir}/covisible/2x/val/{i}.png"
                            for i in self.all_img_ids]
                           if os.path.exists(cov) else None)
        self._cache: Dict[int, HostCamera] = {}

    def __len__(self):
        if self.split == "train":
            return len(self.i_train)
        if self.split == "test":
            return len(self.i_test)
        return len(self.all_img)

    def __getitem__(self, index) -> HostCamera:
        if self.split == "train":
            idx = self.i_train[index]
        elif self.split == "test":
            idx = self.i_test[index]
        else:
            idx = index
        return self._load(int(idx), index)

    def _load(self, idx: int, uid: int) -> HostCamera:
        if idx in self._cache:
            return self._cache[idx]
        cam = self.all_cam_params[idx]
        R = cam["orientation"].T
        T = -cam["position"] @ R
        mask = None
        if self.image_mask is not None and self.split == "test":
            mask = load_image(self.image_mask[idx])[0:1]
        # the image stays lazy (path-backed): the device GT cache keys it by
        # file identity, so revisits never decode the PNG again
        hc = HostCamera(
            colmap_id=uid, R=R, T=T,
            fovx=focal2fov(cam["focal_length"], self.w),
            fovy=focal2fov(cam["focal_length"], self.h), image=None,
            image_name=os.path.basename(self.all_img[idx]), uid=uid,
            time=self.all_time[idx], mask=None,
            image_path=self.all_img[idx],
            width=int(self.w), height=int(self.h))
        hc.mask = mask
        self._cache[idx] = hc
        return hc

    def cam_infos(self):
        """The split's cameras without images, for the normalization
        (format_hyper_data)."""
        idxs = self.i_train if self.split == "train" else self.i_test
        infos = []
        for uid, index in enumerate(idxs):
            cam = self.all_cam_params[index]
            R = cam["orientation"].T
            T = -cam["position"] @ R
            infos.append(CameraInfo(
                uid=uid, R=R, T=T,
                FovY=focal2fov(cam["focal_length"], self.h),
                FovX=focal2fov(cam["focal_length"], self.w),
                image=None, image_path=None, image_name=None,
                width=self.w, height=self.h, time=self.all_time[index]))
        return infos


def read_hyper_scene(datadir, ratio=0.5):
    """dataset_readers.py:374-402."""
    train_ds = HyperDataset(datadir, ratio, "train")
    test_ds = HyperDataset(datadir, ratio, "test")
    video_ds = HyperDataset(datadir, ratio, "video")
    norm = get_nerfpp_norm(train_ds.cam_infos())
    ply_path = os.path.join(datadir, "points3D_downsample2.ply")
    pcd = fetch_ply(ply_path)
    return SceneInfo(pcd, train_ds, test_ds, video_ds, norm, ply_path,
                     maxtime=train_ds.max_time)
