"""Host-side camera with the ground-truth language-feature fetch (port of
langsplat4d/data/cameras.py; reference scene/cameras.py:18-228).

View and projection matrices in the transposed row-vector convention the
rasterizer consumes (reference scene/cameras.py:62-66). The image is lazy
when the camera has an `image_path`: it is decoded on its first access, so a
camera whose ground truth already sits in the device cache
(data/gt_cache.py) costs no decode. The language ground truth comes from the
offline pipeline's `*_s.npy` segment maps and `*_f.npy` feature tables
(scene/cameras.py:69-118).
"""
from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from langsplat4d_torch.core.transforms import projection_matrix, world_to_view

ZNEAR, ZFAR = 0.01, 100.0


@dataclass
class HostCamera:
    R: np.ndarray                  # [3, 3] camera-to-world rotation
    T: np.ndarray                  # [3] world-to-camera translation
    fovx: float
    fovy: float
    width: int = 0
    height: int = 0
    time: float = 0.0
    znear: float = ZNEAR
    zfar: float = ZFAR
    image: Optional[np.ndarray] = None   # [3, H, W] float32 in [0, 1]
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    colmap_id: int = 0
    uid: int = 0
    image_name: str = ""
    mask: Optional[np.ndarray] = None
    cam_name: Optional[str] = None
    image_path: Optional[str] = None
    # how the lazy decode reads `image_path` (data/readers.py load_image)
    image_resize: Optional[Tuple[int, int]] = None
    image_filt: str = "bicubic"

    def __post_init__(self):
        # A mask assigned after construction (the hyper test split) is not
        # applied to a later lazy decode: the construction-time choice is
        # kept, so eager and lazy images are normalized alike.
        self.__dict__["_mask_image"] = (
            self.mask if self.mask is not None and self.mask.ndim == 3
            else None)
        img = self.__dict__.get("_image")
        # the pixels are "file-backed" only while they are the lazy decode
        # of image_path and were never assigned (cache keys rely on it)
        self.__dict__["_image_from_ctor"] = img is not None
        self.__dict__["_image_dirty"] = False
        if img is not None:
            self.__dict__["_image"] = self._normalize(img)

    def _normalize(self, img: np.ndarray) -> np.ndarray:
        img = np.clip(img[:3], 0.0, 1.0).astype(np.float32)
        self.height, self.width = img.shape[1:]
        m = self.__dict__.get("_mask_image")
        if m is not None:
            img = img * m
        return img

    @property
    def image_materialized(self) -> bool:
        """True when the pixels are in memory."""
        return self.__dict__.get("_image") is not None

    @property
    def image_file_backed(self) -> bool:
        """True while the pixels are exactly the lazy decode of
        `image_path` (decoded yet or not): cache keys may then use the
        file's identity instead of the pixels."""
        return (self.image_path is not None
                and not self.__dict__.get("_image_from_ctor", True)
                and not self.__dict__.get("_image_dirty", True))

    @property
    def world_view_transform(self) -> np.ndarray:
        return world_to_view(self.R, self.T, self.trans, self.scale).T

    @property
    def projection_matrix(self) -> np.ndarray:
        return projection_matrix(self.znear, self.zfar, self.fovx,
                                 self.fovy).T

    @property
    def full_proj_transform(self) -> np.ndarray:
        return self.world_view_transform @ self.projection_matrix

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.world_view_transform)[3, :3]

    def camera_params_np(self):
        """CameraParams with float32 numpy fields (for `pack_cam_rows`)."""
        from langsplat4d_torch.render.raster import CameraParams
        return CameraParams(
            viewmatrix=np.asarray(self.world_view_transform, np.float32),
            projmatrix=np.asarray(self.full_proj_transform, np.float32),
            campos=np.asarray(self.camera_center, np.float32),
            tanfovx=np.asarray(np.tan(self.fovx * 0.5), np.float32),
            tanfovy=np.asarray(np.tan(self.fovy * 0.5), np.float32))

    def camera_params(self, device) -> "CameraParams":
        """The five tensors of render.raster.CameraParams on `device`."""
        host = self.camera_params_np()
        return type(host)(*[torch.as_tensor(a, device=device) for a in host])

    def language_feature_name(self, language_feature_dir: str, split: str,
                              data_type: str) -> Optional[str]:
        """The path stem of this camera's `_s.npy` / `_f.npy` pair
        (scene/cameras.py:69-90: nerfies reads colmap_id*4+1 in train,
        *4+3 in test and colmap_id+1 in video; dynerf cam_name-frame), or
        None where the split has none."""
        if data_type == "nerfies":
            if split == "train":
                real_id = self.colmap_id * 4 + 1
            elif split == "test":
                real_id = self.colmap_id * 4 + 3
            else:
                real_id = self.colmap_id + 1
            return os.path.join(language_feature_dir, f"{real_id:06}")
        if data_type == "dynerf":
            frame_id = self.colmap_id % 300
            if split == "test":
                assert self.colmap_id < 300
            elif split == "video":
                return None
            return os.path.join(language_feature_dir,
                                f"{self.cam_name}-{frame_id:04}")
        raise NotImplementedError(data_type)

    def get_language_feature_compact(
            self, language_feature_dir: str, feature_level: int,
            split: str = "train", data_type: str = "nerfies",
            ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """The language ground truth as it lies on disk: per-pixel segment
        ids at `feature_level` ([H, W] int16, int32 for tables of 32767 rows
        or more) and the per-segment feature table ([S, C] float32); (None,
        None) where there is none. The per-pixel gather happens on the device
        (train/step.py materialize_batch)."""
        if language_feature_dir is None:
            return None, None
        name = self.language_feature_name(language_feature_dir, split,
                                          data_type)
        if name is None:
            return None, None
        seg_map = np.load(name + "_s.npy")          # [4, H, W] int
        feature_map = np.load(name + "_f.npy")      # [S, C]
        seg = seg_map[{0: 0, 1: 1, 2: 2, 3: 3}[feature_level]]
        if feature_map.shape[0] < np.iinfo(np.int16).max:
            seg = seg.astype(np.int16)
        else:
            seg = seg.astype(np.int32)
        return seg, np.ascontiguousarray(feature_map, dtype=np.float32)

    def get_language_feature(self, language_feature_dir: str,
                             feature_level: int, split: str = "train",
                             data_type: str = "nerfies",
                             ) -> Tuple[Optional[np.ndarray],
                                        Optional[np.ndarray]]:
        """Per-pixel language features [C, H, W] float32 (zero where the
        segment id is -1) and the validity mask [1, H, W] bool, or (None,
        None)."""
        seg, feats = self.get_language_feature_compact(
            language_feature_dir, feature_level, split, data_type)
        if seg is None:
            return None, None
        seg = seg.astype(np.int64)
        mask = (seg != -1)[None]
        feat = np.where(mask[0][..., None], feats[np.clip(seg, 0, None)],
                        np.float32(0.0))
        assert feat.shape[:2] == (self.height, self.width), (
            feat.shape, self.height, self.width)
        return np.ascontiguousarray(feat.transpose(2, 0, 1)), mask


def _image_get(self: HostCamera) -> Optional[np.ndarray]:
    img = self.__dict__.get("_image")
    if img is None and self.image_path is not None:
        from langsplat4d_torch.data.readers import load_image
        img = self._normalize(load_image(
            self.image_path, resize=self.image_resize, filt=self.image_filt))
        self.__dict__["_image"] = img
    return img


def _image_set(self: HostCamera, v: Optional[np.ndarray]) -> None:
    self.__dict__["_image"] = v
    self.__dict__["_image_dirty"] = True   # cleared by __post_init__ for
    #                                        the constructor's assignment


# `image` is both a dataclass field and a lazy property: the generated
# __init__'s `self.image = image` goes through the setter, __post_init__
# normalizes an image given to the constructor, and the getter decodes a
# path-backed camera on the first access to its pixels.
HostCamera.image = property(_image_get, _image_set)


@dataclass
class MiniCam:
    """A camera given by its matrices (scene/cameras.py:120-132)."""
    width: int
    height: int
    fovy: float
    fovx: float
    znear: float
    zfar: float
    world_view_transform: np.ndarray
    full_proj_transform: np.ndarray
    time: float = 0.0

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.world_view_transform)[3, :3]


def rotate_camera_around_center(camera: HostCamera, angle_degrees: float,
                                center: np.ndarray,
                                axs: str = "x") -> HostCamera:
    """A copy of `camera` orbited about `center` on the world axis `axs`,
    its orientation turned by the same rotation (reference
    scene/cameras.py:135-228)."""
    theta = np.deg2rad(angle_degrees)
    c, s = np.cos(theta), np.sin(theta)
    if axs == "x":
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    elif axs == "y":
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    else:
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    w2c = np.eye(4)
    w2c[:3, :3] = camera.R.T
    w2c[:3, 3] = camera.T
    c2w = np.linalg.inv(w2c)
    new_c2w = np.eye(4)
    new_c2w[:3, :3] = rot @ c2w[:3, :3]
    new_c2w[:3, 3] = rot @ (c2w[:3, 3] - center) + center
    new_w2c = np.linalg.inv(new_c2w)
    out = copy.copy(camera)
    out.R = new_w2c[:3, :3].T
    out.T = new_w2c[:3, 3]
    return out
