"""Scene facade, camera dataset wrapper and the samplers (port of
langsplat4d/data/scene.py; reference scene/__init__.py:23-108,
scene/dataset.py:9-53 and utils/loader_utils.py:13-52).
"""
from __future__ import annotations

import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np

from langsplat4d_torch.data.cameras import HostCamera
from langsplat4d_torch.data.panoptic import (PanopticCamera,
                                             read_panoptic_scene)
from langsplat4d_torch.data.readers import (SCENE_LOAD_CALLBACKS, CameraInfo,
                                            SceneInfo, add_points,
                                            load_image)

# marker file -> dataset type, checked in this order (scene/__init__.py:46-66)
MARKERS = (("sparse", "colmap"), ("transforms_train.json", "blender"),
           ("poses_bounds.npy", "dynerf"), ("dataset.json", "nerfies"),
           ("train_meta.json", "PanopticSports"),
           ("points3D_multipleview.ply", "MultipleView"))


def sniff_dataset_type(source_path: str) -> str:
    """The dataset type of the scene at `source_path`, by its marker
    file."""
    for marker, kind in MARKERS:
        if os.path.exists(os.path.join(source_path, marker)):
            return kind
    raise ValueError(f"Could not recognize scene type at {source_path}")


class CameraDataset:
    """Per-index HostCamera from a reader's dataset (FourDGSdataset)."""

    def __init__(self, dataset, dataset_type: str):
        self.dataset = dataset
        self.dataset_type = dataset_type

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index: int) -> HostCamera:
        item = self.dataset[index]
        if isinstance(item, PanopticCamera):
            return item
        if isinstance(item, HostCamera):
            # readers that build HostCameras get the dataset index as
            # colmap_id, as FourDGSdataset stamps it (scene/dataset.py:41-47)
            item.colmap_id = index
            item.uid = index
            return item
        info: CameraInfo = item
        image = info.image
        if (image is None and info.image_path is not None
                and not (info.width and info.height)):
            # a lazy decode needs the size up front
            image = load_image(info.image_path)
        return HostCamera(
            colmap_id=index, R=info.R, T=info.T, fovx=info.FovX,
            fovy=info.FovY, image=image, image_name=f"{index:06d}", uid=index,
            time=info.time, mask=info.mask, image_path=info.image_path,
            width=int(info.width or 0), height=int(info.height or 0))

    @property
    def image_times(self) -> List[float]:
        if hasattr(self.dataset, "image_times"):
            return self.dataset.image_times
        return [c.time for c in self.dataset]


class Scene:
    """Sniff the format, build the camera datasets, the extent and the
    AABB."""

    def __init__(self, source_path: str, *, images: str = "images",
                 eval_split: bool = True, llffhold: int = 8,
                 white_background: bool = True, extension: str = ".png",
                 add_random_points: bool = False, model_path: str = ""):
        self.model_path = model_path
        dataset_type = sniff_dataset_type(source_path)
        if dataset_type == "colmap":
            info = SCENE_LOAD_CALLBACKS["Colmap"](source_path, images,
                                                  eval_split, llffhold)
        elif dataset_type == "blender":
            info = SCENE_LOAD_CALLBACKS["Blender"](source_path,
                                                   white_background,
                                                   eval_split, extension)
        elif dataset_type == "PanopticSports":
            info = read_panoptic_scene(source_path)
        else:            # dynerf, nerfies, MultipleView
            info = SCENE_LOAD_CALLBACKS[dataset_type](source_path)
        self.dataset_type = dataset_type
        self.scene_info: SceneInfo = info
        self.maxtime = info.maxtime
        self.cameras_extent = info.nerf_normalization["radius"]
        self.train_camera = CameraDataset(info.train_cameras, dataset_type)
        self.test_camera = CameraDataset(info.test_cameras, dataset_type)
        self.video_camera = CameraDataset(info.video_cameras, dataset_type)
        self.xyz_max = info.point_cloud.points.max(axis=0)
        self.xyz_min = info.point_cloud.points.min(axis=0)
        self.point_cloud = info.point_cloud
        if add_random_points:
            self.point_cloud = add_points(info.point_cloud,
                                          xyz_min=self.xyz_min,
                                          xyz_max=self.xyz_max)

    @property
    def aabb(self) -> np.ndarray:
        """[2, 3]: the max corner, then the min corner (HexPlaneField.set_aabb,
        scene/__init__.py:84)."""
        return np.stack([self.xyz_max, self.xyz_min]).astype(np.float32)

    def getTrainCameras(self) -> CameraDataset:
        return self.train_camera

    def getTestCameras(self) -> CameraDataset:
        return self.test_camera

    def getVideoCameras(self) -> CameraDataset:
        return self.video_camera


def get_stamp_list(dataset: CameraDataset, timestamp: int, num_poses: int):
    """The camera indices of one timestamp (utils/loader_utils.py:12-18:
    datasets are pose-major, frame_length frames per pose)."""
    frame_length = len(dataset) // num_poses
    if timestamp > frame_length:
        raise IndexError("input timestamp bigger than total timestamp.")
    return [i * frame_length + timestamp for i in range(num_poses)]


class FineSampler:
    """Temporally coherent sampler (utils/loader_utils.py:20-51): for each
    timestamp, random permutations of the poses at that timestamp, with two
    samples of the history replayed after every second item."""

    def __init__(self, dataset: CameraDataset, num_poses: Optional[int] = None,
                 rounds: int = 4, seed: Optional[int] = None):
        self.rng = random.Random(seed)
        n = len(dataset)
        if num_poses is None:
            # the pose count from repeated timestamps
            times = dataset.image_times
            num_poses = max(1, len(times) // max(1, len(set(times))))
        self.frame_length = max(1, n // num_poses)
        self.num_poses = num_poses
        sample_list: List[int] = []
        for i in range(self.frame_length):
            now_list: List[int] = []
            for _ in range(rounds):
                perm = list(range(self.num_poses))
                self.rng.shuffle(perm)
                idx = [p * self.frame_length + i for p in perm]
                now_list = []
                cnt = 0
                for item in idx:
                    now_list.append(item)
                    cnt += 1
                    if cnt % 2 == 0 and len(sample_list) > 2:
                        now_list += self.rng.sample(sample_list, 2)
            sample_list += now_list
        self.sample_list = [min(i, n - 1) for i in sample_list]

    def __iter__(self) -> Iterator[int]:
        return iter(self.sample_list)

    def __len__(self) -> int:
        return len(self.sample_list)


class BatchLoader:
    """Shuffled batches of cameras (the reference's DataLoader,
    train.py:143-151). With `workers > 1` and batches of more than one, a
    batch's cameras are fetched on a thread pool."""

    def __init__(self, dataset: CameraDataset, batch_size: int,
                 sampler=None, seed: int = 0, workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.rng = random.Random(seed)
        self.workers = max(1, int(workers))

    def indices(self) -> List[int]:
        """The order of one pass over the dataset."""
        if self.sampler is not None:
            return list(iter(self.sampler))
        idxs = list(range(len(self.dataset)))
        self.rng.shuffle(idxs)
        return idxs

    def __iter__(self):
        idxs = self.indices()
        pool = (ThreadPoolExecutor(max_workers=self.workers)
                if self.workers > 1 and self.batch_size > 1 else None)
        try:
            for i in range(0, len(idxs), self.batch_size):
                batch = idxs[i:i + self.batch_size]
                if pool is not None:
                    yield list(pool.map(self.dataset.__getitem__, batch))
                else:
                    yield [self.dataset[j] for j in batch]
        finally:
            if pool is not None:
                pool.shutdown(wait=False)
