"""Scene readers (port of langsplat4d/data/readers.py; reference
scene/dataset_readers.py, scene/hyper_loader.py and
scene/neural_3D_dataset_NDC.py): COLMAP, Blender (D-NeRF), HyperNeRF
(nerfies), Neu3D (dynerf) and MultipleView, by `SCENE_LOAD_CALLBACKS`;
PanopticSports is data/panoptic.py. Images decode through the port's codec
(data/codec.py): PNG and baseline JPEG, with PIL's resample.

The JAX package's faults are kept for parity (ROADMAP, queue 3): the
Neu3D dataset assumes 300 frames a camera (its times, camera names and,
through them, the language files' names) and cuts its image directory at
the first dot of the video's path.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from langsplat4d_torch.core import plyio
from langsplat4d_torch.core.sh import C0
from langsplat4d_torch.core.transforms import (focal2fov, fov2focal,
                                               world_to_view)
from langsplat4d_torch.data import codec
from langsplat4d_torch.data import colmap as cm
from langsplat4d_torch.data.cameras import HostCamera


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
    utils/general_utils.py:21-33). PNG or JPEG, told apart by their bytes;
    `resize` (width, height) is PIL's antialiased resize with filter
    `filt` (box, bilinear, bicubic, lanczos)."""
    return codec.load_chw(path, resize=resize, filt=filt)


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


# --------------------------------------------------------------------------
# COLMAP


def read_colmap_scene(path, images="images", eval_split=True, llffhold=8):
    """dataset_readers.py:150-199: the sparse model's cameras (binary, else
    text), every `llffhold`-th image held out for test, the point cloud
    from points3D.ply (written from points3D.bin or .txt where missing)."""
    sparse = os.path.join(path, "sparse/0")
    try:
        extrinsics = cm.read_extrinsics_binary(os.path.join(sparse,
                                                            "images.bin"))
        intrinsics = cm.read_intrinsics_binary(os.path.join(sparse,
                                                            "cameras.bin"))
    except FileNotFoundError:
        extrinsics = cm.read_extrinsics_text(os.path.join(sparse,
                                                          "images.txt"))
        intrinsics = cm.read_intrinsics_text(os.path.join(sparse,
                                                          "cameras.txt"))
    folder = os.path.join(path, images or "images")
    cam_infos = []
    for idx, key in enumerate(extrinsics):
        extr = extrinsics[key]
        intr = intrinsics[extr.camera_id]
        R = np.transpose(cm.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fovy = focal2fov(intr.params[0], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        elif intr.model in ("PINHOLE", "OPENCV"):
            fovy = focal2fov(intr.params[1], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        else:
            raise ValueError(f"unsupported COLMAP model {intr.model}")
        image_path = os.path.join(folder, os.path.basename(extr.name))
        image_name = os.path.basename(image_path).split(".")[0]
        cam_infos.append(CameraInfo(
            uid=intr.id, R=R, T=T, FovY=fovy, FovX=fovx, image=None,
            image_path=image_path, image_name=image_name, width=intr.width,
            height=intr.height, time=float(idx / len(extrinsics))))
    cam_infos = sorted(cam_infos, key=lambda c: c.image_name)
    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []
    norm = get_nerfpp_norm(train)
    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = cm.read_points3D_binary(
                os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = cm.read_points3D_text(
                os.path.join(sparse, "points3D.txt"))
        store_ply(ply_path, xyz, rgb)
    pcd = fetch_ply(ply_path)
    return SceneInfo(pcd, train, test, train, norm, ply_path, maxtime=0)


# --------------------------------------------------------------------------
# Blender synthetic (D-NeRF)


def _read_timeline(path):
    """dataset_readers.py:298-313: every frame time of both splits over the
    largest."""
    with open(os.path.join(path, "transforms_train.json")) as f:
        train_json = json.load(f)
    with open(os.path.join(path, "transforms_test.json")) as f:
        test_json = json.load(f)
    times = sorted({fr["time"] for fr in
                    train_json["frames"] + test_json["frames"]})
    max_t = max(times)
    return {t: t / max_t for t in times}, max_t


def _to_rgba(img: np.ndarray) -> np.ndarray:
    """PIL's convert("RGBA") of [H, W, C] uint8 grey, grey + alpha, RGB or
    RGBA."""
    c = img.shape[2]
    rgb = img[..., :1].repeat(3, 2) if c <= 2 else img[..., :3]
    alpha = (img[..., -1:] if c in (2, 4)
             else np.full(img.shape[:2] + (1,), 255, np.uint8))
    return np.concatenate([rgb, alpha], 2)


def _read_cams_from_transforms(path, transformsfile, white_background,
                               extension, mapper):
    """dataset_readers.py:259-297: each frame converted to RGBA,
    composited in float64 onto the background, truncated to uint8 and
    resized to 800x800 with PIL's default resample (bicubic)."""
    cam_infos = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents.get("camera_angle_x")
    if fovx is None:
        fovx = focal2fov(contents["fl_x"], contents["w"])
    bg = np.ones(3) if white_background else np.zeros(3)
    for idx, frame in enumerate(contents["frames"]):
        cam_name = os.path.join(path, frame["file_path"] + extension)
        time = mapper[frame["time"]]
        matrix = np.linalg.inv(np.array(frame["transform_matrix"]))
        R = -np.transpose(matrix[:3, :3])
        R[:, 0] = -R[:, 0]
        T = -matrix[:3, 3]
        im_data = _to_rgba(codec.read_image(cam_name)) / 255.0
        arr = (im_data[:, :, :3] * im_data[:, :, 3:4]
               + bg * (1 - im_data[:, :, 3:4]))
        img = codec.resample((arr * 255).astype(np.uint8), (800, 800),
                             "bicubic")
        image = np.transpose(img.astype(np.float32) / 255.0, (2, 0, 1))
        fovy = focal2fov(fov2focal(fovx, image.shape[1]), image.shape[2])
        cam_infos.append(CameraInfo(
            uid=idx, R=R, T=T, FovY=fovy, FovX=fovx, image=image,
            image_path=cam_name, image_name=os.path.basename(cam_name),
            width=image.shape[1], height=image.shape[2], time=time))
    return cam_infos


def _pose_spherical(theta, phi, radius):
    """dataset_readers.py:200-223."""
    def trans_t(t):
        return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t],
                         [0, 0, 0, 1]], np.float32)

    def rot_phi(p):
        return np.array([[1, 0, 0, 0], [0, np.cos(p), -np.sin(p), 0],
                         [0, np.sin(p), np.cos(p), 0], [0, 0, 0, 1]],
                        np.float32)

    def rot_theta(t):
        return np.array([[np.cos(t), 0, -np.sin(t), 0], [0, 1, 0, 0],
                         [np.sin(t), 0, np.cos(t), 0], [0, 0, 0, 1]],
                        np.float32)

    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                    [0, 0, 0, 1]], np.float32) @ c2w
    return c2w


def _generate_spherical_video_cams(path, template_file, extension, maxtime,
                                   white_background):
    """The 160-pose spherical video at 800x800 (dataset_readers.py:224-
    258)."""
    cam_infos = []
    with open(os.path.join(path, template_file)) as f:
        template = json.load(f)
    fovx = template.get("camera_angle_x")
    if fovx is None:
        fovx = focal2fov(template["fl_x"], template["w"])
    render_poses = [_pose_spherical(a, -30.0, 4.0)
                    for a in np.linspace(-180, 180, 161)[:-1]]
    render_times = np.linspace(0, maxtime, len(render_poses))
    for idx, (time, pose) in enumerate(zip(render_times, render_poses)):
        time = time / maxtime
        matrix = np.linalg.inv(np.array(pose))
        R = -np.transpose(matrix[:3, :3])
        R[:, 0] = -R[:, 0]
        T = -matrix[:3, 3]
        fovy = focal2fov(fov2focal(fovx, 800), 800)
        cam_infos.append(CameraInfo(
            uid=idx, R=R, T=T, FovY=fovy, FovX=fovx, image=None,
            image_path=None, image_name=None, width=800, height=800,
            time=time))
    return cam_infos


def read_nerf_synthetic_scene(path, white_background=True, eval_split=True,
                              extension=".png"):
    """dataset_readers.py:314-353: without fused.ply, 2000 points drawn
    from numpy's global generator, as the JAX package draws them."""
    mapper, max_time = _read_timeline(path)
    train = _read_cams_from_transforms(path, "transforms_train.json",
                                       white_background, extension, mapper)
    test = _read_cams_from_transforms(path, "transforms_test.json",
                                      white_background, extension, mapper)
    video = _generate_spherical_video_cams(path, "transforms_train.json",
                                           extension, max_time,
                                           white_background)
    if not eval_split:
        train.extend(test)
        test = []
    norm = get_nerfpp_norm(train)
    ply_path = os.path.join(path, "fused.ply")
    if os.path.exists(ply_path):
        pcd = fetch_ply(ply_path)
    else:
        num_pts = 2000
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        pcd = BasicPointCloud(xyz, shs * C0 + 0.5,      # SH2RGB
                              np.zeros((num_pts, 3)))
    return SceneInfo(pcd, train, test, video, norm, ply_path,
                     maxtime=max_time)


# --------------------------------------------------------------------------
# HyperNeRF (nerfies)


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


# --------------------------------------------------------------------------
# Neu3D (DyNeRF)


def _normalize(v):
    return v / np.linalg.norm(v)


def _average_poses(poses):
    center = poses[:, :3, 3].mean(0)
    z = _normalize(poses[:, :3, 2].mean(0))
    y_ = poses[:, :3, 1].mean(0)
    x = _normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def _render_path_spiral(c2w, up, rads, focal, zdelta, zrate, N, rots=2):
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = np.dot(c2w[:3, :4],
                   np.array([np.cos(theta), -np.sin(theta),
                             -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        x = _normalize(np.cross(up, z))
        y = np.cross(z, x)
        render_poses.append(np.stack([x, y, z, c], 1))
    return render_poses


def _get_spiral(c2ws_all, near_fars, rads_scale=1.0, n_views=120):
    """neural_3D_dataset_NDC.py:185-207."""
    c2w = _average_poses(c2ws_all)
    up = _normalize(c2ws_all[:, :3, 1].sum(0))
    dt = 0.75
    close_depth, inf_depth = near_fars.min() * 0.9, near_fars.max() * 5.0
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    zdelta = near_fars.min() * 0.2
    tt = c2ws_all[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0) * rads_scale
    return np.stack(_render_path_spiral(c2w, up, rads, focal, zdelta,
                                        zrate=0.5, N=n_views))


class Neu3DDataset:
    """Lazy Neu3D / DyNeRF loader (scene/neural_3D_dataset_NDC.py:210-386):
    up to 300 frames a camera from camNN/images/, cam00 held out as test,
    each image decoded on first use at `img_wh` with the lanczos filter.
    The frames must be extracted from the videos beforehand (the port has
    no video decoder): where a camera has only its camNN.mp4, the reader
    raises and names the video."""

    FRAMES = 300

    def __init__(self, datadir, split="train", downsample=1.0, eval_index=0):
        self.root = datadir
        self.split = split
        self.img_wh = (int(1352 / downsample), int(1014 / downsample))
        self.downsample = 2704 / self.img_wh[0]
        self.eval_index = eval_index

        poses_arr = np.load(os.path.join(datadir, "poses_bounds.npy"))
        poses = poses_arr[:, :-2].reshape([-1, 3, 5])
        self.near_fars = poses_arr[:, -2:]
        videos = sorted(glob.glob(os.path.join(datadir, "cam*.mp4")))
        if not videos:
            videos = sorted(
                d + ".mp4" for d in glob.glob(os.path.join(datadir, "cam*"))
                if os.path.isdir(d))
        H, W, focal = poses[0, :, -1]
        focal = focal / self.downsample
        self.focal = [focal, focal]
        poses = np.concatenate(
            [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
        self.val_poses = _get_spiral(poses, self.near_fars, n_views=300)
        self.poses_all = poses

        self.image_paths: List[str] = []
        self.image_poses = []
        self.image_times: List[float] = []
        for index, video_path in enumerate(videos):
            if index == self.eval_index:
                if split == "train":
                    continue
            else:
                if split == "test":
                    continue
            # the reference's cut at the path's first dot (queue 3)
            image_dir = os.path.join(video_path.split(".")[0], "images")
            if not os.path.exists(image_dir):
                self._extract_frames(video_path, image_dir)
            frames = sorted(os.listdir(image_dir))[: self.FRAMES]
            for idx, name in enumerate(frames):
                self.image_paths.append(os.path.join(image_dir, name))
                pose = np.array(self.poses_all[index])
                R = -pose[:3, :3]
                R[:, 0] = -R[:, 0]
                T = -pose[:3, 3].dot(R)
                self.image_times.append(idx / self.FRAMES)
                self.image_poses.append((R, T))
        if split == "train":
            self.cams = [os.path.basename(v).split(".")[0] for v in videos]
            if "cam00" in self.cams:
                self.cams.remove("cam00")
        else:
            self.cams = ["cam00"]

    def _extract_frames(self, video_path, image_dir):
        raise NotImplementedError(
            f"{video_path}: the port reads Neu3D frames from {image_dir} and "
            f"decodes no video; extract the frames first (README.md, "
            f"\"Neu3D frames\")")

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, index) -> HostCamera:
        R, T = self.image_poses[index]
        w, h = int(self.img_wh[0]), int(self.img_wh[1])
        # lazy decode with the loader's resize: revisits that hit the device
        # GT cache skip the lanczos decode entirely
        return HostCamera(
            colmap_id=index, R=R, T=T, fovx=focal2fov(self.focal[0], w),
            fovy=focal2fov(self.focal[0], h), image=None,
            image_name=f"{index:06d}", uid=index,
            time=self.image_times[index],
            cam_name=self.cams[index // self.FRAMES]
            if index // self.FRAMES < len(self.cams) else self.cams[-1],
            image_path=self.image_paths[index], width=w, height=h,
            image_resize=(w, h), image_filt="lanczos")

    def cam_infos(self):
        infos = []
        w, h = self.img_wh
        for idx in range(len(self)):
            R, T = self.image_poses[idx]
            infos.append(CameraInfo(
                uid=idx, R=R, T=T,
                FovY=focal2fov(self.focal[0], h),
                FovX=focal2fov(self.focal[0], w),
                image=None, image_path=None, image_name=f"{idx}",
                width=w, height=h, time=self.image_times[idx]))
        return infos

    def video_cam_infos(self):
        """The 300 spiral poses (format_render_poses,
        dataset_readers.py:403-426)."""
        cameras = []
        w, h = self.img_wh
        n = len(self.val_poses)
        for idx, p in enumerate(self.val_poses):
            pose = np.eye(4)
            pose[:3, :] = p[:3, :]
            R = -pose[:3, :3]
            R[:, 0] = -R[:, 0]
            T = -pose[:3, 3].dot(R)
            cameras.append(CameraInfo(
                uid=idx, R=R, T=T,
                FovY=focal2fov(self.focal[0], h),
                FovX=focal2fov(self.focal[0], w),
                image=None, image_path=None, image_name=f"{idx}",
                width=w, height=h, time=idx / n))
        return cameras


def read_dynerf_scene(datadir):
    """dataset_readers.py:443-489."""
    train_ds = Neu3DDataset(datadir, "train")
    test_ds = Neu3DDataset(datadir, "test")
    norm = get_nerfpp_norm(train_ds.cam_infos())
    ply_path = os.path.join(datadir, "points3D_downsample2.ply")
    pcd = fetch_ply(ply_path)
    return SceneInfo(pcd, train_ds, test_ds, test_ds.video_cam_infos(),
                     norm, ply_path, maxtime=300)


# --------------------------------------------------------------------------
# MultipleView


def read_multipleview_scene(datadir):
    """dataset_readers.py:610-647: one COLMAP pose per camera directory and
    its frames; the first camera is the test split."""
    cams_dir = sorted(glob.glob(os.path.join(datadir, "cam*")))
    sparse = os.path.join(datadir, "sparse_")
    extrinsics = cm.read_extrinsics_binary(os.path.join(sparse, "images.bin"))
    intrinsics = cm.read_intrinsics_binary(os.path.join(sparse,
                                                        "cameras.bin"))
    train_infos, test_infos = [], []
    uid = 0
    keys = sorted(extrinsics, key=lambda k: extrinsics[k].name)
    for ci, key in enumerate(keys):
        extr = extrinsics[key]
        intr = intrinsics[extr.camera_id]
        R = np.transpose(cm.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        fovy = focal2fov(intr.params[1] if len(intr.params) > 1
                         else intr.params[0], intr.height)
        fovx = focal2fov(intr.params[0], intr.width)
        cam_dir = cams_dir[ci % len(cams_dir)]
        frames = sorted(glob.glob(os.path.join(cam_dir, "frames", "*")))
        if not frames:
            frames = sorted(glob.glob(os.path.join(cam_dir, "*.png")))
        n = max(len(frames), 1)
        for fi, fp in enumerate(frames):
            info = CameraInfo(
                uid=uid, R=R, T=T, FovY=fovy, FovX=fovx, image=None,
                image_path=fp, image_name=os.path.basename(fp),
                width=intr.width, height=intr.height, time=fi / n)
            (test_infos if ci == 0 else train_infos).append(info)
            uid += 1
    norm = get_nerfpp_norm(train_infos)
    ply_path = os.path.join(datadir, "points3D_multipleview.ply")
    pcd = fetch_ply(ply_path)
    return SceneInfo(pcd, train_infos, test_infos, test_infos, norm,
                     ply_path, maxtime=1)


SCENE_LOAD_CALLBACKS: Dict[str, Callable] = {
    "Colmap": read_colmap_scene,
    "Blender": read_nerf_synthetic_scene,
    "dynerf": read_dynerf_scene,
    "nerfies": read_hyper_scene,
    "MultipleView": read_multipleview_scene,
}
