"""COLMAP sparse-reconstruction parsers, binary and text (port of
langsplat4d/data/colmap.py, a numpy reimplementation of
scene/colmap_loader.py:43-282: read_extrinsics/intrinsics/points3D,
qvec2rotmat). File formats per the public COLMAP specification.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_extrinsics_binary(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_points,) = _read(f, "<Q")
            f.read(24 * num_points)  # skip xys + point3D ids
            images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                           name.decode("utf-8"))
    return images


def read_intrinsics_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * num_params))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height),
                                        params)
    return cams


def read_extrinsics_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not
                 ln.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name)
    return images


def read_intrinsics_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split()
            cam_id = int(parts[0])
            model = parts[1]
            width, height = int(parts[2]), int(parts[3])
            params = np.array([float(x) for x in parts[4:]])
            cams[cam_id] = ColmapCamera(cam_id, model, width, height, params)
    return cams


def read_points3D_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        xyzs = np.empty((num, 3))
        rgbs = np.empty((num, 3))
        errors = np.empty((num, 1))
        for i in range(num):
            vals = _read(f, "<QdddBBBd")
            xyzs[i] = vals[1:4]
            rgbs[i] = vals[4:7]
            errors[i] = vals[7]
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return xyzs, rgbs, errors


def read_points3D_text(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyzs, rgbs, errors = [], [], []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split()
            xyzs.append([float(x) for x in parts[1:4]])
            rgbs.append([float(x) for x in parts[4:7]])
            errors.append([float(parts[7])])
    return np.array(xyzs), np.array(rgbs), np.array(errors)


def write_points3D_binary(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Minimal writer (for tests/fixtures)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i, *xyz[i],
                                *rgb[i].astype(np.uint8), 0.0))
            f.write(struct.pack("<Q", 0))
