"""PLY point-cloud IO for Gaussian checkpoints, numpy only (the port's own
copy of langsplat4d/core/plyio.py, which it must not import).

Binary little-endian PLY with the exact attribute layout the reference writes
(`GaussianModel.construct_list_of_attributes` / `save_ply`,
scene/gaussian_model.py:331-389): x,y,z, nx,ny,nz, f_dc_*, f_rest_*, f_lang_*,
opacity, scale_*, rot_* — so checkpoints interoperate with the CUDA pipeline.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the first 'vertex' element of a PLY file into {prop: [N] array}.

    Supports binary_little_endian and ascii formats (the reference only ever
    writes binary_little_endian via plyfile).
    """
    with open(path, "rb") as f:
        header_lines: List[str] = []
        while True:
            line = f.readline().decode("ascii").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = None
        count = 0
        props: List[Tuple[str, str]] = []
        in_vertex = False
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    count = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[2], _PLY_DTYPES[parts[1]]))

        dtype = np.dtype([(name, dt) for name, dt in props])
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
        elif fmt == "ascii":
            rows = [f.readline().decode("ascii").split() for _ in range(count)]
            data = np.array([tuple(r) for r in rows], dtype=dtype)
        else:
            raise ValueError(f"unsupported PLY format: {fmt}")
    return {name: np.ascontiguousarray(data[name]) for name, _ in props}


def write_ply(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write named float32 per-vertex attributes as binary_little_endian PLY."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    names = list(arrays.keys())
    n = len(next(iter(arrays.values())))
    dtype = np.dtype([(name, "<f4") for name in names])
    rec = np.empty(n, dtype=dtype)
    for name in names:
        rec[name] = np.asarray(arrays[name], dtype=np.float32).reshape(n)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def _sorted_props(props: Dict[str, np.ndarray], prefix: str) -> List[str]:
    pat = re.compile(re.escape(prefix) + r"(\d+)$")
    hits = [(int(m.group(1)), k) for k in props if (m := pat.match(k))]
    return [k for _, k in sorted(hits)]


def gaussians_to_ply_arrays(xyz, features_dc, features_rest, language_feature,
                            opacity, scaling, rotation) -> Dict[str, np.ndarray]:
    """Dense (unpadded) numpy arrays -> PLY attribute dict, reference layout.

    f_dc/f_rest are flattened channel-major ([N,K,3] -> transpose -> [N,3*K]),
    matching the torch `.transpose(1, 2).flatten(1)` in save_ply
    (scene/gaussian_model.py:375-376).
    """
    xyz = np.asarray(xyz, np.float32)
    out: Dict[str, np.ndarray] = {}
    for i, ax in enumerate("xyz"):
        out[ax] = xyz[:, i]
    for ax in ("nx", "ny", "nz"):
        out[ax] = np.zeros(len(xyz), np.float32)
    f_dc = np.asarray(features_dc, np.float32).transpose(0, 2, 1).reshape(len(xyz), -1)
    for i in range(f_dc.shape[1]):
        out[f"f_dc_{i}"] = f_dc[:, i]
    f_rest = np.asarray(features_rest, np.float32).transpose(0, 2, 1).reshape(len(xyz), -1)
    for i in range(f_rest.shape[1]):
        out[f"f_rest_{i}"] = f_rest[:, i]
    f_lang = np.asarray(language_feature, np.float32)
    for i in range(f_lang.shape[1]):
        out[f"f_lang_{i}"] = f_lang[:, i]
    out["opacity"] = np.asarray(opacity, np.float32).reshape(-1)
    scaling = np.asarray(scaling, np.float32)
    for i in range(scaling.shape[1]):
        out[f"scale_{i}"] = scaling[:, i]
    rotation = np.asarray(rotation, np.float32)
    for i in range(rotation.shape[1]):
        out[f"rot_{i}"] = rotation[:, i]
    return out


def ply_arrays_to_gaussians(props: Dict[str, np.ndarray], max_sh_degree: int = 3):
    """PLY attribute dict -> dense numpy arrays (reference load_ply,
    scene/gaussian_model.py:396-444). Returns a dict of arrays."""
    n = len(props["x"])
    xyz = np.stack([props["x"], props["y"], props["z"]], axis=1).astype(np.float32)
    opacity = props["opacity"].astype(np.float32).reshape(n, 1)

    features_dc = np.zeros((n, 3, 1), np.float32)
    for i in range(3):
        features_dc[:, i, 0] = props[f"f_dc_{i}"]
    features_dc = features_dc.transpose(0, 2, 1)  # [n,1,3]

    rest_names = _sorted_props(props, "f_rest_")
    expected = 3 * (max_sh_degree + 1) ** 2 - 3
    assert len(rest_names) == expected, (len(rest_names), expected)
    rest = np.stack([props[k] for k in rest_names], axis=1).astype(np.float32)
    features_rest = rest.reshape(n, 3, -1).transpose(0, 2, 1)  # [n,R,3]

    lang_names = _sorted_props(props, "f_lang_")
    f_lang = (np.stack([props[k] for k in lang_names], axis=1).astype(np.float32)
              if lang_names else np.zeros((n, 0), np.float32))

    scale_names = _sorted_props(props, "scale_")
    scaling = np.stack([props[k] for k in scale_names], axis=1).astype(np.float32)
    rot_names = _sorted_props(props, "rot_")
    rotation = np.stack([props[k] for k in rot_names], axis=1).astype(np.float32)

    return dict(
        xyz=xyz, features_dc=features_dc, features_rest=features_rest,
        language_feature=f_lang, opacity=opacity, scaling=scaling,
        rotation=rotation,
    )
