"""Autoencoder dataset: concatenation of all `*_f.npy` segment-feature tables
keyed by filename (port of langsplat4d/ae/data.py; reference
autoencoder/dataset.py:7-34)."""
from __future__ import annotations

import glob
import os
from typing import Dict, Tuple

import numpy as np


def load_feature_dataset(data_dir: str) -> Tuple[np.ndarray, Dict[str, int]]:
    data_names = sorted(glob.glob(os.path.join(data_dir, "*f.npy")))
    if not data_names:
        raise FileNotFoundError(f"no *_f.npy files under {data_dir}")
    arrays = []
    data_dic: Dict[str, int] = {}
    for path in data_names:
        feats = np.load(path)
        name = os.path.basename(path).split(".")[0]
        data_dic[name] = feats.shape[0]
        arrays.append(feats)
    return np.concatenate(arrays, axis=0).astype(np.float32), data_dic
