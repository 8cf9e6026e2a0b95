"""Device-resident ground-truth cache: each camera's training targets are
uploaded once (port of langsplat4d/data/gt_cache.py).

The reference uploads every iteration's ground truth again (train.py:242-296),
though training revisits each camera total_iters / n_images times. Here each
camera's compact ground truth (the uint8 image, the int16 segment ids and the
feature table; train/step.py Batch) stays on the training device after its
first upload, in a FIFO bounded by `runtime.gt_cache_mb`; larger scenes
stream as before. Keys are those of the loop's `build_batch`: an image by
its file's identity when it is file-backed, else by a fingerprint of its
content; the language pair by (feature dir, split, level, compact, camera
name).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch


def image_fingerprint(img: np.ndarray) -> Tuple:
    """Shape, dtype and a hash of a strided sample of the pixels: any edit
    of the whole image changes it; a single-pixel edit off the stride
    lattice may not, which a cache of images decoded from disk accepts."""
    flat = np.ascontiguousarray(img[..., ::61, ::61])
    return (img.shape, str(img.dtype), hash(flat.tobytes()))


class DeviceGTCache:
    """Byte-budgeted FIFO map: key -> tuple of tensors on `device`."""

    def __init__(self, budget_bytes: int, device):
        self.budget = int(budget_bytes)
        self.device = torch.device(device)
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def peek(self, key) -> Optional[Tuple[torch.Tensor, ...]]:
        with self._lock:
            hit = self._d.get(key)
            if hit is None:
                self.misses += 1
            else:
                self.hits += 1
            return hit

    def put(self, key, host_arrays: Tuple) -> Tuple[torch.Tensor, ...]:
        """Upload `host_arrays` (numpy) and cache them under `key`; returns
        the device tuple (the cached one if another thread put the key
        first). An entry larger than the whole budget is returned
        uncached."""
        dev = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                    for a in host_arrays)
        nb = sum(t.numel() * t.element_size() for t in dev)
        with self._lock:
            if key in self._d:
                return self._d[key]
            if nb > self.budget:
                return dev
            while self._d and self.bytes + nb > self.budget:
                _, old = self._d.popitem(last=False)
                self.bytes -= sum(t.numel() * t.element_size() for t in old)
            self._d[key] = dev
            self.bytes += nb
            return dev

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self.bytes = 0


_CACHE: Optional[DeviceGTCache] = None


def get_cache(budget_mb: int, device) -> DeviceGTCache:
    """The process-wide cache (one training process serves one scene, as
    the reference's CLI does); a new budget or device rebuilds it."""
    global _CACHE
    device = torch.device(device)
    if (_CACHE is None or _CACHE.budget != budget_mb * (1 << 20)
            or _CACHE.device != device):
        _CACHE = DeviceGTCache(budget_mb * (1 << 20), device)
    return _CACHE
