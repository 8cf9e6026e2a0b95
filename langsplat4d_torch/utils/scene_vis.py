"""Training snapshots: GT | render | depth triptychs under a label strip
(port of langsplat4d/utils/scene_vis.py; reference utils/scene_utils.py:11-77
render_training_image).

The JAX package draws the label with PIL's default font and saves through
PIL; the port draws it with a 5x7 bitmap font of its own (lower case,
digits and `: - _ .`, each glyph at twice its size) and saves through its
own JPEG encoder (data/jpeg.py) at PIL's default quality 75.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from langsplat4d_torch.data.jpeg import write_jpeg

STRIP = 24           # the label strip's height, as the JAX package's
GLYPH_W, GLYPH_H, SCALE = 5, 7, 2
ADVANCE = (GLYPH_W + 1) * SCALE
_ROWS = {
    "0": "01110 10001 10011 10101 11001 10001 01110",
    "1": "00100 01100 00100 00100 00100 00100 01110",
    "2": "01110 10001 00001 00010 00100 01000 11111",
    "3": "11111 00010 00100 00010 00001 10001 01110",
    "4": "00010 00110 01010 10010 11111 00010 00010",
    "5": "11111 10000 11110 00001 00001 10001 01110",
    "6": "00110 01000 10000 11110 10001 10001 01110",
    "7": "11111 00001 00010 00100 01000 01000 01000",
    "8": "01110 10001 10001 01110 10001 10001 01110",
    "9": "01110 10001 10001 01111 00001 00010 01100",
    "a": "00000 00000 01110 00001 01111 10001 01111",
    "b": "10000 10000 10110 11001 10001 10001 11110",
    "c": "00000 00000 01110 10000 10000 10001 01110",
    "d": "00001 00001 01101 10011 10001 10001 01111",
    "e": "00000 00000 01110 10001 11111 10000 01110",
    "f": "00110 01001 01000 11100 01000 01000 01000",
    "g": "00000 01111 10001 10001 01111 00001 01110",
    "h": "10000 10000 10110 11001 10001 10001 10001",
    "i": "00100 00000 01100 00100 00100 00100 01110",
    "j": "00010 00000 00110 00010 00010 10010 01100",
    "k": "10000 10000 10010 10100 11000 10100 10010",
    "l": "01100 00100 00100 00100 00100 00100 01110",
    "m": "00000 00000 11010 10101 10101 10001 10001",
    "n": "00000 00000 10110 11001 10001 10001 10001",
    "o": "00000 00000 01110 10001 10001 10001 01110",
    "p": "00000 00000 11110 10001 11110 10000 10000",
    "q": "00000 00000 01101 10011 01111 00001 00001",
    "r": "00000 00000 10110 11001 10000 10000 10000",
    "s": "00000 00000 01110 10000 01110 00001 11110",
    "t": "01000 01000 11100 01000 01000 01001 00110",
    "u": "00000 00000 10001 10001 10001 10011 01101",
    "v": "00000 00000 10001 10001 10001 01010 00100",
    "w": "00000 00000 10001 10001 10101 10101 01010",
    "x": "00000 00000 10001 01010 00100 01010 10001",
    "y": "00000 00000 10001 10001 01111 00001 01110",
    "z": "00000 00000 11111 00010 00100 01000 11111",
    ":": "00000 01100 01100 00000 01100 01100 00000",
    "-": "00000 00000 00000 11111 00000 00000 00000",
    "_": "00000 00000 00000 00000 00000 00000 11111",
    ".": "00000 00000 00000 00000 00000 01100 01100",
    " ": "00000 00000 00000 00000 00000 00000 00000",
}
# char -> [GLYPH_H, GLYPH_W] bool; any other character draws a box
FONT = {c: np.array([[b == "1" for b in row] for row in rows.split()])
        for c, rows in _ROWS.items()}
BOX = np.ones((GLYPH_H, GLYPH_W), bool)
BOX[1:-1, 1:-1] = False


def glyph(ch: str) -> np.ndarray:
    return FONT.get(ch.lower(), BOX)


def draw_text(canvas: np.ndarray, text: str, x: int, y: int,
              color=(255, 255, 255)) -> None:
    """Stamp `text` into the [H, W, 3] uint8 canvas with its top-left
    corner at (x, y), clipped at the canvas's edges."""
    h, w = canvas.shape[:2]
    for i, ch in enumerate(text):
        g = np.kron(glyph(ch), np.ones((SCALE, SCALE), bool))
        x0 = x + i * ADVANCE
        if x0 >= w:
            break
        g = g[:max(0, h - y), :w - x0]
        canvas[y:y + g.shape[0], x0:x0 + g.shape[1]][g] = color


def to_image_u8(arr: np.ndarray) -> np.ndarray:
    """[C, H, W] float -> [H, W, 3] uint8."""
    arr = np.clip(np.transpose(arr[:3], (1, 2, 0)), 0, 1)
    return (arr * 255).astype(np.uint8)


def depth_colormap(depth: np.ndarray) -> np.ndarray:
    """[1, H, W] -> [H, W, 3] uint8 grey, normalised to the depth's range."""
    d = depth[0]
    lo, hi = float(d.min()), float(d.max())
    g = ((d - lo) / (hi - lo + 1e-9) * 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def label_text(stage: str, iteration: int, elapsed: float,
               point_count: int) -> str:
    return (f"stage:{stage} iter:{iteration} "
            f"time:{int(elapsed // 60):02d}:{int(elapsed % 60):02d} "
            f"points:{point_count}")


def training_image(gt: np.ndarray, render: np.ndarray, depth: np.ndarray,
                   label: str) -> np.ndarray:
    """The [STRIP + H, 3 W, 3] uint8 picture: `label` on a black strip
    above GT | render | depth."""
    panels: List[np.ndarray] = [to_image_u8(gt), to_image_u8(render),
                                depth_colormap(depth)]
    h = max(p.shape[0] for p in panels)
    w = sum(p.shape[1] for p in panels)
    canvas = np.zeros((h + STRIP, w, 3), np.uint8)
    x = 0
    for p in panels:
        canvas[STRIP:STRIP + p.shape[0], x:x + p.shape[1]] = p
        x += p.shape[1]
    draw_text(canvas, label, 4, 4)
    return canvas


def render_training_image(out_dir: str, stage: str, iteration: int,
                          elapsed: float, gt: np.ndarray, render: np.ndarray,
                          depth: np.ndarray, point_count: int) -> str:
    """Writes `{stage}_{iteration}.jpg` in `out_dir`; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    canvas = training_image(gt, render, depth,
                            label_text(stage, iteration, elapsed,
                                       point_count))
    path = os.path.join(out_dir, f"{stage}_{iteration}.jpg")
    write_jpeg(path, canvas, quality=75)
    return path
