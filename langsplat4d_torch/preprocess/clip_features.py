"""CLIP segment features from precomputed DEVA/SAM mask stacks, on the device
(port of langsplat4d/preprocess/clip_features.py; reference
preprocess/generate_clip_features.py).

For each frame: the 4-level seg stack's segments, each blacked out of the
image, cropped to its box, padded to a square and resized to 224x224, are
encoded by an injected image encoder; `*_f.npy` (segments x D, fp16) and
`*_s.npy` (4 x H x W int32 seg map with cross-level offset relabelling) are
written.

The reference resizes each tile with cv2.resize(INTER_LINEAR), which the
GPU host lacks. `crop_pad_resize` computes every tile of a level in one
batched gather, byte-equal to cv2 5.0's uint8 INTER_LINEAR: 11-bit taps
from float32 source positions (d + 0.5) * (1 / (224 / s)) - 0.5, each tap
rounded half to even from (1 - f) * 2048 and f * 2048, the positions kept
fractional at the edges while the rows and columns they read clamp; the
horizontal pass exact in integers, the vertical pass with cv2's
`((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2` rounding.
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from langsplat4d_torch.core.device import resolve_device
from langsplat4d_torch.data.codec import read_image
from langsplat4d_torch.preprocess import local_model

LEVEL_NAMES = ("default", "s", "m", "l")
TILE = 224
COEF_ONE = 2048          # cv2's INTER_RESIZE_COEF_SCALE: 11-bit taps
CLIP_MODEL = "CLIP ViT-B/16 (laion2b_s34b_b88k)"


def rgb(img: torch.Tensor) -> torch.Tensor:
    """PIL's `.convert("RGB")` of a decoded [H, W, C] uint8 image: grey
    replicated, alpha dropped."""
    if img.shape[2] <= 2:
        return img[..., :1].expand(-1, -1, 3)
    return img[..., :3]


def masks_from_stack(mask_stack, device=None) -> List[List[Dict]]:
    """[L, H, W] DEVA mask stack -> per-level list of {segmentation, label,
    bbox} dicts (reference sam_encoder). Labels are 1-based in the stack;
    absent labels are skipped; bbox is (x, y, w, h) as Python ints in the
    inclusive-extent convention (w = x_max - x_min). Every level's boxes
    come from one scatter_reduce over (level, label) and one host copy."""
    dev = resolve_device(device)
    stack = torch.as_tensor(mask_stack, device=dev)
    n_lvl, h, w = stack.shape
    top = int(stack.max()) if stack.numel() else 0
    if top < 1:
        return [[] for _ in range(n_lvl)]
    lab = stack.reshape(n_lvl, -1).long().clamp(min=0)      # background: 0
    key = (lab + (top + 1) * torch.arange(n_lvl, device=dev)[:, None]
           ).reshape(-1)
    ys = torch.arange(h, device=dev).repeat_interleave(w).repeat(n_lvl)
    xs = torch.arange(w, device=dev).repeat(h * n_lvl)
    n_key = n_lvl * (top + 1)

    def reduce(vals, how, init):
        return torch.full((n_key,), init, dtype=torch.long, device=dev
                          ).scatter_reduce(0, key, vals, how)
    table = torch.stack([torch.bincount(key, minlength=n_key),
                         reduce(xs, "amin", w), reduce(ys, "amin", h),
                         reduce(xs, "amax", -1), reduce(ys, "amax", -1)], 1)
    table = table.reshape(n_lvl, top + 1, 5)[:, 1:].tolist()
    all_levels = []
    for i, rows in enumerate(table):
        labels = [j + 1 for j, r in enumerate(rows) if r[0]]
        segs = stack[i][None] == torch.tensor(labels, dtype=stack.dtype,
                                              device=dev)[:, None, None]
        all_levels.append([
            {"segmentation": seg, "label": j,
             "bbox": [rows[j - 1][1], rows[j - 1][2],
                      rows[j - 1][3] - rows[j - 1][1],
                      rows[j - 1][4] - rows[j - 1][2]]}
            for seg, j in zip(segs, labels)])
    return all_levels


def get_seg_img(mask: Dict, image: torch.Tensor) -> torch.Tensor:
    """Black out everything outside the segment and crop to its bbox (the
    crop ends before x + w and y + h, as the reference's slice does)."""
    img = torch.where(mask["segmentation"][..., None], image,
                      torch.zeros((), dtype=image.dtype, device=image.device))
    x, y, w, h = (int(v) for v in mask["bbox"])
    return img[y:y + h, x:x + w]


def pad_img(img: torch.Tensor) -> torch.Tensor:
    """Pad to a square, the image centred (offset rounded down)."""
    h, w, c = img.shape
    s = max(w, h)
    pad = torch.zeros((s, s, c), dtype=img.dtype, device=img.device)
    if h > w:
        pad[:, (h - w) // 2:(h - w) // 2 + w] = img
    else:
        pad[(w - h) // 2:(w - h) // 2 + h] = img
    return pad


def linear_taps(sizes: torch.Tensor, out: int = TILE):
    """cv2 INTER_LINEAR's taps from each source length in `sizes` [S] to
    `out`: (first index, second index, first weight, second weight), each
    [S, out], the weights in 1/2048."""
    scale = 1.0 / (out / sizes.to(torch.float64))           # cv2: 1 / inv
    d = torch.arange(out, dtype=torch.float64, device=sizes.device)
    f = ((d + 0.5) * scale[:, None] - 0.5).to(torch.float32)
    i = torch.floor(f)
    f = f - i
    i = i.long()
    last = (sizes - 1)[:, None]
    c0 = torch.round((1.0 - f) * COEF_ONE).to(torch.int32)
    c1 = torch.round(f * COEF_ONE).to(torch.int32)
    return (torch.minimum(i.clamp(min=0), last),
            torch.minimum((i + 1).clamp(min=0), last), c0, c1)


def crop_pad_resize(image: torch.Tensor, segs: torch.Tensor,
                    boxes: torch.Tensor, out: int = TILE) -> torch.Tensor:
    """`cv2.resize(pad_img(get_seg_img(mask_k, image)), (out, out))` for
    every segment k at once -> [S, out, out, C] uint8.

    image [H, W, C] uint8; segs [S, H, W] bool; boxes [S, 4] int64 (x, y,
    w, h), w and h >= 1. Each output pixel reads its four source pixels of
    the padded square straight from the image (zero outside the crop and
    outside the segment)."""
    _, wid, ch = image.shape
    n = boxes.shape[0]
    x, y, w, h = boxes.long().unbind(1)
    side = torch.maximum(w, h)
    off_x = torch.where(h > w, (h - w) // 2, 0)
    off_y = torch.where(h > w, 0, (w - h) // 2)
    i0, i1, c0, c1 = linear_taps(side, out)

    def axis(idx, off, start, extent):
        """padded-square index -> image index (clamped) and inside-crop"""
        c = idx - off[:, None]
        inside = (c >= 0) & (c < extent[:, None])
        return start[:, None] + torch.minimum(c.clamp(min=0),
                                              extent[:, None] - 1), inside
    rows = [axis(i, off_y, y, h) for i in (i0, i1)]
    cols = [axis(i, off_x, x, w) for i in (i0, i1)]
    flat_img = image.reshape(-1, ch)
    flat_seg = segs.reshape(n, -1)

    def pixels(r, c):
        (gy, ok_y), (gx, ok_x) = r, c
        at = gy[:, :, None] * wid + gx[:, None, :]              # [S, out, out]
        ok = (ok_y[:, :, None] & ok_x[:, None, :]
              & flat_seg.gather(1, at.reshape(n, -1)).reshape(at.shape))
        return flat_img[at].to(torch.int32) * ok[..., None]

    a0, a1 = c0[:, None, :, None], c1[:, None, :, None]
    b0, b1 = c0[:, :, None, None], c1[:, :, None, None]
    s0 = pixels(rows[0], cols[0]) * a0 + pixels(rows[0], cols[1]) * a1
    s1 = pixels(rows[1], cols[0]) * a0 + pixels(rows[1], cols[1]) * a1
    res = ((((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2)
    return res.clamp(0, 255).to(torch.uint8)


def mask2segmap(masks: List[Dict], image, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (tiles [S, 3, 224, 224] float32 in [0, 1], seg_map [H, W] int32
    with -1 background), 0-based per-level ids (a later mask wins where two
    overlap, as the reference's in-order writes). Masks with a zero-width or
    zero-height bbox are dropped."""
    dev = resolve_device(device)
    image = torch.as_tensor(image, device=dev)
    masks = [m for m in masks if m["bbox"][2] != 0 and m["bbox"][3] != 0]
    seg_map = torch.full(image.shape[:2], -1, dtype=torch.int32, device=dev)
    if not masks:
        return (torch.zeros((0, 3, TILE, TILE), dtype=torch.float32,
                            device=dev), seg_map)
    segs = torch.stack([torch.as_tensor(m["segmentation"], device=dev)
                        for m in masks]).bool()
    boxes = torch.tensor([[int(v) for v in m["bbox"]] for m in masks],
                         dtype=torch.int64, device=dev)
    tiles = crop_pad_resize(image, segs, boxes).to(torch.float32) / 255.0
    n = len(masks)
    last = n - 1 - segs.flip(0).to(torch.uint8).argmax(0)
    seg_map = torch.where(segs.any(0), last.to(torch.int32), seg_map)
    return tiles.permute(0, 3, 1, 2), seg_map


def create_frame_features(
    image,                       # [H, W, 3] uint8 RGB
    mask_stack,                  # [4, H, W]
    encode_image: Callable[[torch.Tensor], torch.Tensor],  # tiles -> [S, D]
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame -> (features [total_segments, D] fp16, seg_map [4, H, W]
    int32) on the device.

    Cross-level offset relabelling: level j's ids are shifted by the
    cumulative segment counts of levels < j so the flat feature table
    indexes all levels (reference create())."""
    dev = resolve_device(device)
    image = torch.as_tensor(image, device=dev)
    feats, seg_maps, lengths = [], [], []
    for masks in masks_from_stack(mask_stack, dev):
        tiles, seg_map = mask2segmap(masks, image, dev)
        emb = (torch.as_tensor(encode_image(tiles), device=dev) if len(tiles)
               else torch.zeros((0, 512), dtype=torch.float32, device=dev))
        emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
                     + 1e-12)
        feats.append(emb)
        seg_maps.append(seg_map)
        lengths.append(len(emb))
    cumsum = np.cumsum(lengths)
    out_maps = [seg_maps[0]]
    for j in range(1, len(seg_maps)):
        v = seg_maps[j]
        assert int(v.max()) == lengths[j] - 1, (j, int(v.max()),
                                                lengths[j] - 1)
        out_maps.append(torch.where(v != -1, v + int(cumsum[j - 1]), v))
    features = torch.cat(feats, dim=0).to(torch.float16)
    seg_map = torch.stack(out_maps, dim=0)
    assert len(features) == int(seg_map.max()) + 1
    return features, seg_map


def process_sequence(image_paths: List[str], seg_paths: List[str],
                     save_folder: str,
                     encode_image: Callable[[torch.Tensor], torch.Tensor],
                     device=None) -> None:
    """Walk aligned (image, mask-stack) lists, write *_f.npy (float16) and
    *_s.npy (int32). Images are read through the port's codec."""
    dev = resolve_device(device)
    os.makedirs(save_folder, exist_ok=True)
    for img_path, seg_path in zip(image_paths, seg_paths):
        image = rgb(torch.from_numpy(read_image(img_path)).to(dev))
        mask_stack = torch.from_numpy(np.load(seg_path)).to(dev)
        features, seg_map = create_frame_features(image, mask_stack,
                                                  encode_image, dev)
        stem = os.path.splitext(os.path.basename(img_path))[0]
        np.save(os.path.join(save_folder, stem + "_f.npy"),
                features.cpu().numpy())
        np.save(os.path.join(save_folder, stem + "_s.npy"),
                seg_map.cpu().numpy())


class TransformersClipImageEncoder:
    """CLIP ViT-B/16's image tower through transformers, from a local copy
    of the checkpoint (the reference uses open_clip laion2b_s34b_b88k).
    Raises, naming the model, without one."""

    def __init__(self, model_path=None, batch: int = 64, device=None):
        transformers = local_model(model_path, CLIP_MODEL, "transformers")
        self.device = resolve_device(device)
        self.model = transformers.CLIPModel.from_pretrained(
            model_path, local_files_only=True).to(self.device).eval()
        self.batch = batch
        self.mean = torch.tensor([0.48145466, 0.4578275, 0.40821073],
                                 device=self.device).reshape(3, 1, 1)
        self.std = torch.tensor([0.26862954, 0.26130258, 0.27577711],
                                device=self.device).reshape(3, 1, 1)

    def __call__(self, tiles: torch.Tensor) -> torch.Tensor:
        out = []
        with torch.no_grad():
            for i in range(0, len(tiles), self.batch):
                x = (tiles[i:i + self.batch].to(self.device) - self.mean
                     ) / self.std
                out.append(self.model.get_image_features(pixel_values=x))
        return torch.cat(out, dim=0).float()


def main(argv=None):
    """The reference's extract_clip_features flow: every image of
    <scene>/rgb/2x with the mask stack of the same rank in --mask_dir ->
    <scene>/language_features."""
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--scene_path", type=str, required=True)
    p.add_argument("--mask_dir", type=str, required=True)
    p.add_argument("--image_dir", type=str, default=None,
                   help="default: <scene_path>/rgb/2x")
    p.add_argument("--save_folder", type=str, default=None,
                   help="default: <scene_path>/language_features")
    p.add_argument("--model_path", type=str, default=None,
                   help=f"a local copy of {CLIP_MODEL} (required)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the current CUDA device by default")
    args = p.parse_args(argv)
    encoder = TransformersClipImageEncoder(args.model_path,
                                           device=args.device)
    image_dir = args.image_dir or os.path.join(args.scene_path, "rgb", "2x")
    images = sorted(glob.glob(os.path.join(image_dir, "*.png")))
    segs = sorted(glob.glob(os.path.join(args.mask_dir, "*.npy")))
    process_sequence(images, segs, args.save_folder or os.path.join(
        args.scene_path, "language_features"), encoder, args.device)


if __name__ == "__main__":
    main()
