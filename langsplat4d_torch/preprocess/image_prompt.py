"""Per-object visual prompts for the MLLM captioner, on the device: the object
sharp, the background blurred and grey, a red outline along the mask's
boundary (port of langsplat4d/preprocess/image_prompt.py; reference
preprocess/generate_image_prompt.py).

The JAX package draws them with PIL; the port computes PIL 12's bytes
itself:
- `GaussianBlur(radius=10)` is Pillow's three box-blur passes per axis
  (horizontal, then vertical), each with its fractional box radius, 24-bit
  fixed-point weights and clamped edges, rounded to uint8 after each pass:
  integer window sums from int64 cumulative sums;
- the `L` conversion is (19595 R + 38470 G + 7471 B + 0x8000) >> 16, back
  to RGBA with alpha 255, and `Image.composite` with a 0/255 mask a select;
- every `ellipse((x-2, y-2, x+2, y+2), outline="red", width=2)` paints the
  same 20 pixels (the 5x5 square less its corners and centre), so the
  outline is one dilation of the mask's 4-neighbour boundary by that stamp,
  clipped at the image's edges.
A frame is blurred once for all its objects. The PNGs are the bytes PIL
writes: Pillow's per-row filter choice (None, Up, Sub, Paeth; the first
with the least sum of |byte|) on the device, then its zlib settings and
IDAT chunking (data/png.py `png_from_rows`).

The port encodes no video: `pic2video` raises, and `main` writes the prompt
frames only (the captioner reads the frame directories).
"""
from __future__ import annotations

import argparse
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Set

import numpy as np
import torch

from langsplat4d_torch.core.device import resolve_device
from langsplat4d_torch.data.codec import read_image
from langsplat4d_torch.data.png import png_from_rows

BLUR_RADIUS = 10
BLUR_PASSES = 3
RED = (255, 0, 0, 255)
# the pixels one ellipse((x-2, y-2, x+2, y+2), width=2) paints about (x, y)
STAMP = torch.tensor([[0, 1, 1, 1, 0],
                      [1, 1, 1, 1, 1],
                      [1, 1, 0, 1, 1],
                      [1, 1, 1, 1, 1],
                      [0, 1, 1, 1, 0]], dtype=torch.float32)
PILLOW_FILTERS = (0, 2, 1, 4)     # None, Up, Sub, Paeth: the order tried
PNG_WORKERS = 8
MAX_PENDING = 2 * PNG_WORKERS


def rgba(img: torch.Tensor) -> torch.Tensor:
    """PIL's `.convert("RGBA")` of a decoded [H, W, C] uint8 image: grey
    replicated, alpha 255 where the image has none."""
    c = img.shape[2]
    colour = img[..., :1].expand(-1, -1, 3) if c <= 2 else img[..., :3]
    alpha = (img[..., c - 1:] if c in (2, 4) else
             torch.full_like(img[..., :1], 255))
    return torch.cat([colour, alpha], dim=2)


def box_radius(radius: float = BLUR_RADIUS, passes: int = BLUR_PASSES
               ) -> np.float32:
    """Pillow's `_gaussian_blur_radius` (BoxBlur.c), in its C float and
    double arithmetic: the fractional box radius whose `passes` box blurs
    approximate a Gaussian of that radius."""
    f32, f64 = np.float32, np.float64
    sigma2 = f32(radius) * f32(radius) / f32(passes)
    big_l = f32(np.sqrt(12.0 * f64(sigma2) + 1.0))
    small_l = f32(np.floor((f64(big_l) - 1.0) / 2.0))
    a = (f32(2) * small_l + f32(1)) * (small_l * (small_l + f32(1))
                                       - f32(3) * sigma2)
    a = a / (f32(6) * (sigma2 - (small_l + f32(1)) * (small_l + f32(1))))
    return small_l + a


def box_pass(x: torch.Tensor, dim: int, radius: np.float32) -> torch.Tensor:
    """One Pillow box-blur line pass (ImagingLineBoxBlur) along `dim` of an
    int64 tensor of uint8 values: the window of radius int(radius) plus the
    two pixels beyond it at the fractional weight, edges clamped,
    (sum * ww + far * fw + 2^23) >> 24."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    n = x.shape[dim]
    idx = torch.arange(-r - 1, n + r + 1, device=x.device).clamp(0, n - 1)
    p = x.index_select(dim, idx)                      # n + 2r + 2, clamped
    cs = torch.cumsum(p, dim)
    window = cs.narrow(dim, 2 * r + 1, n) - cs.narrow(dim, 0, n)
    far = p.narrow(dim, 0, n) + p.narrow(dim, 2 * r + 2, n)
    return (window * ww + far * fw + (1 << 23)) >> 24


def gaussian_blur(img: torch.Tensor, radius: float = BLUR_RADIUS
                  ) -> torch.Tensor:
    """PIL's `filter(ImageFilter.GaussianBlur(radius))` of an [H, W, C] uint8
    image (no premultiplied alpha, as Pillow)."""
    fr = box_radius(radius, BLUR_PASSES)
    x = img.to(torch.int64)
    for dim in (1, 0):
        for _ in range(BLUR_PASSES):
            x = box_pass(x, dim, fr)
    return x.to(torch.uint8)


def grey_rgba(img: torch.Tensor) -> torch.Tensor:
    """PIL's `.convert("L").convert("RGBA")` of an [H, W, 4] uint8 image."""
    c = img.to(torch.int32)
    lum = ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
            + 0x8000) >> 16).to(torch.uint8)
    return torch.stack([lum, lum, lum, torch.full_like(lum, 255)], dim=-1)


def outline(masks: torch.Tensor) -> torch.Tensor:
    """[K, H, W] bool masks -> the pixels their red outlines paint: the
    boundary (a mask pixel with a 4-neighbour outside the mask or the
    image) dilated by STAMP, clipped at the image."""
    pad = torch.nn.functional.pad(masks, (1, 1, 1, 1))
    inner = (pad[:, :-2, 1:-1] & pad[:, 2:, 1:-1]
             & pad[:, 1:-1, :-2] & pad[:, 1:-1, 2:])
    boundary = (masks & ~inner).to(torch.float32)[:, None]
    hits = torch.nn.functional.conv2d(
        boundary, STAMP.to(boundary.device)[None, None], padding=2)
    return hits[:, 0] > 0


def highlight(image: torch.Tensor, bw: torch.Tensor,
              masks: torch.Tensor) -> torch.Tensor:
    """One composite per mask of [K, H, W]: `image` [H, W, 4] inside the
    mask, `bw` (its blurred grey) outside, the red outline over both ->
    [K, H, W, 4] uint8."""
    final = torch.where(masks[..., None], image, bw)
    red = torch.tensor(RED, dtype=torch.uint8, device=image.device)
    return torch.where(outline(masks)[..., None], red, final)


def highlight_object(image, mask_for_id, device=None) -> torch.Tensor:
    """One composite: object sharp, background blurred and grey, red outline
    along the mask boundary. image [H, W, C] uint8 (C = 1 to 4, converted
    as PIL's "RGBA"), mask [H, W] bool -> [H, W, 4] uint8."""
    dev = resolve_device(device)
    image = rgba(torch.as_tensor(image, device=dev))
    mask = torch.as_tensor(mask_for_id, device=dev).bool()
    return highlight(image, grey_rgba(gaussian_blur(image)), mask[None])[0]


def pillow_rows(img: torch.Tensor) -> torch.Tensor:
    """[H, W, C] uint8 -> its filtered scanlines [H, 1 + W * C] uint8 under
    Pillow's filter choice (ZipEncode.c without `optimize`): per row, of
    None, Up, Sub and Paeth, the first with the least sum of min(v, 256 -
    v) over its bytes."""
    h, w, c = img.shape
    line = img.reshape(h, w * c).to(torch.int16)
    prev = torch.nn.functional.pad(line, (0, 0, 1, 0))[:-1]
    left = torch.nn.functional.pad(line, (c, 0))[:, :-c]
    upleft = torch.nn.functional.pad(prev, (c, 0))[:, :-c]
    p = left + prev - upleft
    pa, pb, pc = (p - left).abs(), (p - prev).abs(), (p - upleft).abs()
    paeth = torch.where((pa <= pb) & (pa <= pc), left,
                        torch.where(pb <= pc, prev, upleft))
    cand = torch.stack([line, line - prev, line - left, line - paeth]) % 256
    cost = torch.minimum(cand, 256 - cand).sum(dim=2)          # [4, H]
    pick = cost.argmin(dim=0)                                  # first least
    rows = cand.gather(0, pick[None, :, None].expand(1, h, w * c))[0]
    tag = torch.tensor(PILLOW_FILTERS, device=img.device)[pick]
    return torch.cat([tag[:, None], rows], dim=1).to(torch.uint8)


def _write_png(path: str, rows: np.ndarray, w: int, bpp: int) -> None:
    with open(path, "wb") as f:
        f.write(png_from_rows(rows, w, bpp, pillow=True))


def process_frames(unique_ids: Iterable[int], num_frames: int, mask_dir: str,
                   image_dir: str, output_dir: str, begin_idx: int = 1,
                   end_str: str = "png", device=None) -> None:
    """For every frame {i:06}.{end_str} of image_dir and its id map
    {i:06}.npy of mask_dir, the prompt of each id present in the frame as
    {output_dir}/{id:02}/{i:06}.png (RGBA, PIL's bytes). The frame is
    blurred once for all its ids; the PNGs compress on PNG_WORKERS threads
    (zlib releases the interpreter lock), with at most MAX_PENDING prompts
    waiting for them: the card makes prompts faster than the threads
    deflate them, so an unbounded queue would hold a sequence's prompts at
    once."""
    dev = resolve_device(device)
    ids = list(unique_ids)
    with ThreadPoolExecutor(PNG_WORKERS) as pool:
        pending = deque()
        for i in range(begin_idx, num_frames + begin_idx):
            image = rgba(torch.from_numpy(read_image(
                f"{image_dir}/{i:06}.{end_str}")).to(dev))
            bw = grey_rgba(gaussian_blur(image))
            mask = torch.from_numpy(np.load(f"{mask_dir}/{i:06}.npy")).to(dev)
            masks = mask[None] == torch.tensor(ids, device=dev).to(
                mask.dtype)[:, None, None]
            present = masks.flatten(1).any(dim=1).tolist()
            for mask_id, m, here in zip(ids, masks, present):
                if not here:
                    continue
                final = highlight(image, bw, m[None])[0]
                rows = pillow_rows(final).cpu().numpy()
                os.makedirs(f"{output_dir}/{mask_id:02}", exist_ok=True)
                pending.append(pool.submit(
                    _write_png, f"{output_dir}/{mask_id:02}/{i:06}.png",
                    rows, final.shape[1], 4))
                while len(pending) > MAX_PENDING:
                    pending.popleft().result()
        for fut in pending:
            fut.result()


def pic2video(input_dir: str, output_path: str, fps: int = 30) -> None:
    """The reference writes each object's prompt frames as an mp4; the port
    encodes no video."""
    raise NotImplementedError(
        f"{output_path}: the port encodes no video; the prompt frames of "
        f"{input_dir} are what the captioner reads")


def collect_unique_ids(mask_dir: str, num_frames: int, begin_idx: int = 1,
                       device=None) -> Set[int]:
    dev = resolve_device(device)
    ids: Set[int] = set()
    for i in range(begin_idx, num_frames + begin_idx):
        mask = torch.from_numpy(np.load(f"{mask_dir}/{i:06}.npy")).to(dev)
        ids.update(torch.unique(mask).tolist())
    return ids


def main(argv=None):
    p = argparse.ArgumentParser(description="Per-object prompt frames")
    p.add_argument("--mask_dir", type=str, required=True)
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="./prompt_images")
    p.add_argument("--begin_idx", type=int, default=1)
    p.add_argument("--end_str", type=str, default="png")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the current CUDA device by default")
    args = p.parse_args(argv)
    num_frames = len(os.listdir(args.image_dir))
    ids = collect_unique_ids(args.mask_dir, num_frames, args.begin_idx,
                             args.device)
    process_frames(ids, num_frames, args.mask_dir, args.image_dir,
                   args.output_dir, args.begin_idx, args.end_str, args.device)
    print(f"prompt frames of {len(ids)} ids under {args.output_dir}; no "
          f"mp4s: the port encodes no video, and the captioner reads the "
          f"frame directories")
    return ids


if __name__ == "__main__":
    main()
