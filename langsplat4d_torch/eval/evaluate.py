"""Open-vocabulary localization and time-sensitive query evaluation (port of
langsplat4d/eval/evaluate.py; reference eval/eval.py and eval/eval_utils.py).

COCO annotation parsing with polygon masks (a scanline fill of the port's
own, with OpenCV's pixel rule), the avg-pool heatmap smoothing, the
smooth_cuda mask cleanup, and `activate_stream`: relevancy -> smoothing ->
threshold -> IoU per level -> best level. The maps stay on their device;
only the IoUs, levels, scores and thresholds go to the host, once a frame.
The ground-truth masks are written as JPEG through the port's encoder
(data/jpeg.py), as the JAX package writes them through cv2, the other
pictures as PNG; the two plot helpers need matplotlib, imported when they
are called.
"""
from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from langsplat4d_torch.data.jpeg import write_jpeg
from langsplat4d_torch.data.png import png_bytes
from langsplat4d_torch.eval.colormaps import ColormapOptions, apply_colormap
from langsplat4d_torch.eval.relevancy import relevancy_maps

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Mask helpers (eval/eval_utils.py)
# ---------------------------------------------------------------------------

def _line_pixels(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """The pixels of an 8-connected line between two integer points: one a
    step along the major axis, the minor coordinate rounded."""
    d = p1 - p0
    n = int(np.abs(d).max())
    if n == 0:
        return p0[None]
    k = np.arange(n + 1)[:, None]
    return p0 + np.floor(k * d / n + 0.5).astype(np.int64)


def polygon_to_mask(img_shape: Tuple[int, int], points_list) -> np.ndarray:
    """A polygon filled as OpenCV's `fillPoly` fills it (uint8, 1 inside):
    the vertices truncated to integers; on each row y, the spans between
    consecutive pairs of sorted edge crossings, each edge covering rows
    [y_top, y_bottom), filled from ceil(x_left) to floor(x_right); and
    every edge drawn as an 8-connected line. Where a pixel centre lies
    within half a pixel of an edge, the line's rounding may pick another
    pixel than OpenCV's fixed-point walk."""
    h, w = img_shape
    pts = np.asarray(points_list, dtype=np.int32).astype(np.int64)
    mask = np.zeros((h, w), np.uint8)
    p0, p1 = pts, np.roll(pts, -1, axis=0)
    slanted = p0[:, 1] != p1[:, 1]
    a, b = p0[slanted], p1[slanted]
    top = np.minimum(a[:, 1], b[:, 1])
    bot = np.maximum(a[:, 1], b[:, 1])
    for y in range(max(int(top.min(initial=h)), 0),
                   min(int(bot.max(initial=0)), h)):
        on = (top <= y) & (y < bot)
        ea, eb = a[on], b[on]
        xs = np.sort(ea[:, 0] + (y - ea[:, 1]) * (eb[:, 0] - ea[:, 0])
                     / (eb[:, 1] - ea[:, 1]))
        for xl, xr in zip(xs[0::2], xs[1::2]):
            x0, x1 = max(int(np.ceil(xl)), 0), min(int(np.floor(xr)), w - 1)
            if x0 <= x1:
                mask[y, x0:x1 + 1] = 1
    for q0, q1 in zip(p0, p1):
        px = _line_pixels(q0, q1)
        ok = ((px[:, 0] >= 0) & (px[:, 0] < w) & (px[:, 1] >= 0)
              & (px[:, 1] < h))
        mask[px[ok, 1], px[ok, 0]] = 1
    return mask


# OpenCV's numbering of a pixel's eight neighbours (CV_INIT_3X3_DELTAS,
# icvCodeDeltas): 0 east, then counter-clockwise on the screen
_NEIGHBOURS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1),
               (1, 1))
_RIGHT_EDGE = -126           # (schar)(2 | -128): a border pixel whose east
                             # neighbour the follower saw as background


def _follow_outer_border(img: np.ndarray, x0: int, y0: int) -> List[tuple]:
    """OpenCV's `icvFetchContour` at CHAIN_APPROX_SIMPLE on an outer border
    starting at (x0, y0) of the zero-padded int8 image `img`: the border
    followed with the start's neighbours searched clockwise from the
    north-west, then each pixel's counter-clockwise from where the walk came
    in; a pixel becomes _RIGHT_EDGE where that search passed its east
    neighbour as background, else 2 where it was still 1; a point is kept
    where the walk turns. -> [(x, y)] in the padded image."""
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        x1, y1 = x0 + _NEIGHBOURS[s][0], y0 + _NEIGHBOURS[s][1]
        if img[y1, x1] != 0 or s == s_end:
            break
    if s == s_end:                                   # a lone pixel
        img[y0, x0] = _RIGHT_EDGE
        return [(x0, y0)]
    points = []
    x3, y3, prev_s = x0, y0, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            x4, y4 = x3 + _NEIGHBOURS[s & 7][0], y3 + _NEIGHBOURS[s & 7][1]
            if img[y4, x4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:
            img[y3, x3] = _RIGHT_EDGE
        elif img[y3, x3] == 1:
            img[y3, x3] = 2
        if s != prev_s:
            points.append((x3, y3))
            prev_s = s
        if (x4, y4) == (x0, y0) and (x3, y3) == (x1, y1):
            return points
        x3, y3, s = x4, y4, (s + 4) & 7


def external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """The outer borders of the 8-connected components of a 2-d mask's
    nonzero pixels, as OpenCV's `findContours(mask, RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE)` gives them (Suzuki and Abe's border following in
    OpenCV's raster scan): each an int32 [N, 2] array of (x, y) points, the
    turns of the border, from its first pixel in raster order down its left
    side; a component inside another's hole is left out; the last found
    first. The image's own edge pixels count (OpenCV pads the image with a
    frame of zeros)."""
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = mask != 0
    found = []
    for y in range(1, h + 1):
        row = img[y]
        lnbd_x, prev, x = 0, 0, 1          # the last border pixel on the row
        while x <= w:
            p = int(row[x])
            if p == prev:
                x += 1
                continue
            if prev == 0 and p == 1:       # an outer border starts here
                if img[y, lnbd_x] <= 0:    # not inside a traced component
                    found.append(_follow_outer_border(img, x, y))
                    prev = int(row[x])
                    x += 1
                    continue
            elif p == 0 and prev >= 1 and prev & -2:
                lnbd_x = x - 1             # a hole's start, not followed
            prev = p
            if prev & -2:
                lnbd_x = x
            x += 1
    return [np.asarray(c, np.int32) - 1 for c in reversed(found)]


def bounding_rect(points: np.ndarray) -> Tuple[int, int, int, int]:
    """OpenCV's `boundingRect` of integer points [N, 2]: (x, y, w, h) with
    w and h counting pixels."""
    lo, hi = points.min(0), points.max(0)
    return int(lo[0]), int(lo[1]), int(hi[0] - lo[0] + 1), \
        int(hi[1] - lo[1] + 1)


def stack_mask(mask_base: np.ndarray, mask_add: np.ndarray) -> np.ndarray:
    mask = mask_base.copy()
    mask[mask_add != 0] = 1
    return mask


def _avg_pool_same(x: torch.Tensor, kernel: int,
                   padding: int) -> torch.Tensor:
    """AvgPool2d(kernel, stride=1, padding, count_include_pad=False) over
    the last two axes of [..., H, W]."""
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape(-1, 1, *x.shape[-2:]), kernel, stride=1,
                     padding=padding, count_include_pad=False)
    return y.reshape(*lead, *y.shape[-2:])


def smooth_mask(mask: torch.Tensor) -> torch.Tensor:
    """smooth_cuda (eval_utils.py:95-100): 7x7 avg pool (pad 3) > 0.5."""
    return _avg_pool_same(mask.to(torch.float32), 7, 3) > 0.5


def majority_smooth(mask: torch.Tensor) -> torch.Tensor:
    """Reference `smooth` (eval/eval_utils.py:46-55): per-pixel majority
    vote over a 7x7 window with the reference's boundary clamp (the upper
    bounds clamp to h-1 / w-1 exclusive, so edge windows drop the last row
    and column); strictly more than half wins. Through an integral image."""
    h, w = mask.shape[-2:]
    dev = mask.device
    ii = F.pad(mask.to(torch.int64).cumsum(0).cumsum(1), (1, 0, 1, 0))
    i = torch.arange(h, device=dev)
    j = torch.arange(w, device=dev)
    lo_i, hi_i = (i - 3).clamp(min=0), (i + 4).clamp(max=h - 1)
    lo_j, hi_j = (j - 3).clamp(min=0), (j + 4).clamp(max=w - 1)
    s = (ii[hi_i[:, None], hi_j[None, :]] - ii[lo_i[:, None], hi_j[None, :]]
         - ii[hi_i[:, None], lo_j[None, :]] + ii[lo_i[:, None], lo_j[None, :]])
    cnt = (hi_i - lo_i)[:, None] * (hi_j - lo_j)[None, :]
    return (2 * s > cnt).to(mask.dtype)


def _write_png(img: np.ndarray, save_path: Path) -> None:
    save_path.parent.mkdir(exist_ok=True, parents=True)
    with open(save_path, "wb") as f:
        f.write(png_bytes(np.ascontiguousarray(img)))


def vis_mask_save(mask, save_path) -> None:
    """Binary mask -> white-on-black image (eval_utils.py:75-79) at
    `save_path`: JPEG for a `.jpg` / `.jpeg` path at cv2's default quality
    95 (data/jpeg.py), as the JAX package's cv2.imwrite writes it; PNG for
    any other path, which gets the `.png` suffix."""
    m = np.asarray(torch.as_tensor(mask).cpu())
    out = m.astype(np.uint8)
    out[m == 1] = 255
    save_path = Path(save_path)
    if save_path.suffix.lower() in (".jpg", ".jpeg"):
        save_path.parent.mkdir(exist_ok=True, parents=True)
        write_jpeg(str(save_path), out, quality=95)
        return
    _write_png(out, save_path.with_suffix(".png"))


def colormap_saving(image: np.ndarray, colormap_options, save_path) -> None:
    """Apply the colormap and write a PNG (eval_utils.py:57-72)."""
    out = apply_colormap(image, colormap_options)
    _write_png((np.clip(out, 0, 1) * 255).astype(np.uint8),
               Path(save_path).with_suffix(".png"))


# ---------------------------------------------------------------------------
# COCO GT parsing (eval_gt_lerfdata, eval/eval.py:48-140)
# ---------------------------------------------------------------------------

def load_coco_annotations(json_folder: str, prompts: Optional[Sequence[str]]
                          = None, replace_prompts: Optional[Dict] = None,
                          dataset_type: str = "hypernerf",
                          visualize_results: bool = False,
                          vis_output_path: Optional[str] = None):
    with open(os.path.join(json_folder, "_annotations.coco.json")) as f:
        data = json.load(f)
    id2name = {int(it["id"]): it["name"] for it in data["categories"]}
    name2id = {v: k for k, v in id2name.items()}
    gt_ann: Dict[str, Dict] = {}
    img_paths: List[str] = []
    im_id2imidx: Dict[int, int] = {}
    h = w = 0
    for img_data in data["images"]:
        img_ann: Dict[str, Dict] = defaultdict(dict)
        idx = img_data["id"]
        img_name = img_data["file_name"]
        img_paths.append(os.path.join(json_folder, img_name))
        h, w = img_data["height"], img_data["width"]
        for annotation in data["annotations"]:
            if annotation["image_id"] != idx:
                continue
            label = id2name[annotation["category_id"]]
            if prompts is not None and label not in prompts:
                continue
            box = np.asarray(annotation["bbox"], dtype=np.float64).reshape(-1)
            box[2] += box[0]
            box[3] += box[1]
            segmentation = annotation["segmentation"][0]
            assert len(segmentation) % 2 == 0
            pts = [[segmentation[i], segmentation[i + 1]]
                   for i in range(0, len(segmentation), 2)]
            mask = polygon_to_mask((h, w), pts)
            label_list = [label]
            if replace_prompts is not None and label in replace_prompts:
                label_list = list(replace_prompts[label]) + [label]
            for lbl in label_list:
                if img_ann[lbl].get("mask") is not None:
                    mask2 = stack_mask(img_ann[lbl]["mask"], mask)
                    img_ann[lbl]["bboxes"] = np.concatenate(
                        [np.asarray(img_ann[lbl]["bboxes"]).reshape(-1, 4),
                         box.reshape(-1, 4)], axis=0)
                    img_ann[lbl]["mask"] = mask2
                else:
                    img_ann[lbl]["bboxes"] = box
                    img_ann[lbl]["mask"] = mask
                if visualize_results and vis_output_path is not None:
                    vis_mask_save(
                        img_ann[lbl]["mask"],
                        os.path.join(vis_output_path, "gt",
                                     img_name.split(".")[0], f"{lbl}.jpg"))
        gt_ann[f"{idx}"] = img_ann
    for item in data["images"]:
        idx = item["id"]
        stem = int(item["file_name"].split("_")[0])
        im_id2imidx[idx] = stem - 1 if dataset_type == "hypernerf" else stem
    return gt_ann, (h, w), img_paths, id2name, name2id, im_id2imidx


# ---------------------------------------------------------------------------
# activate_stream (eval/eval.py:143-315)
# ---------------------------------------------------------------------------

def smooth_heatmaps(valid_map: torch.Tensor, scale: int) -> torch.Tensor:
    """0.5 (avg pool + raw) of [L, P, H, W] relevancy maps; the reference's
    AvgPool2d(kernel=scale, padding=14)."""
    return 0.5 * (_avg_pool_same(valid_map, scale, 14) + valid_map)


def _normalized(m: torch.Tensor) -> torch.Tensor:
    out = m - m.min()
    out = out / (out.max() + 1e-9)
    return torch.clip(out * 2.0 - 1.0, 0, 1)


def activate_stream(sem_map: torch.Tensor, prompts: List[str],
                    pos_embeds, neg_embeds,
                    gt_masks: Dict[str, np.ndarray], thresh: float = 0.4,
                    scale: int = 29,
                    chose_mask_strategy: str = "point",
                    adaptive_thresh: bool = False,
                    adaptive_alpha: Optional[float] = None,
                    low_thresh_filter: int = 0,
                    image: Optional[np.ndarray] = None,
                    image_name=None,
                    visualize_results: bool = False,
                    colormap_options=None):
    """Per-prompt relevancy -> smoothing -> threshold -> IoU per level, and
    the best level by the highest relevancy (`point`) or the mean relevancy
    inside the mask (`mean`).

    sem_map: [L, H, W, D] decoded CLIP-space features on the device that
    does the work. Returns (chosen IoUs, chosen levels, {prompt: (IoU,
    level, per-level scores, per-level thresholds)}, {prompt: chosen mask},
    {prompt: [chosen unsmoothed mask]}); the masks are bool tensors on
    sem_map's device.

    `adaptive_thresh` moves the cut to (mean relevancy - 1) * alpha + 1, the
    mean over the whole map or (low_thresh_filter > 0) over the
    majority-smoothed fixed-threshold mask, and, as in the reference (which
    mutates its `thresh` argument, eval/eval.py:226-239), the new value
    carries over to the next level and prompt; with `mean` the value carried
    over is the pre-adaptive one of the last level (eval/eval.py:271). An
    empty selection falls back to the whole-map mean, as in the JAX package.
    `visualize_results` writes the reference's per-prompt pictures under
    `image_name/` (eval/eval.py:178-224,300-307); `image` is the [H, W, 3]
    float RGB frame the composites need.
    """
    dev = sem_map.device
    if colormap_options is None:
        colormap_options = ColormapOptions(
            colormap="turbo", normalize=True,
            colormap_min=-1.0, colormap_max=1.0)
    pos = torch.as_tensor(pos_embeds, dtype=torch.float32, device=dev)
    neg = torch.as_tensor(neg_embeds, dtype=torch.float32, device=dev)
    valid_map = smooth_heatmaps(relevancy_maps(sem_map, pos, neg), scale)
    n_head, n_prompt = valid_map.shape[:2]
    vis = visualize_results and image_name is not None
    vis_map = valid_map.cpu().numpy() if vis else None

    thresh_val = thresh       # moved by adaptive mode, carried over
    ious, levels, scores, threshes = [], [], [], []
    mask_dict, mask_for_video_dict = {}, {}
    for k in range(n_prompt):
        gt = torch.as_tensor(np.asarray(gt_masks[prompts[k]]) != 0,
                             device=dev)
        iou_lvl, mask_lvl, mask_video, thresh_list, outs = [], [], [], [], []
        for i in range(n_head):
            rel = valid_map[i, k]
            if vis:
                _save_level_pictures(vis_map[i, k], prompts[k], i, image,
                                     gt_masks[prompts[k]], image_name,
                                     colormap_options)
            output = _normalized(rel)
            outs.append(output)
            thresh_list.append(thresh_val)
            if adaptive_thresh:
                if low_thresh_filter > 0:
                    area = majority_smooth(output > thresh_val)
                    n_sel = area.sum()
                    mean_ = torch.where(
                        n_sel > 0,
                        torch.where(area, rel, 0.0).sum()
                        / n_sel.clamp(min=1), rel.mean())
                else:
                    mean_ = rel.mean()
                alpha = float(adaptive_alpha)
                assert 0.0 < alpha < 1.0, alpha
                thresh_val = (mean_.double() - 1.0) * alpha + 1.0
            mask_pred = output > thresh_val
            mask_video.append(mask_pred)
            mask_pred = smooth_mask(mask_pred)
            mask_lvl.append(mask_pred)
            inter = (gt & mask_pred).sum()
            union = (gt | mask_pred).sum()
            iou_lvl.append(torch.where(union > 0, inter.double()
                                       / union.clamp(min=1).double(), 0.0))
        iou_lvl = torch.stack(iou_lvl)
        if chose_mask_strategy == "point":
            score_lvl = valid_map[:, k].amax(dim=(1, 2)).double()
        elif chose_mask_strategy == "mean":
            score = []
            for i in range(n_head):
                thresh_val = thresh_list[i]
                area = outs[i] > thresh_list[i]
                n_area = area.sum()
                score.append(torch.where(
                    n_area > 0, torch.where(area, valid_map[i, k], 0.0).sum()
                    / n_area.clamp(min=1), 0.0).double())
            score_lvl = torch.stack(score)
        else:
            raise NotImplementedError(chose_mask_strategy)
        chosen = score_lvl.argmax()
        ious.append(iou_lvl[chosen])
        levels.append(chosen)
        scores.append(score_lvl)
        threshes.append(torch.stack([torch.as_tensor(
            t, dtype=torch.float64, device=dev) for t in thresh_list]))
        stacked = torch.stack(mask_lvl)
        mask_dict[prompts[k]] = stacked[chosen]
        mask_for_video_dict[prompts[k]] = [torch.stack(mask_video)[chosen]]

    # the one transfer to the host
    host = torch.cat([torch.stack(ious), torch.stack(levels).double(),
                      torch.cat(scores), torch.cat(threshes)]).cpu().numpy()
    ious_h = host[:n_prompt]
    levels_h = host[n_prompt:2 * n_prompt].astype(np.int64)
    scores_h = host[2 * n_prompt:2 * n_prompt + n_prompt * n_head].reshape(
        n_prompt, n_head)
    thr_h = host[2 * n_prompt + n_prompt * n_head:].reshape(n_prompt, n_head)
    prompt_iou_lvl_dict = {}
    for k, p in enumerate(prompts):
        thr = [float(t) for t in thr_h[k]]
        if adaptive_thresh:
            logger.info(f"{p}: adaptive thresholds {thr}")
        prompt_iou_lvl_dict[p] = (float(ious_h[k]), int(levels_h[k]),
                                  scores_h[k], thr)
        if vis:
            vis_mask_save(mask_dict[p], Path(image_name) / f"chosen_{p}.png")
            vis_mask_save(mask_for_video_dict[p][0],
                          Path(image_name) / f"chosen_for_video_{p}.png")
    return ([float(x) for x in ious_h], [int(x) for x in levels_h],
            prompt_iou_lvl_dict, mask_dict, mask_for_video_dict)


def _save_level_pictures(rel: np.ndarray, prompt: str, level: int, image,
                         gt_mask: np.ndarray, image_name, colormap_options):
    """The reference's heatmap, composited cutout, dimmed background and
    GT-annotation overlay of one (prompt, level) (eval/eval.py:178-224)."""
    root = Path(image_name)
    colormap_saving(rel[..., None], colormap_options,
                    root / "heatmap" / f"{prompt}_{level}")
    if image is None:
        return
    # composited cutout: turbo(relevancy - 0.5) over the dimmed RGB
    p_i = np.clip(rel - 0.5, 0, 1)[..., None]
    compo = apply_colormap(p_i / (p_i.max() + 1e-6), ColormapOptions("turbo"))
    lowrel = rel < 0.5
    compo[lowrel] = image[lowrel] * 0.6
    colormap_saving(compo, colormap_options,
                    root / "composited" / f"{prompt}_{level}")
    if level == 0:
        colormap_saving(image * 0.6, colormap_options,
                        root / "background" / f"{prompt}_{level}")
        overlay = np.array([128 / 255, 0.0, 128 / 255]) * 0.5
        annot = image.copy()
        gt = np.asarray(gt_mask).astype(bool)
        # the reference adds overlay_layer * 255 (eval/eval.py:220),
        # saturating annotated pixels after the save-time clip
        annot[gt] = np.clip(annot[gt] * 0.5 + overlay * 255.0, 0.0, 1.0)
        colormap_saving(annot, colormap_options,
                        root / "annotation" / f"{prompt}_{level}")


# ---------------------------------------------------------------------------
# Time-sensitive query metrics (eval/eval.py:317-327,355-402)
# ---------------------------------------------------------------------------

def cal_avg_video_feature(decode_fn, mask, video_features_dim,
                          query_embedding) -> float:
    """Mean cosine similarity between the decoded video features under the
    mask and the query embedding. `decode_fn` maps [n, d] to [n, D] on the
    mask's device."""
    mask = torch.as_tensor(mask)
    dev = mask.device
    feats = torch.as_tensor(video_features_dim, dtype=torch.float32,
                            device=dev)
    chosen = feats[mask.to(torch.int64) == 1]
    if len(chosen) == 0:
        return 0.0
    decoded = decode_fn(chosen)
    q = torch.as_tensor(query_embedding, dtype=torch.float32,
                        device=dev).reshape(-1)
    q = q / (torch.linalg.norm(q) + 1e-12)
    d = decoded / (torch.linalg.norm(decoded, dim=-1, keepdim=True) + 1e-12)
    return float(torch.mean(d @ q))


def _idx_in_intervals(idx: int, intervals) -> bool:
    return any(lo <= idx <= hi for lo, hi in intervals)


def evaluate_video_feature(similarity_list, ground_truth_list, threshold):
    """Accuracy/precision/recall/vIoU over frame intervals
    (eval/eval.py:355-402). similarity_list: [(idx, sim, iou), ...]."""
    label_list = [_idx_in_intervals(fm[0], ground_truth_list)
                  for fm in similarity_list]
    predict_list = [fm[1] >= threshold for fm in similarity_list]
    tp = sum(1 for p, l in zip(predict_list, label_list) if p and l)
    fp = sum(1 for p, l in zip(predict_list, label_list) if p and not l)
    fn = sum(1 for p, l in zip(predict_list, label_list) if not p and l)
    accuracy = sum(1 for p, l in zip(predict_list, label_list)
                   if p == l) / len(predict_list)
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0
    iou_values = []
    for (pred, fm), lbl in zip(zip(predict_list, similarity_list),
                               label_list):
        if lbl or pred:
            iou_values.append(fm[2] if (lbl and pred) else 0)
    avg_iou = sum(iou_values) / len(iou_values) if iou_values else 0
    return {"accuracy": accuracy, "precision": precision, "recall": recall,
            "average_iou": avg_iou, "label_list": label_list,
            "predict_list": predict_list}


def save_similarity_plot(similarity_list, save_path: str,
                         thresh_hold: float = 0.0) -> None:
    """Per-frame similarity curve with the decision threshold
    (drawn_similarity_images, eval/eval.py:329-343). Needs matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    indices = [x[0] for x in similarity_list]
    values = [x[1] for x in similarity_list]
    plt.figure(figsize=(10, 6))
    plt.plot(indices, values, marker="o", linestyle="-", color="b",
             label="Similarity")
    plt.axhline(y=thresh_hold, color="r", linestyle="--",
                label=f"Threshold: {thresh_hold}")
    plt.title("Similarity across Different Indices")
    plt.xlabel("Index")
    plt.ylabel("Cosine Similarity")
    plt.legend()
    plt.grid(True)
    plt.savefig(save_path)
    plt.close()


def plot_confusion_matrix(y_true, y_pred, labels=None, title: str = "default",
                          output_path: str = ".") -> None:
    """2x2 in-interval confusion matrix PNG (eval/eval.py:345-352). Needs
    matplotlib."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    labels = list(labels) if labels is not None else sorted(set(y_true))
    n = len(labels)
    cm = np.zeros((n, n), np.int64)
    lut = {l: i for i, l in enumerate(labels)}
    for t, p in zip(y_true, y_pred):
        cm[lut[t], lut[p]] += 1
    plt.figure(figsize=(6, 4))
    plt.imshow(cm, cmap="Blues")
    for r in range(n):
        for c in range(n):
            plt.text(c, r, str(cm[r, c]), ha="center", va="center",
                     color="black")
    plt.xticks(range(n), [str(l) for l in labels])
    plt.yticks(range(n), [str(l) for l in labels])
    plt.xlabel("Predicted")
    plt.ylabel("True")
    plt.title(f"{title} Confusion Matrix")
    plt.savefig(os.path.join(output_path, f"{title}_Confusion_matrix.png"))
    plt.close()


def smooth_similarity(sorted_sims, frames: int, coff: Sequence[float]):
    """Temporal smoothing of (idx, sim, iou) lists (eval/eval.py:721-758)."""
    assert frames * 2 + 1 == len(coff)
    out = []
    for i in range(len(sorted_sims)):
        acc = 0.0
        for j in range(-frames, frames + 1):
            if 0 <= i + j < len(sorted_sims):
                acc += sorted_sims[i + j][1] * coff[j + frames]
            else:
                acc = sorted_sims[i][1]
                break
        out.append(acc)
    return [(s[0], v, s[2]) for s, v in zip(sorted_sims, out)]
