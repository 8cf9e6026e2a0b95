"""SAM mask non-maximum suppression on the device (port of
langsplat4d/preprocess/mask_nms.py; reference
preprocess/generate_clip_features.py:238-317, `mask_nms`, `filter`,
`masks_update`).

The pairwise intersections come from one [N, H*W] @ [H*W, N] product of the
0/1 masks in fp32 with TF32 off: every count is an integer below 2^24 (H*W
is under it up to Neu3D's 1352x1014), so fp32 holds it exactly in any
summation order, and the IoU and containment ratios and their thresholds
are the JAX package's to the bit (both compare a float32 array with a Python
float in float32). The reference's quirks are kept: the stable descending
sort, `tril(..., k=1)` (the superdiagonal included) for the lower inner
relation, and the top-3 fallback for the score and the two inner masks but
never for the IoU mask.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from langsplat4d_torch.core.device import fp32_matmul, resolve_device


def mask_nms(masks, scores, iou_thr: float = 0.7, score_thr: float = 0.1,
             inner_thr: float = 0.2, device=None) -> torch.Tensor:
    """Select mask indices that survive score/IoU/inner-overlap suppression.

    Args:
        masks: [N, H, W] bool (tensor or array) — candidate masks.
        scores: [N] float — per-mask quality (stability * predicted IoU),
            taken in float32.
        iou_thr: suppress a mask whose IoU with a higher-scored mask exceeds
            this.
        score_thr: drop masks scoring below this (unless none survive, in
            which case the top 3 are kept — the reference's fallback).
        inner_thr: suppress severe containment: a mask >= 85% inside a
            higher-scored one that covers < 50% of it (or the reverse).
        device: where to compute; None is the current CUDA device.

    Returns: int64 indices into the ORIGINAL mask order (descending score
    among the kept), on `device`.
    """
    dev = resolve_device(device)
    masks = torch.as_tensor(masks, device=dev).bool()
    scores = torch.as_tensor(scores, device=dev).to(torch.float32).reshape(-1)
    n = masks.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.int64, device=dev)

    order = torch.argsort(-scores, stable=True)
    s_ord = scores[order]
    flat = masks[order].reshape(n, -1).to(torch.float32)
    area = flat.sum(dim=1)                                 # [N]
    with fp32_matmul():
        inter = flat @ flat.T                              # [N, N]
    union = area[:, None] + area[None, :] - inter
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    iou = torch.where(union > 0, inter / union, zero)
    frac_i = torch.where(area[:, None] > 0, inter / area[:, None], zero)
    frac_j = frac_i.T                                      # inter / area[j]

    # the reference's "severe internal relationship": j >= 85% covered by
    # the pair's intersection while i < 50% covered -> inner score on (i, j)
    inner = torch.where((frac_i < 0.5) & (frac_j >= 0.85),
                        1.0 - frac_j * frac_i, zero)
    inner_lt = torch.where((frac_i >= 0.85) & (frac_j < 0.5),
                           1.0 - frac_j * frac_i, zero).T

    # the maxima's initial 0 is the zeroed triangle: entries are >= 0
    keep = torch.triu(iou, diagonal=1).amax(dim=0) <= iou_thr
    keep_conf = s_ord > score_thr
    keep_inner_u = (torch.triu(inner, diagonal=1).amax(dim=0)
                    <= 1.0 - inner_thr)
    keep_inner_l = (torch.tril(inner_lt, diagonal=1).amax(dim=0)
                    <= 1.0 - inner_thr)

    # the reference's fallback: an empty survivor set resurrects the top 3
    # (computed on the device, without a host sync)
    top3 = torch.zeros(n, dtype=torch.bool, device=dev)
    top3[torch.argsort(-s_ord, stable=True)[:3]] = True
    keep_conf, keep_inner_u, keep_inner_l = (
        k | (top3 & ~k.any()) for k in (keep_conf, keep_inner_u,
                                        keep_inner_l))

    keep &= keep_conf & keep_inner_u & keep_inner_l
    return order[keep]


def masks_update(*mask_levels: Sequence[dict], device=None, **nms_kw
                 ) -> Tuple[List[dict], ...]:
    """Filter each SAM automatic-mask-generator output level through
    `mask_nms` (reference masks_update semantics): score = stability_score
    * predicted_iou (in float64, as the reference's numpy product); returns
    the surviving mask dicts per level, in their order."""
    dev = resolve_device(device)
    out: Tuple[List[dict], ...] = ()
    for masks_lvl in mask_levels:
        if not masks_lvl:
            out += ([],)
            continue
        segs = [m["segmentation"] for m in masks_lvl]
        seg = (torch.stack([s.to(dev) for s in segs])
               if isinstance(segs[0], torch.Tensor)
               else torch.from_numpy(np.stack(segs)).to(dev))
        score = (np.asarray([m["stability_score"] for m in masks_lvl])
                 * np.asarray([m["predicted_iou"] for m in masks_lvl]))
        keep = set(mask_nms(seg, score, device=dev, **nms_kw).tolist())
        out += ([m for i, m in enumerate(masks_lvl) if i in keep],)
    return out
