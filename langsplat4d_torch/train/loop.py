"""What the training loop decides between steps (port of
langsplat4d/train/loop.py; so far only the switch to the stream layout).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

from langsplat4d_torch.render.pipeline import binning_report
from langsplat4d_torch.render.raster import RasterSettings
from langsplat4d_torch.train.trainstate import TrainState

logger = logging.getLogger(__name__)

#: above this share of full tile lists the loop trains on the stream layout
FULL_LIST_LIMIT = 0.05


def maybe_stream_switch(settings: RasterSettings, state: TrainState,
                        train_cams: Sequence, iteration: int = 0
                        ) -> Optional[RasterSettings]:
    """Probe the tile lists' truncation on the first training camera and
    decide the switch to the stream layout: returns `settings` with
    `stream_train` on when more than 5% of the tile lists are full (the
    only case in which a list may have dropped Gaussians), else None. The
    CUDA reference's duplicate-and-sort buffers never truncate, so neither
    may training here. `train_cams[0].camera_params(device)` gives the
    probe's camera.

    The JAX package's `maybe_stream_switch` also sizes span tiers and a slot
    budget and returns an audit that re-sizes them after densification; the
    port's stream has no static shape, so there is nothing to size."""
    stats = binning_report(settings,
                           train_cams[0].camera_params(state.device),
                           state.gaussians())
    if stats["tile_full_frac"] <= FULL_LIST_LIMIT:
        return None
    logger.warning(
        "[ITER %d] tile lists saturated (full frac %.1f%%, longest list %d "
        "of capacity %d): switching to the stream-layout training composite",
        iteration, 100.0 * stats["tile_full_frac"],
        int(stats["tile_max_count"]), settings.tile_capacity)
    return dataclasses.replace(settings, stream_train=True)
