"""Scalar, histogram and image telemetry (port of
langsplat4d/utils/telemetry.py; the reference's SummaryWriter and wandb
logging, train.py:479-537,599-600). Both sinks are optional: TensorBoard
through torch.utils.tensorboard where it imports, wandb only when the
`wandb` environment knob is 't' and the package imports.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class Telemetry:
    def __init__(self, log_dir: Optional[str] = None,
                 wandb_project: str = "4DLangSplat",
                 wandb_name: str = ""):
        self.tb = None
        self.wandb = None
        if log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(log_dir)
            except Exception:
                pass
        if os.getenv("wandb", "f") == "t":
            try:
                import wandb
                wandb.init(project=wandb_project, name=wandb_name or None)
                self.wandb = wandb
            except Exception:
                pass

    def scalars(self, values: Dict[str, float], step: int) -> None:
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(k, float(v), step)
        if self.wandb is not None:
            self.wandb.log({k: float(v) for k, v in values.items()},
                           step=step)

    def histogram(self, name: str, values, step: int) -> None:
        if self.tb is not None:
            self.tb.add_histogram(name, np.asarray(values), step)

    def image(self, name: str, img_chw, step: int) -> None:
        if self.tb is not None:
            self.tb.add_image(name, np.asarray(img_chw), step)

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
