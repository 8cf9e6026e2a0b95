"""Logging: timestamped stdout and a rotating file sink (port of
langsplat4d/utils/logging.py; the reference's loguru sink and `safe_state`,
train.py:35,604-606, utils/general_utils.py:118-139).

The port's modules log to `logging.getLogger(__name__)`, children of the
package logger that `get_logger` configures, so one stdout handler and one
file sink carry them all.
"""
from __future__ import annotations

import logging
import logging.handlers
import os
import random
import sys
from typing import Optional

import numpy as np
import torch

_LOGGER: Optional[logging.Logger] = None
FORMAT = "%(asctime)s | %(levelname)s | %(message)s"


def get_logger(name: str = "langsplat4d_torch") -> logging.Logger:
    """The package logger at INFO, with a stdout handler where neither it
    nor the root logger has one (as the eval and AE CLIs add theirs), so
    that a record is printed once."""
    global _LOGGER
    if _LOGGER is not None:
        return _LOGGER
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not logger.handlers and not logging.getLogger().handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(FORMAT, "%d/%m %H:%M:%S"))
        logger.addHandler(h)
    _LOGGER = logger
    return logger


def add_file_sink(log_dir: str, filename: str,
                  max_bytes: int = 500 * 1024 * 1024) -> str:
    """A file sink in `log_dir`, rotated at 500 MB (train.py:606); returns
    the file's path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, filename)
    h = logging.handlers.RotatingFileHandler(path, maxBytes=max_bytes,
                                             backupCount=3)
    h.setFormatter(logging.Formatter(FORMAT))
    get_logger().addHandler(h)
    return path


def safe_state(seed: int = 0) -> None:
    """Seed the host generators (utils/general_utils.py:136-139) and
    torch's, on the CPU and every CUDA device."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
