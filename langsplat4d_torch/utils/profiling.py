"""Tracing, profiling and numerical-debug hooks (port of
langsplat4d/utils/profiling.py; the reference's CUDA-event timing,
train.py:118-119, and `torch.autograd.set_detect_anomaly`, train.py:615).

- `trace(log_dir)`: a torch.profiler trace of the enclosed region (CPU and
  CUDA activities), written as a Chrome trace into `log_dir`;
- `annotate(name)`: a named range on the profiler's timeline;
- `enable_nan_debug()`: autograd's anomaly detection, which raises at the
  backward of the first operation that produced a NaN;
- `StepTimer`: wall time per step, the device synchronised first, with an
  EMA.

The JAX package's `checked` (a checkify wrapper) has no counterpart:
anomaly detection is PyTorch's form of it.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the enclosed region; the trace is written to
    `log_dir`/trace.json when it ends."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region on the profiler's timeline."""
    return torch.profiler.record_function(name)


def enable_nan_debug(enable: bool = True) -> None:
    """Raise at the first NaN-producing operation (--detect_anomaly)."""
    torch.autograd.set_detect_anomaly(enable)


class StepTimer:
    """Per-step wall time with an EMA; `stop` synchronises the device of
    `result` (a tensor) first, so the time covers the step's device work."""

    def __init__(self, ema: float = 0.9):
        self._ema_coef = ema
        self.ema_ms: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result: Optional[torch.Tensor] = None) -> float:
        if result is not None and result.device.type == "cuda":
            torch.cuda.synchronize(result.device)
        ms = (time.perf_counter() - self._t0) * 1000.0
        self.ema_ms = (ms if self.ema_ms is None
                       else self._ema_coef * self.ema_ms
                       + (1 - self._ema_coef) * ms)
        return ms
