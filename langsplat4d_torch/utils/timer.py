"""Pausable wall-clock timer (port of langsplat4d/utils/timer.py; reference
utils/timer.py:2-24): leaves evaluation and saving out of the training
time."""
from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.start_time = None
        self.elapsed = 0.0
        self.paused = False

    def start(self):
        if self.start_time is None:
            self.start_time = time.time()
        elif self.paused:
            self.start_time = time.time()
            self.paused = False

    def pause(self):
        if not self.paused and self.start_time is not None:
            self.elapsed += time.time() - self.start_time
            self.paused = True

    def get_elapsed_time(self) -> float:
        if self.paused or self.start_time is None:
            return self.elapsed
        return self.elapsed + (time.time() - self.start_time)
