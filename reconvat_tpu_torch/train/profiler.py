"""Profiling and throughput counters (the port's counterpart of
`reconvat_tpu/train/profiler.py`).

* `trace(logdir)`: a `torch.profiler` trace (CPU and, on a card, CUDA
  activity) of the block, written as a Chrome trace into `logdir`.
* `StepTimer`: wall-clock step time and audio-seconds trained per second,
  exponentially smoothed.
* `nan_guard(tree, name)`: a host-side finite check over a dict of
  scalars, on when `RECONVAT_NAN_CHECKS` is set (the reference's NaN
  asserts, `model/UNet_onset.py:146-147`).
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}.json"))


class StepTimer:
    def __init__(self, audio_seconds_per_step: float = 0.0,
                 smoothing: float = 0.9):
        self.audio_seconds_per_step = audio_seconds_per_step
        self.smoothing = smoothing
        self._last = None
        self.step_time = None
        self.steps = 0

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.step_time = (dt if self.step_time is None else
                              self.smoothing * self.step_time
                              + (1 - self.smoothing) * dt)
        self._last = now
        self.steps += 1

    @property
    def steps_per_sec(self):
        return 1.0 / self.step_time if self.step_time else 0.0

    @property
    def audio_realtime_factor(self):
        """Audio-seconds trained per wall-clock second."""
        return self.audio_seconds_per_step * self.steps_per_sec

    def summary(self) -> str:
        if not self.step_time:
            return "step timer: warming up"
        s = (f"step {self.step_time * 1000:.1f} ms "
             f"({self.steps_per_sec:.2f} steps/s")
        if self.audio_seconds_per_step:
            s += f", {self.audio_realtime_factor:.0f}x realtime"
        return s + ")"


def nan_checks_enabled() -> bool:
    return bool(os.environ.get("RECONVAT_NAN_CHECKS"))


def nan_guard(tree, name: str = "loss"):
    """Raise FloatingPointError when a value of the dict is not finite."""
    for key, leaf in tree.items():
        arr = np.asarray(leaf)
        if not np.all(np.isfinite(arr)):
            raise FloatingPointError(
                f"{name}[{key}] is not finite "
                f"(min={np.nanmin(arr)}, max={np.nanmax(arr)}); if this is "
                f"VAT, tune down XI (reference guidance, "
                f"model/UNet_onset.py:146)")
