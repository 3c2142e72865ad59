"""Tracing and throughput hooks (the port's copy of the JAX package's
``utils/profiling.py``).

* ``trace(label)``: with ``EVSR_PROFILE_DIR`` set, profiles the enclosed
  region with ``torch.profiler`` (CPU activity, plus CUDA when the card is
  there) and writes a Chrome trace under ``EVSR_PROFILE_DIR/<label>/``;
  without it, does nothing.  The trainers wrap each train and valid epoch
  (``train_epoch_<N>``, ``valid_epoch_<N>``).
* ``Throughput``: windowed steps/s and frames/s counters.
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path


@contextlib.contextmanager
def trace(label: str):
    """Profile the enclosed region when ``EVSR_PROFILE_DIR`` is set."""
    profile_dir = os.environ.get("EVSR_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(profile_dir) / label
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace.{os.getpid()}.json"))


class Throughput:
    """Windowed steps/s and frames/s counters."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.steps = 0
        self.frames = 0

    def update(self, steps: int = 1, frames: int = 0):
        self.steps += steps
        self.frames += frames

    @property
    def elapsed(self) -> float:
        return max(time.perf_counter() - self._t0, 1e-9)

    def stats(self) -> dict:
        return {
            "steps_per_sec": self.steps / self.elapsed,
            "frames_per_sec": self.frames / self.elapsed,
            "steps": self.steps,
            "frames": self.frames,
            "seconds": self.elapsed,
        }
