"""Profiling and run telemetry.

Counterpart of the JAX package's `utils/tracing.py`:

* `profile_trace` wraps a region in `torch.profiler.profile` (host activity,
  and the card's when one is present) and writes its Chrome trace to
  ``<log_dir>/trace.json`` (`TRACE_FILE`), for chrome://tracing or
  Perfetto;
* `annotate` names a region, so that a trace attributes time to the
  framework's phases (sampling, forward, backward, metrics);
* `StepClock` accumulates wall time and converts window counts to the
  throughput unit of the benchmarks (audio-hours/sec).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

FRAMES_PER_SEC = 44100 / 1024.0
TRACE_FILE = "trace.json"
SETTLE_OPS = 8


def _settle_device() -> None:
    """A few trivial device ops and a sync at the head of a session, under
    their own annotation. With torch 2.11 (CUPTI 26) on an H100, a session
    that followed many others in one process lost its first three or four
    device activity records (kernels and copies alike, by count, not by
    time); these nine records take that loss, so the region's own work is
    recorded."""
    with torch.profiler.record_function("profile_trace settle"):
        x = torch.zeros(1, device="cuda")
        for _ in range(SETTLE_OPS):
            x.add_(1.0)
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed region into ``<log_dir>/trace.json``. A profiler
    that cannot start or stop is reported and the region runs all the same:
    profiling must never take down a training run."""
    prof = None
    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except Exception as e:  # platform dependent: reported, not fatal
        print(f"[tracing] profiler unavailable: {e!r}")
        prof = None
    try:
        if prof is not None and torch.cuda.is_available():
            _settle_device()
        yield
    finally:
        if prof is not None:
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()   # the region's device work lands in the trace
                prof.stop()
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
            except Exception as e:  # reported, not fatal
                print(f"[tracing] profiler failed to write its trace: {e!r}")


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named trace region: a `torch.profiler.record_function` range, and an
    NVTX range as well where a CUDA card is present."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


class StepClock:
    """Wall-clock + throughput accounting for training epochs."""

    def __init__(self, window_frames: int, frames_per_sec: float = FRAMES_PER_SEC):
        self.window_frames = window_frames
        self.frames_per_sec = frames_per_sec
        self.reset()

    def reset(self) -> None:
        self.windows = 0
        self.elapsed = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0
        self._t0 = None

    def add_windows(self, n: int) -> None:
        self.windows += n

    @property
    def audio_seconds(self) -> float:
        return self.windows * self.window_frames / self.frames_per_sec

    @property
    def audio_hours_per_sec(self) -> float:
        if self.elapsed == 0:
            return 0.0
        return self.audio_seconds / 3600.0 / self.elapsed

    def record(self) -> dict:
        return {
            "windows": self.windows,
            "elapsed_sec": round(self.elapsed, 4),
            "audio_hours_per_sec": round(self.audio_hours_per_sec, 4),
        }
