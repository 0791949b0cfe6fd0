"""Profiling & tracing utilities of the port (``cfun_tpu/utils/profiling.py``
on ``torch.profiler``).

``device_trace`` records host and device activity (CPU always, CUDA when
a card is there) and writes a Chrome / Perfetto trace into a directory,
viewable in TensorBoard's profiler plugin, Perfetto or
``chrome://tracing``.  ``annotate`` names a region in that trace.
``StepTimer`` is a plain wall-clock timer with a percentile summary.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a host + device trace into ``log_dir``
    (``<host>_<pid>.<time>.pt.trace.json``)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """Named region that shows up in the trace."""
    return record_function(name)


class StepTimer:
    """Accumulates wall-clock samples per phase; reports min/median/p90."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples.setdefault(name, []).append(
                time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            xs = sorted(xs)
            n = len(xs)
            out[name] = {
                "n": n,
                "min": xs[0],
                "median": xs[n // 2],
                "p90": xs[min(n - 1, int(0.9 * n))],
            }
        return out
