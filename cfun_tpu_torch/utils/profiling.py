"""Profiling & tracing utilities of the port (``cfun_tpu/utils/profiling.py``
on ``torch.profiler``).

``device_trace`` records host and device activity (CPU always, CUDA when
a card is there) and writes a Chrome / Perfetto trace into a directory,
viewable in TensorBoard's profiler plugin, Perfetto or
``chrome://tracing``.

``SpanRecorder.span`` times one stage of one request.  With no
``SpanLog`` attached it reads the clock twice and nothing more; with one
attached it also appends the closed span to the log and opens a
``torch.profiler.record_function`` range of the span's name, so that
under a profiler each span sits on the trace's own clock beside the
device work it enqueued.  A range that encloses a kernel launch or a copy
leaves a mark of its name on the device's timeline too; whoever reads
device time out of such a trace leaves those names out.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional

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


class Span:
    """One timed stage of one request: its name, the request's id, the
    thread it ran on, its start and end (``time.perf_counter_ns``), the
    name of the span open around it on that thread, and what it counted.
    ``thread`` and ``parent`` are filled in only while a log is
    attached."""

    __slots__ = ("name", "request", "thread", "start_ns", "end_ns",
                 "parent", "counts")

    def __init__(self, name: str, request, counts: Dict[str, int]):
        self.name = name
        self.request = request
        self.thread: Optional[str] = None
        self.parent: Optional[str] = None
        self.counts = counts
        self.start_ns = self.end_ns = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class SpanLog:
    """The closed spans of a recorder, in the order they closed, at most
    ``capacity`` of them (the oldest go first).  Held in memory only, in
    a ring allocated up front, so that appending takes nothing from the
    heap the requests' raw-size volumes come from.  The caller reads and
    clears it with ``take``."""

    def __init__(self, capacity: int = 1 << 16):
        self._ring: List[Optional[Span]] = [None] * capacity
        self._count = 0  # spans appended since the last take
        self._lock = threading.Lock()

    def append(self, span: Span) -> None:
        with self._lock:
            self._ring[self._count % len(self._ring)] = span
            self._count += 1

    def take(self) -> List[Span]:
        """The logged spans, oldest first; the log is left empty."""
        with self._lock:
            cap = len(self._ring)
            out = []
            for i in range(max(0, self._count - cap), self._count):
                out.append(self._ring[i % cap])
                self._ring[i % cap] = None
            self._count = 0
        return out


class SpanRecorder:
    """Times stages; ``log`` (None: off) is where closed spans go."""

    def __init__(self, log: Optional[SpanLog] = None):
        self.log = log
        self._open = threading.local()  # each thread's stack of open spans

    @contextlib.contextmanager
    def span(self, name: str, request, **counts) -> Iterator[Span]:
        """Time the block as stage ``name`` of ``request``; the yielded
        span's ``counts`` may be added to inside the block."""
        s = Span(name, request, counts)
        log = self.log
        if log is None:
            s.start_ns = time.perf_counter_ns()
            try:
                yield s
            finally:
                s.end_ns = time.perf_counter_ns()
            return
        stack = self._open.__dict__.setdefault("stack", [])
        s.thread = threading.current_thread().name
        s.parent = stack[-1].name if stack else None
        stack.append(s)
        # the clock reads enclose the range: the span holds its own cost
        s.start_ns = time.perf_counter_ns()
        try:
            with record_function(name):
                yield s
        finally:
            s.end_ns = time.perf_counter_ns()
            stack.pop()
            log.append(s)
