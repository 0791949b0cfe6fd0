"""The device's idle time split by the program's span open on the host.

The program times each request in spans (``cfun_tpu_torch/utils/
profiling.py``); with a span log attached to the detector every span is
also a ``record_function`` range, on the profiler's own clock.
``idle_by_span`` takes a finished ``torch.profiler.profile`` of such
requests, forms the device's busy intervals as ``harness.trace_reduction``
does (the union of the device's events, leaving out the spans' own marks
on the device's timeline), and puts each instant of the window at which
the device is idle down to the span open on the host then: the latest
begun of those open, or 'host' where none is.  A top-level stage's
children lie inside it, so naming only the top-level stages counts their
children with them.  It also counts the runtime's launch and copy calls
that begin inside each span.  Threads are not told apart: the served
loop runs its stages one after another on one thread.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Sequence, Tuple

# the CUDA runtime's and driver's calls that put work on a stream
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                   "cudaMemset", "cuMemset", "cudaGraphLaunch")


def _union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _owner(spans: Sequence[Tuple[float, float, str]], t: float) -> str:
    """The latest begun of ``spans`` open at ``t``, or 'host'."""
    best = None
    for a, b, name in spans:
        if a <= t < b and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best else "host"


def split_idle(device: Iterable[Tuple[float, float]],
               spans: Sequence[Tuple[float, float, str]],
               calls: Iterable[float], window: Tuple[float, float],
               names: Sequence[str]) -> dict:
    """The core of ``idle_by_span`` on plain intervals (microseconds):
    ``device`` busy intervals, host ``spans`` (start, end, name), the start
    of each launch or copy call, and the window.  Returns ``window_s``,
    ``busy_s`` (the union of ``device`` clipped to the window), ``idle_s``
    by span name and 'host' (summing to ``window_s - busy_s``) and
    ``launches`` by span name."""
    lo, hi = window
    busy = [[max(a, lo), min(b, hi)] for a, b in _union(device)
            if b > lo and a < hi]
    idle = []
    at = lo
    for a, b in busy:
        if a > at:
            idle.append((at, a))
        at = max(at, b)
    if hi > at:
        idle.append((at, hi))
    out = {name: 0.0 for name in names}
    out["host"] = 0.0
    for a, b in idle:
        # the owner can change only where a span begins or ends
        cuts = sorted({a, b} | {t for s0, s1, _ in spans
                                for t in (s0, s1) if a < t < b})
        for c0, c1 in zip(cuts, cuts[1:]):
            out[_owner(spans, c0)] += (c1 - c0) / 1e6
    launches = {name: 0 for name in names}
    starts = sorted(spans)
    keys = [s[0] for s in starts]
    for t in calls:
        # only spans begun by t can hold it
        owner = _owner(starts[:bisect.bisect_right(keys, t)], t)
        if owner != "host":
            launches[owner] += 1
    return {"window_s": (hi - lo) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "idle_s": out, "launches": launches}


def idle_by_span(prof, names: Sequence[str]) -> dict:
    """``split_idle`` of a finished profile: the device's events other than
    marks named in ``names``, the host ranges named in ``names``, the
    runtime's launch and copy calls, over the profile's extent (its first
    event's start to its last one's end)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    marks = set(names)
    device, spans, calls = [], [], []
    lo, hi = float("inf"), float("-inf")
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        lo, hi = min(lo, a), max(hi, b)
        if e.device_type == cuda:
            if e.name not in marks:
                device.append((a, b))
        elif e.name in marks:
            spans.append((a, b, e.name))
        elif e.name.startswith(LAUNCH_PREFIXES):
            calls.append(a)
    if not spans:
        return {}
    return split_idle(device, spans, calls, (lo, hi), names)


def per_request(spans, name: str) -> Dict[int, float]:
    """Seconds of the spans named ``name`` of a span log, summed by
    request id."""
    out: Dict[int, float] = {}
    for s in spans:
        if s.name == name:
            out[s.request] = out.get(s.request, 0.0) + s.seconds
    return out
