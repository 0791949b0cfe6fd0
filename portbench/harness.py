"""What every cell shares: finding its files by name, the device's
description, the profiler's reduction to busy time and a breakdown, the
statistics of a window, the guard against JAX, and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix;
``configs/<config>.json`` and ``traffic/<traffic>.json`` are found by
those names, the traffic's ``driver`` names the module of ``drivers/``
that runs it, and each per-layer metric is read by
``metrics/<metric name>.py`` (its ``read(records)``, which returns None
where the records hold nothing for it).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cfun_tpu")
# H100 SXM, NVIDIA's data sheet, dense: bf16 tensor cores, float32 outside
# them, HBM3 bandwidth (at the full 700 W power limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> dict:
    return read_json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic_file(name: str) -> dict:
    return read_json(os.path.join(HERE, "traffic", f"{name}.json"))


def driver(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: dict, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer ones traced."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def forbidden_loaded(names: Optional[Sequence[str]] = None) -> List[str]:
    """Modules of JAX or of the JAX package among ``names`` (default: the
    modules in ``sys.modules``), compared by whole top-level name."""
    names = list(sys.modules) if names is None else names
    return sorted({name for name in names
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def quantile(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile of ``values``, linear between order statistics
    (numpy's default)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


# ---- the profiler's trace ------------------------------------------------------

def _union(intervals):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def trace_reduction(prof, spans: Sequence[str]) -> dict:
    """From a finished ``torch.profiler.profile``: the union of the
    device's intervals (``busy_s``), device seconds by kernel name, and
    the idle gaps between busy intervals, each named by the innermost of
    ``spans`` (``record_function`` names) open on the host at the gap's
    middle ('host' where none is).  The spans' own marks on the device's
    timeline are not device work."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda and e.name not in spans:
            dev.append((a, b, e.name))
        elif e.name in spans:
            host.append((a, b, e.name))
    busy = _union([(a, b) for a, b, _ in dev])
    by_name: Dict[str, float] = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    gaps = []
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + start)
        open_ = [(a, n) for a, b, n in host if a <= mid <= b]
        name = max(open_)[1] if open_ else "host"
        gaps.append((name, (start - end) / 1e6))
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernel_s": by_name, "gaps": gaps}


def breakdown(reduction: dict) -> dict:
    ops = sorted(reduction["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(reduction["gaps"], key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


# ---- K1's least time -------------------------------------------------------------

IOU_OPS_PER_PAIR = 19  # 12 min/max/sub/clamp, 2 mul, 2 add/sub, +eps, div, >


def nms_bound_s(valid, idx, keep) -> float:
    """Least time for one sorted-NMS call on an H100, from what these
    inputs need: bytes moved once (boxes, valid in; idx, keep out) over the
    HBM rate, against operations over the float32 rate.  Greedy NMS visits
    boxes up to ``last`` (the k-th kept box when k is reached, else the
    end) and needs, for each kept box, its IoU with the valid boxes after
    it up to ``last``, plus one step a visited box.  (A copy of the
    repository's ``chip_smoke.py::nms_bound_ms``, in seconds.)"""
    import torch

    n, k = valid.shape[0], keep.shape[0]
    kept = int(keep.sum())
    pos = idx[:kept].long().cpu()
    last = int(pos[-1]) if kept == k else n - 1
    upto = torch.cumsum(valid.cpu().long(), 0)
    pairs = int((upto[last] - upto[pos]).sum()) if kept else 0
    nbytes = n * 6 * 4 + n + k * 4 + k
    ops = pairs * IOU_OPS_PER_PAIR + last + 1
    return max(nbytes / PEAK_HBM_BYTES, ops / PEAK_F32_FLOPS)


# ---- the result ------------------------------------------------------------------

def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Tuple[float, str]], device: dict,
                compared: List[dict], breakdown_: Optional[dict] = None
                ) -> dict:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": float(v), "unit": u}
                       for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown_ is not None:
        out["breakdown"] = breakdown_
    out["compared"] = compared
    return out
