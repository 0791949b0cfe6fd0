"""Serving one scan at a time: ``Detector.detect`` on raw volumes.

Set-up builds the port's libraries, places the configuration's weights
on the device, makes the seed's pool of raw volumes (the configuration's
sizes, the seed's content and order) and warms the detector up with
``Detector.warmup()`` and ``warmup_requests`` requests.  The window then
sends the pool's volumes in the seed's order, one client in a closed
loop, for the run's seconds; a request runs from the raw volume handed
to ``detect`` until its label volume is on the host.

A traced run profiles ``trace_requests`` requests instead, with a span
(``torch.profiler.record_function``) around each of the detector's
stages (mold, dispatch, finish), and reads the per-layer metrics from
the profiler's trace, the detector's own timings and the reference.

``correct``: once the window has closed and the program is freed, one
request of every volume of the pool (the largest among them), drawn from
the seed over all of that volume's requests in the window (a reservoir
of one), and the window's last request are served again by the plain
reference (``reference/serve.py``) from the same raw volume and weights,
and compared (``compare.py``) against the configuration's limits.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List

import numpy as np

from portbench import compare, harness, volumes
from portbench.reference import flops
from portbench.reference import weights as ref_weights
from portbench.reference.model import RefConfig, set_plain_precision

# the detector's stages a traced run marks, by method: span name
STAGES = {"mold": "mold", "_dispatch": "dispatch", "_finish": "finish"}


def port_config(serve: dict, model: dict):
    """The port's configuration from its factory, held to every number of
    the configuration file's ``model`` block."""
    from cfun_tpu_torch import config as port

    overrides = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in serve.get("overrides", {}).items()}
    cfg = getattr(port, serve["factory"])(serve["stage"], **overrides)
    for key, want in model.items():
        got = getattr(cfg, key)
        got = list(got) if isinstance(got, tuple) else got
        if got != want:
            raise SystemExit(f"the port's {serve['factory']} gives {key} = "
                             f"{got!r}, the configuration file {want!r}")
    return cfg


def build(root, serve: dict, model: dict, seed: int, device):
    """The program's detector for a configuration file's ``serve`` and
    ``model`` blocks, on its weights (the checkpoint the file names, or
    the seed's): (port config, reference config, Detector, the seeded
    weights or None)."""
    from cfun_tpu_torch.inference.pipeline import Detector

    cfg = port_config(serve, model)
    refcfg = RefConfig(model)
    flat = None
    if serve["weights"] == "seed":
        flat = ref_weights.seeded_flat(refcfg, seed, device)
        params = _port_tree(flat, cfg)
    else:
        from cfun_tpu_torch import weights as port_weights

        params, _ = port_weights.load_npz(
            os.path.join(root, serve["weights"]), cfg)
    return cfg, refcfg, Detector(cfg, params, device=device), flat


def reference_params(root, serve: dict, flat, device):
    """The reference's own reading of the same weights."""
    if flat is not None:
        return ref_weights.nest(flat)
    return ref_weights.load_npz(os.path.join(root, serve["weights"]),
                                device)


def pool(serve: dict, seed: int, device):
    spec = serve["volumes"]
    return volumes.pool(spec["generator"], spec["hw"], spec["depths"],
                        seed, device)


def run(ctx) -> dict:
    import torch

    from cfun_tpu_torch.ops import sorted_nms as k1

    device = ctx.device
    serve = ctx.config["serve"]
    traffic = ctx.traffic
    marks = {"import": time.perf_counter() - ctx.t0}
    if device.type == "cuda":
        from cfun_tpu_torch import _build

        _build.library()
    marks["build"] = time.perf_counter() - ctx.t0
    cfg, refcfg, det, flat = build(ctx.root, serve, ctx.config["model"],
                                   ctx.seed, device)
    marks["weights"] = time.perf_counter() - ctx.t0
    vols = pool(serve, ctx.seed, device)
    n_pool = len(vols)
    order = volumes.order(n_pool, ctx.seed)
    marks["volumes"] = time.perf_counter() - ctx.t0
    det.warmup()
    for i in range(traffic["warmup_requests"]):
        det.detect(vols[order[i % n_pool]])
    _sync(device)
    setup_s = time.perf_counter() - ctx.t0

    # which request of each volume is compared: a reservoir of one drawn
    # from the seed, so every request of the window is as likely
    rng = np.random.default_rng((ctx.seed, 7))
    kept: Dict[int, tuple] = {}
    seen = [0] * n_pool
    last: list = []
    latencies: List[float] = []
    timings: List[dict] = []
    detections = 0
    k1.launches = 0
    k1.launch_shapes.clear()
    molded = _watch_unmold(det)

    def request(i):
        nonlocal detections
        v = order[i % n_pool]
        t = time.perf_counter()
        res = det.detect(vols[v])
        latencies.append(time.perf_counter() - t)
        timings.append(dict(det.last_timings))
        detections += int(len(res["rois"]) > 0)
        seen[v] += 1
        sample = (res, molded["last"])
        if rng.random() * seen[v] < 1.0:
            kept[v] = sample
        last[:] = [(v, sample)]

    reduction = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        for method, span in STAGES.items():
            setattr(det, method, _spanned(getattr(det, method), span,
                                          record_function))
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            t_start = time.perf_counter()
            for i in range(traffic["trace_requests"]):
                request(i)
            _sync(device)
            wall = time.perf_counter() - t_start
        reduction = harness.trace_reduction(prof, set(STAGES.values()))
        del prof
    else:
        t_start = time.perf_counter()
        i = 0
        while time.perf_counter() - t_start < ctx.seconds:
            request(i)
            i += 1
        wall = time.perf_counter() - t_start
    n = len(latencies)
    wire = dict(det.last_wire_bytes)
    launches = {"k1_launches": k1.launches,
                "k1_shapes": {f"{a}x{b}": c
                              for (a, b), c in k1.launch_shapes.items()}}
    device_desc = harness.device_info(device, ctx.cell["chips"])

    # the program's state is freed before the reference runs
    det.close()
    del det
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    set_plain_precision()
    ref_params = reference_params(ctx.root, serve, flat, device)
    judged = {v: [sample] for v, sample in kept.items()}
    v_last, last_sample = last[0]
    if last_sample is not kept[v_last]:
        judged[v_last].append(last_sample)
    readings, bounds = [], {}
    for v in sorted(judged):
        ref = compare.reference(ref_params, refcfg, vols[v], device)
        for res, outs in judged[v]:
            readings.append(compare.judge(ref_params, refcfg, vols[v], ref,
                                          outs, res, device))
        bounds[v] = sum(harness.nms_bound_s(*c) for c in ref[2].nms_calls)
        del ref
    numbers = compare.worst(readings)
    correct, compared = compare.verdict(numbers, serve["limits"])
    if max(vols[v].shape[2] for v in judged) != max(
            v.shape[2] for v in vols):
        correct = False  # the largest volume was not compared

    info = {"requests": n, "kept_detection_share": detections / max(n, 1),
            "wire_bytes": wire, **launches, "setup_marks_s": marks}
    if ctx.trace:
        served = [order[i % n_pool] for i in range(n)]
        records = {
            "timings": timings, "requests": n, "wall_s": wall,
            "busy_s": reduction["busy_s"],
            "kernel_s": reduction["kernel_s"],
            "k1_bound_s": (sum(bounds[v] for v in served)
                           if set(served) <= set(bounds) else None),
            "flops": flops.request_flops(refcfg) * n,
            "peak_flops": harness.PEAK_BF16_FLOPS,
        }
        metrics = {}
        for m in ctx.metrics:
            value = harness.metric_reader(m["name"])(records)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        device_desc.update(busy_s=reduction["busy_s"], window_s=wall)
        brk = harness.breakdown(reduction)
    else:
        lat_ms = [1e3 * t for t in latencies]
        values = {"setup_s": setup_s, "volumes_per_s": n / wall,
                  "latency_p95_ms": harness.quantile(lat_ms, 0.95),
                  "peak_mem_gib": device_desc["memory_peak_bytes"] / 2 ** 30}
        metrics = {m["name"]: (values[m["name"]], m["unit"])
                   for m in ctx.metrics}
        brk = None
        info["latency_ms_p50_p95"] = [harness.quantile(lat_ms, 0.5),
                                      harness.quantile(lat_ms, 0.95)]
        info["mold_ms_median"] = harness.quantile(
            [1e3 * t["mold"] for t in timings], 0.5)
    return {"correct": correct, "attempted": n, "failed": 0,
            "metrics": metrics, "device": device_desc, "compared": compared,
            "breakdown": brk, "info": info, "setup_s": setup_s,
            "readings": readings}


def _port_tree(flat, cfg):
    from cfun_tpu_torch import weights as port_weights

    return port_weights.checked_tree(
        {k: v.detach().clone() for k, v in flat.items()}, cfg)


def _watch_unmold(det) -> dict:
    """Keep the last molded outputs the detector's graph handed to its
    unmold (detections, kept, labels) in the returned dict, under
    'last'."""
    seen = {}
    unmold = det.unmold

    def watched(detections, kept, mask_data, orig_shape, window):
        seen["last"] = (detections, kept, mask_data)
        return unmold(detections, kept, mask_data, orig_shape, window)

    det.unmold = watched
    return seen


def _spanned(fn, name, record_function):
    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return call


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
