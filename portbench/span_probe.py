"""The detector's own spans on one cell of the benchmark.

    python3 portbench/span_probe.py --workload <cell> --seed <n> \
        --seconds <s> [--log-first 0|1]

from the root of a checkout, on a card.  It sets the cell up as
``drivers/serve.py`` does (the same weights, volume pool, order and
warm-up), then serves it in a closed loop for ``--seconds`` twice, with
the detector's span log off and on (no profiler; ``--log-first`` says
which comes first), and profiles the traffic's ``trace_requests``
requests twice, with the span log on and off.  It prints one JSON line:
of each window, volumes/s and the mean of ``last_timings`` and
``last_sub_timings`` (ms a request), and with the log on each span's mean;
of each traced block, the per-layer metrics that ``metrics/`` reads from
the span log and ``spans.idle_by_span`` (the records' ``spans`` and
``idle_by_span``) beside those of the benchmark's traced run, and the
idle time by span.  It judges nothing: ``portbench/run.py`` is the
benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

STAGES = ("mold", "dispatch", "wait", "finish", "unpack", "paste")
TOP = ("mold", "dispatch", "wait", "finish")
# the marks a traced run of the benchmark leaves out of device time
MARKS = {"mold", "dispatch", "finish"}
METRICS = ("dispatch_ms.serve", "wait_ms.serve", "launches.serve",
           "idle_dispatch_ms.serve", "idle_mold_ms.serve",
           "idle_finish_ms.serve", "mold_ms.serve", "unmold_ms.serve",
           "device_busy_ms.serve", "idle_share.serve")


def _means_ms(dicts):
    return {k: 1e3 * sum(d[k] for d in dicts) / len(dicts)
            for k in dicts[0]} if dicts else {}


def _stage_ms(spans):
    n = len({s.request for s in spans})
    return {name: 1e3 * sum(s.seconds for s in spans if s.name == name)
            / max(n, 1) for name in STAGES}


def _serve(det, vols, order, count, at):
    """Serve requests ``at``, ``at + 1``, ... of the seed's order, for
    ``count`` seconds (float) or requests (int): (last_timings,
    last_sub_timings of each, wall seconds)."""
    timings, subs = [], []
    t0 = time.perf_counter()
    i = at
    while (time.perf_counter() - t0 < count if isinstance(count, float)
           else i - at < count):
        det.detect(vols[order[i % len(order)]])
        timings.append(dict(det.last_timings))
        subs.append(dict(det.last_sub_timings))
        i += 1
    return timings, subs, time.perf_counter() - t0


def probe(root, cell, config, traffic, seed, seconds, device,
          log_first) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from cfun_tpu_torch.utils.profiling import SpanLog
    from portbench import harness, spans, volumes
    from portbench.drivers import serve

    if device.type == "cuda":
        from cfun_tpu_torch import _build

        _build.library()
    srv = config["serve"]
    _, _, det, _ = serve.build(root, srv, config["model"], seed, device)
    vols = serve.pool(srv, seed, device)
    order = volumes.order(len(vols), seed)
    det.warmup()
    at = traffic["warmup_requests"]
    _serve(det, vols, order, at, 0)
    serve._sync(device)

    out = {"workload": cell["name"], "seed": seed,
           "device": harness.device_info(device, cell["chips"])["kind"]}
    for log_on in ((True, False) if log_first else (False, True)):
        det.spans.log = SpanLog() if log_on else None
        timings, subs, wall = _serve(det, vols, order, float(seconds), at)
        at += len(timings)
        w = {"requests": len(timings), "volumes_per_s": len(timings) / wall,
             "timings_ms": _means_ms(timings),
             "sub_timings_ms": _means_ms(subs)}
        if log_on:
            w["spans_ms"] = _stage_ms(det.spans.log.take())
        out["log_on" if log_on else "log_off"] = w

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    n = traffic["trace_requests"]
    for log_on in (True, False):
        log = det.spans.log = SpanLog() if log_on else None
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            timings, _, _ = _serve(det, vols, order, n, at)
            serve._sync(device)
            wall = time.perf_counter() - t0
        ibs = spans.idle_by_span(prof, TOP) if log_on else {}
        red = harness.trace_reduction(prof, MARKS)
        del prof
        at += n
        logged = log.take() if log_on else []
        records = {"spans": logged, "idle_by_span": ibs, "requests": n,
                   "busy_s": red["busy_s"], "timings": timings,
                   "wall_s": wall}
        t = {m: harness.metric_reader(m)(records) for m in METRICS}
        if log_on:
            t["spans_ms"] = _stage_ms(logged)
            t["idle_ms"] = {k: 1e3 * v / n for k, v in ibs["idle_s"].items()}
            t["launches"] = {k: v / n for k, v in ibs["launches"].items()}
            # idle by span + busy is the profile's extent by construction;
            # that extent against the host's clock over the requests
            t["extent_s"], t["wall_s"] = ibs["window_s"], wall
        out["traced_log_on" if log_on else "traced_log_off"] = t
    det.spans.log = None
    det.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--log-first", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import harness
    from portbench.run import _environment

    _environment()
    import torch

    if not torch.cuda.is_available():
        print("span_probe: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.benchmark(ROOT)
    cell = harness.cell_of(bench, args.workload)
    out = probe(ROOT, cell, harness.config_file(cell["config"]),
                harness.traffic_file(cell["traffic"]), args.seed,
                args.seconds, torch.device("cuda", 0), bool(args.log_first))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
