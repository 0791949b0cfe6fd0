"""Device idle a training step while the loop's ``feed`` span is open on
the host, ms: while it waits for the feeder's next item and uploads it.
From the profiler's trace (``portbench/spans.py::idle_by_span``,
``records["idle_by_span"]``), over the profiled steps."""


def read(rec):
    ibs = rec.get("idle_by_span") or {}
    if not ibs.get("busy_s") or not rec.get("steps"):
        return None
    return 1e3 * ibs["idle_s"].get("feed", 0.0) / rec["steps"]
