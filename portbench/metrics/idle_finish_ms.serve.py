"""Device idle a request while the detector's ``finish`` span is open on
the host, ms: while the host unpacks and pastes the outputs (``unpack``
and ``paste`` in it).  From the profiler's trace
(``portbench/spans.py::idle_by_span``, ``records["idle_by_span"]``),
over the traced requests."""


def read(rec):
    ibs = rec.get("idle_by_span") or {}
    if not ibs.get("busy_s") or not rec.get("requests"):
        return None
    return 1e3 * ibs["idle_s"]["finish"] / rec["requests"]
