"""The runtime's launch and copy calls a request that begin inside the
detector's ``dispatch`` span, from the profiler's trace
(``portbench/spans.py::idle_by_span``, ``records["idle_by_span"]``)."""


def read(rec):
    n = (rec.get("idle_by_span") or {}).get("launches", {}).get("dispatch")
    if not n or not rec.get("requests"):
        return None
    return n / rec["requests"]
