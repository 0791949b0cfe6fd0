"""Device busy a request, ms: the union of the profiler's device
intervals over the traced requests, over their count."""


def read(rec):
    if not rec.get("busy_s") or not rec.get("requests"):
        return None
    return 1e3 * rec["busy_s"] / rec["requests"]
