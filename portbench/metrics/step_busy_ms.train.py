"""Device busy a training step, ms: the union of the profiler's device
intervals over the profiled steps, over their count."""


def read(rec):
    if not rec.get("busy_s") or not rec.get("steps"):
        return None
    return 1e3 * rec["busy_s"] / rec["steps"]
