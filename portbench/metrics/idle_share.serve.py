"""The device's idle share of the traced requests' wall time, %:
100 * (1 - busy / wall), busy the union of the profiler's device
intervals."""


def read(rec):
    if not rec.get("busy_s") or not rec.get("wall_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["wall_s"])
