"""Host mold a request, ms: the mean of the detector's own ``mold``
timing (``Detector.last_timings``) over the traced requests."""


def read(rec):
    t = rec.get("timings")
    if not t or "mold" not in t[0]:
        return None
    return 1e3 * sum(x["mold"] for x in t) / len(t)
