"""Host fetch and unmold a request, ms: the mean of the detector's own
``unmold`` timing (``Detector.last_timings``: the wait for the output on
the host, the unpack and the paste) over the traced requests."""


def read(rec):
    t = rec.get("timings")
    if not t or "unmold" not in t[0]:
        return None
    return 1e3 * sum(x["unmold"] for x in t) / len(t)
