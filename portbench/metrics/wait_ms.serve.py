"""The detector's ``wait`` span a request, ms: the host blocked on the
outputs' event, the device graph's time past its enqueue.  The mean
over the traced requests of their ``wait`` spans in the program's span
log (``Detector.spans.log``, ``records["spans"]``)."""

from portbench.spans import per_request


def read(rec):
    by = per_request(rec.get("spans") or [], "wait")
    if not by:
        return None
    return 1e3 * sum(by.values()) / len(by)
