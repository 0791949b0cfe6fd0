"""The detector's ``dispatch`` span a request, ms: the host's enqueue of
the graph and of its outputs' copy.  The mean over the traced requests
of their ``dispatch`` spans in the program's span log
(``Detector.spans.log``, ``records["spans"]``)."""

from portbench.spans import per_request


def read(rec):
    by = per_request(rec.get("spans") or [], "dispatch")
    if not by:
        return None
    return 1e3 * sum(by.values()) / len(by)
