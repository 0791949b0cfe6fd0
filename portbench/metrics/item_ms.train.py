"""A feeder item, ms: the mean ``item`` span (load, mold, labels and RPN
targets of one training volume, on a feeder worker's thread) of those
that closed while the profiled steps ran (``records["spans"]``)."""


def read(rec):
    spans = [s for s in rec.get("spans") or [] if s.name == "item"]
    if not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
