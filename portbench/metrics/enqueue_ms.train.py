"""The host's enqueue of a training step, ms: the mean ``step`` span
(the batch made ready, the step's draws, forward, backward and update
queued) over the profiled steps (``records["spans"]``)."""


def read(rec):
    spans = [s for s in rec.get("spans") or [] if s.name == "step"]
    if not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
