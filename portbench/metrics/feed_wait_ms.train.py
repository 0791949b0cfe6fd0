"""The training loop's ``feed`` span a step, ms: its wait for the next
item of the feeder and that item's upload.  The sum of the ``feed`` spans
in the program's span log over the profiled steps (``records["spans"]``),
over their count."""


def read(rec):
    spans = [s for s in rec.get("spans") or [] if s.name == "feed"]
    if not spans or not rec.get("steps"):
        return None
    return 1e3 * sum(s.seconds for s in spans) / rec["steps"]
