"""The whole request's share of the card's peak, %: the reference's
dense FLOPs of a request (``reference/flops.py``) times the traced
requests, over their wall time, over the H100's dense bf16 peak."""


def read(rec):
    if not rec.get("flops") or not rec.get("wall_s"):
        return None
    return 100.0 * rec["flops"] / rec["wall_s"] / rec["peak_flops"]
