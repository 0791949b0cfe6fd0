"""The device's idle share of the profiled training steps' wall time, %:
``idle_share.serve``'s formula on a training run's records (those that
count ``steps``)."""

from portbench import harness

_serve = harness.metric_reader("idle_share.serve")


def read(rec):
    return _serve(rec) if rec.get("steps") else None
