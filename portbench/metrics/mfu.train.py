"""The whole training step's share of the card's peak, %:
``mfu.serve``'s formula on a training run's records (those that count
``steps``), whose ``flops`` are the training reference's dense FLOPs of a
step, forward and backward (``reference/train_flops.py``), times the
profiled steps."""

from portbench import harness

_serve = harness.metric_reader("mfu.serve")


def read(rec):
    return _serve(rec) if rec.get("steps") else None
