"""Readings that set the limits of ``correct`` for the train cell.

    python3 portbench/control_train.py --workload heart-train.train \
        --seeds 1 2 ... --seconds 10 [--faults k1_iou_05 clip_skipped ...]

For each seed: one run of the cell (``drivers/train.py::run``) with a
window of ``--seconds``, its judged steps judged by the float32 reference
(the program's reading, the lower one) and by the reference in the
control's precision (every convolution and matrix product of its
forward from float8 e4m3 copies of its operands, one step below the
configuration's bfloat16), then one run with each fault of
``faults_train.py`` named planted (the upper readings; a fault under
which the run cannot go on reads as its error).  ``--judge-steps``
judges more steps of each run.  It prints one JSON line a run and
exits 2 without CUDA.  The benchmark's own runs never
run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reading(root, bench, cell, config, traffic, seed, seconds, device,
            fault=None, judge_steps=0):
    """{"program" or the fault: worst numbers, "control": worst numbers
    (the sound run only), "info": ...} of one run."""
    from portbench import harness
    from portbench.drivers import train
    from portbench.faults_train import planted

    ctx = types.SimpleNamespace(
        root=root, bench=bench, cell=cell, config=config, traffic=traffic,
        seed=seed, seconds=seconds, trace=False, device=device,
        t0=time.perf_counter(), metrics=harness.metrics_of(bench, cell,
                                                           False),
        controls=() if fault else ("fp8",), judge_steps=judge_steps)
    try:
        with planted(fault) if fault else contextlib.nullcontext():
            out = train.run(ctx)
    except RuntimeError as e:  # a fault the run could not go on with
        return {fault or "program": {"error": repr(e)}, "correct": False}
    numbers = {r["name"]: r["value"] for r in out["compared"]}
    got = {fault or "program": numbers, "correct": out["correct"],
           "info": out["info"], "readings": out["readings"]}
    if not fault:
        got["control"] = out["controls"]["fp8"]
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="heart-train.train")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--faults", nargs="*", default=())
    ap.add_argument("--judge-steps", type=int, default=0,
                    help="judge this many more steps of each run, "
                    "every third from the window's first")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control_train: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.benchmark(ROOT)
    cell = harness.cell_of(bench, args.workload)
    config = harness.config_file(cell["config"])
    traffic = harness.traffic_file(cell["traffic"])
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    for seed in args.seeds:
        for fault in (None,) + tuple(args.faults):
            got = reading(ROOT, bench, cell, config, traffic, seed,
                          args.seconds, device, fault,
                          args.judge_steps)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": fault,
                              "s": time.perf_counter() - t0, **got}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
