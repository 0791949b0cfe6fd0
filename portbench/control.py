"""Readings that set the limits of ``correct`` for a serving cell.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... \
        [--faults k1_second_best drop_partial ...]

For each seed: the cell's pool of raw volumes, each served once by the
program (``Detector.detect``, the timed path), once by the program with
each fault of ``faults.py`` named planted, and once by the plain
reference in the control's precision (every convolution and matrix
product from float8 e4m3 copies of its operands, one step below the
configuration's bfloat16), all judged against the float32 reference.
It prints one JSON line a seed with the worst of each compared number
over the pool: the program's (the lower reading), the control's and each
fault's (the upper ones); and exits 2 without CUDA.  The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root, config, seeds, device, fault_names=()):
    """{seed: {"program": worst numbers, "control": worst numbers,
    <fault>: worst numbers, "per_volume": [...]}} for the configuration's
    serving path."""
    import torch

    from portbench import compare
    from portbench.drivers.serve import (_watch_unmold, build, pool,
                                         reference_params)
    from portbench.faults import planted
    from portbench.reference.model import set_plain_precision
    from portbench.reference.serve import unmold

    spec = config["serve"]
    defaults = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    out = {}
    for seed in seeds:
        # the program runs under the process's defaults, as in a run
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = defaults
        _, refcfg, det, flat = build(root, spec, config["model"], seed,
                                     device)
        vols = pool(spec, seed, device)
        det.warmup()
        molded = _watch_unmold(det)
        served = {}
        for name in ("program",) + tuple(fault_names):
            got = []
            for v in vols:
                if name == "program":
                    res = det.detect(v)
                else:
                    with planted(name):
                        res = det.detect(v)
                got.append((res, molded["last"]))
            served[name] = got
        det.close()
        del det
        gc.collect()
        set_plain_precision()
        ref_params = reference_params(root, spec, flat, device)
        per_volume = []
        for i, v in enumerate(vols):
            ref = compare.reference(ref_params, refcfg, v, device)
            low = compare.reference(ref_params, refcfg, v, device, "fp8")[2]
            low_outs = (low.detections.cpu().numpy(),
                        low.kept.cpu().numpy(), low.labels.cpu().numpy())
            low_res = unmold(refcfg, *low_outs[:2], low.labels, v.shape,
                             ref[1])
            low_res["mask"] = low_res["mask"].cpu().numpy()
            del low
            row = {"depth": int(v.shape[2]),
                   "detections": {"reference": int(ref[2].kept.sum()),
                                  "control": int(low_outs[1].sum())}}
            row["control"] = compare.judge(ref_params, refcfg, v, ref,
                                           low_outs, low_res, device)
            for name, got in served.items():
                res, outs = got[i]
                row["detections"][name] = int(outs[1].sum())
                row[name] = compare.judge(ref_params, refcfg, v, ref, outs,
                                          res, device)
            per_volume.append(row)
            del ref
        out[seed] = {name: compare.worst(p[name] for p in per_volume)
                     for name in ("control",) + tuple(served)}
        out[seed]["per_volume"] = per_volume
        del vols, served
        gc.collect()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=())
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.cell_of(harness.benchmark(ROOT), args.workload)
    config = harness.config_file(cell["config"])
    t0 = time.perf_counter()
    for seed in args.seeds:
        r = readings(ROOT, config, [seed], torch.device("cuda", 0),
                     args.faults)[seed]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "s": time.perf_counter() - t0, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
