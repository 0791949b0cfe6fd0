"""Two versions of the detector in one process, served in turns.

    python3 portbench/pipeline_ab.py <heart|lits> <seed> <rounds> \
        <seconds> <other pipeline.py>

from the root of a checkout, on a card: sets the configuration up as
``drivers/serve.py`` does, builds this checkout's ``Detector`` and the
one of another ``inference/pipeline.py`` (say a parent commit's,
unpacked by ``git archive``; it imports this checkout's other modules)
on the same weights, then serves ``rounds`` pairs of windows of
``seconds`` each, in turns (other first in even rounds), one closed-loop
client over the seed's volume pool.  Prints one JSON line: each window's
volumes/s and mean ``last_timings`` (ms).  A code change's host cost is
told apart from the host's swing between processes, which in one
process both versions share.  It judges nothing: ``portbench/run.py``
is the benchmark.
"""

import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv):
    fam, seed, rounds, secs, other = argv
    seed, rounds, secs = int(seed), int(rounds), float(secs)
    from portbench.run import _environment

    _environment()
    import torch

    from cfun_tpu_torch import _build
    from cfun_tpu_torch import weights as port_weights
    from portbench import harness, volumes
    from portbench.drivers import serve

    _build.library()
    config = harness.config_file(fam)
    srv = config["serve"]
    dev = torch.device("cuda", 0)
    cfg, _, this, _ = serve.build(ROOT, srv, config["model"], seed, dev)
    spec = importlib.util.spec_from_file_location("other_pipeline", other)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    params, _ = port_weights.load_npz(os.path.join(ROOT, srv["weights"]),
                                      cfg)
    dets = {"other": mod.Detector(cfg, params, device=dev), "this": this}
    vols = serve.pool(srv, seed, dev)
    order = volumes.order(len(vols), seed)
    for det in dets.values():
        det.warmup()
        for i in range(2):
            det.detect(vols[order[i]])
    torch.cuda.synchronize()
    out = {"family": fam, "seed": seed,
           "device": torch.cuda.get_device_name(dev), "other": [],
           "this": []}
    at = 0
    for r in range(rounds):
        for name in (("other", "this") if r % 2 == 0 else ("this", "other")):
            det, timings = dets[name], []
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < secs:
                det.detect(vols[order[at % len(vols)]])
                timings.append(dict(det.last_timings))
                at += 1
            wall = time.perf_counter() - t0
            out[name].append({"volumes_per_s": len(timings) / wall, **{
                k: 1e3 * sum(t[k] for t in timings) / len(timings)
                for k in timings[0]}})
    for det in dets.values():
        det.close()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
