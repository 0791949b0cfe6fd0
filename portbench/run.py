"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program (``cfun_tpu_torch``).  It prints progress and the
compared numbers on standard error, and as the last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; ``compared``, the
numbers that decided ``correct`` beside their limits, comes last.

It exits with code 2 and prints no result where CUDA is not there or has
fewer cards than the cell asks for, and with code 3 where JAX or the JAX
package has been imported.  Caches of the program's builds live in the
checkout (``cfun_tpu_torch/_build/``, and ``.portbench_cache/``).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# glibc's mallopt parameters
M_TRIM_THRESHOLD = -1
M_MMAP_MAX = -4


def _allocator() -> None:
    """Keep freed memory in the process's heap: no allocation is mapped
    on its own, and the heap is trimmed only past 2 GiB free.  By default
    glibc maps every large block apart and returns it on free, so each
    request's raw-size volumes (93-277 MB) come as fresh pages, whose
    first touch costs a trap into the kernel a page; in a sandboxed
    kernel that doubles the host's unmold and swings it between runs."""
    import ctypes

    libc = ctypes.CDLL(None)
    libc.mallopt(M_MMAP_MAX, 0)
    libc.mallopt(M_TRIM_THRESHOLD, 2 ** 31 - 1)


def _environment() -> None:
    _allocator()
    cache = os.path.join(ROOT, ".portbench_cache")
    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(cache, sub)
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[var] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(root, bench, cell, seed, seconds, trace, device, t0,
             config=None, traffic=None) -> dict:
    """One run of ``cell`` on ``device`` (a ``torch.device``); the
    configuration and traffic are found by name unless given."""
    from portbench import harness

    config = config or harness.config_file(cell["config"])
    traffic = traffic or harness.traffic_file(cell["traffic"])
    ctx = types.SimpleNamespace(
        root=root, bench=bench, cell=cell, config=config, traffic=traffic,
        seed=seed, seconds=seconds, trace=bool(trace), device=device, t0=t0,
        metrics=harness.metrics_of(bench, cell, bool(trace)))
    return harness.driver(traffic).run(ctx)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    from portbench import harness

    bench = harness.benchmark(ROOT)
    cell = harness.cell_of(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); CUDA available: {torch.cuda.is_available()}, "
              f"cards: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(ROOT, bench, cell, args.seed, args.seconds, args.trace,
                   torch.device("cuda", 0), T0)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"portbench: JAX or the JAX package was imported: {loaded}",
              file=sys.stderr)
        return 3
    print(json.dumps({"info": out["info"], "setup_s": out["setup_s"],
                      "readings": out["readings"]}), file=sys.stderr)
    line = harness.result_line(out["correct"], out["attempted"],
                               out["failed"], out["metrics"], out["device"],
                               out["compared"], out["breakdown"])
    for row in out["compared"]:
        print(f"compared {row['name']} {row['value']!r} limit "
              f"{row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
