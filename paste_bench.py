"""Time the heart fast path's native box paste alone, on the host.

    python3 paste_bench.py [--allocator heap|default] [--reps N] [ROOT]

Imports ``cfun_tpu_torch.native`` from ``ROOT`` (default: this file's
directory), so one script times two checkouts in turn, one process each.
At each depth of the heart benchmark's volume pool (512 x 512 x D, D =
177-363) it pastes a 192^3 int8 label crop into the synthetic heart's
box (the largest of its nested ellipsoids, ``portbench/volumes.py``:
radius H/4 in-plane around the centre, D/4 through the slices), allocating
each volume as ``Detector.detect`` does, and prints one JSON line a depth:
the median and least ms of ``--reps`` calls, the raw volume's bytes over
the median time in GB/s, and the median ms of a read of one voxel a page
after it (what a consumer such as the CLIs' NIfTI save first pays for
pages the paste left untouched).

``--allocator heap`` (the default) keeps freed memory in the process's
heap, as ``portbench/run.py`` sets glibc up; ``default`` leaves glibc's
own setting (the CLIs, ``chip_smoke.py``), where each volume is mapped
apart and comes as fresh pages.
"""

import argparse
import ctypes
import json
import os
import statistics
import sys
import time

import numpy as np

DEPTHS = (177, 214, 251, 288, 326, 363)
HW = 512
CROP = 192
PAGE_VOXELS = 4096 // 2  # int16 voxels in a 4 KiB page


def heap_allocator() -> None:
    """``portbench/run.py``'s setting: no block mapped on its own
    (M_MMAP_MAX 0), the heap trimmed only past 2 GiB free."""
    libc = ctypes.CDLL(None)
    libc.mallopt(-4, 0)
    libc.mallopt(-1, 2 ** 31 - 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?",
                    default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--allocator", choices=("heap", "default"),
                    default="heap")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if args.allocator == "heap":
        heap_allocator()
    sys.path.insert(0, os.path.abspath(args.root))
    from cfun_tpu_torch import native

    native.library()
    crop = np.random.default_rng(0).integers(0, 8, size=(CROP,) * 3,
                                             dtype=np.int8)
    for d in DEPTHS:
        shape = (d, HW, HW)
        box = (d // 4, HW // 4, HW // 4, 3 * d // 4, 3 * HW // 4,
               3 * HW // 4)
        native.unmold_labels_box(crop, box, shape)  # warm the pages
        times, reads = [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = native.unmold_labels_box(crop, box, shape)
            t1 = time.perf_counter()
            int(out.reshape(-1)[::PAGE_VOXELS].sum())
            reads.append(time.perf_counter() - t1)
            times.append(t1 - t0)
            del out
        med = statistics.median(times)
        print(json.dumps({
            "root": os.path.abspath(args.root), "allocator": args.allocator,
            "threads": native.num_threads(), "shape": list(shape),
            "box": list(box), "ms_median": med * 1e3,
            "ms_min": min(times) * 1e3,
            "gb_per_s": d * HW * HW * 2 / med * 1e-9,
            "page_read_ms_median": statistics.median(reads) * 1e3}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
