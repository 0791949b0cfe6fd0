#!/usr/bin/env python3
"""Compare builds of the sorted-NMS kernel (K1) on one CUDA card.

    python3 k1_compare.py [floor] NAME=path/to/sorted_nms.cu [NAME=path.cu ...]

Each source must export the C interface of
``cfun_tpu_torch/csrc/sorted_nms.cu`` (``cfun_sorted_nms`` with a workspace
pointer, ``cfun_sorted_nms_max_n``, and ``cfun_sorted_nms_workspace_bytes``
or, for the two-pass kernel of before, ``cfun_sorted_nms_scratch_words``).
Every source is built by its own ``nvcc`` call with ``_build.NVCC_FLAGS``
(all started together) into the git-ignored
``cfun_tpu_torch/_build/k1_compare/``.

For each build: exact ``idx``/``keep`` against ``sorted_nms_reference`` on
chip_smoke.py's ``nms_cases`` and on the two NMS inputs of one served
request (``weights/heart_synth.npz``, the dense 'beginning' graph); then,
at those two served inputs and at N = 4096, k = 4096, the device ms of one
call (median CUDA-graph replay), the kernel's own device time
(torch.profiler) and the wrapped ms (median of event-timed eager calls,
the workspace held once per shape as the port's wrapper holds it), taken
in turns: the builds in order, then in reverse, twice.  Builds that are
not exact everywhere are not timed, except ``floor`` (the argument alone):
a built-in kernel that only writes the outputs, the floor of each
timing.  Prints one JSON
line a measurement, a summary line per case and build, and the card's
name and power limit.

The two-pass kernel that the current design replaced is
``git show 11eec16:cfun_tpu_torch/csrc/sorted_nms.cu``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "cfun_tpu_torch", "_build", "k1_compare")

# one launch that writes the outputs as "nothing kept" and computes no NMS
FLOOR_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void floor_kernel(int k, int* idx, bool* keep) {
  for (int q = threadIdx.x; q < k; q += blockDim.x) {
    idx[q] = 0;
    keep[q] = false;
  }
}
extern "C" {
int cfun_sorted_nms_max_n() { return 4096; }
long long cfun_sorted_nms_workspace_bytes(int n) { return 0; }
int cfun_sorted_nms(const float* boxes, const uint8_t* valid, int n,
                    float thr, int k, void* workspace, int* idx, bool* keep,
                    void* stream) {
  floor_kernel<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(k, idx, keep);
  return cudaGetLastError();
}
}
"""


def build_all(named):
    from cfun_tpu_torch import _build

    nvcc = _build.find_nvcc()
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, src in named:
        out = os.path.join(OUT_DIR, f"lib{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", os.path.dirname(src), "-o",
               out, src]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            print(f"nvcc {name} failed:\n{err}", flush=True)
            continue
        for line in err.splitlines():
            if "registers" in line or "Compiling entry" in line or \
                    "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
        libs[name] = load(out)
    return libs


def load(path):
    lib = ctypes.CDLL(path)
    ptr = ctypes.c_void_p
    lib.cfun_sorted_nms.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_float,
                                    ctypes.c_int, ptr, ptr, ptr, ptr]
    lib.cfun_sorted_nms.restype = ctypes.c_int
    if hasattr(lib, "cfun_sorted_nms_workspace_bytes"):
        fn = lib.cfun_sorted_nms_workspace_bytes
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
        lib.ws_bytes = fn
    else:
        fn = lib.cfun_sorted_nms_scratch_words
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
        lib.ws_bytes = lambda n: 8 * fn(n)
    return lib


class Caller:
    """A minimal wrapper around one build: a zeroed workspace held per
    shape, the outputs allocated a call."""

    def __init__(self, lib):
        self.lib = lib
        self.ws = {}

    def __call__(self, boxes, valid, thr, k):
        import torch

        n = boxes.shape[0]
        ws = self.ws.get(n)
        if ws is None:
            ws = torch.zeros(max(self.lib.ws_bytes(n), 16), dtype=torch.uint8,
                             device=boxes.device)
            self.ws[n] = ws
        idx = torch.empty(k, dtype=torch.int32, device=boxes.device)
        keep = torch.empty(k, dtype=torch.bool, device=boxes.device)
        err = self.lib.cfun_sorted_nms(
            boxes.data_ptr(), valid.data_ptr(), n, thr, k, ws.data_ptr(),
            idx.data_ptr(), keep.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return idx, keep


def kernel_ms(fn, reps=20):
    """torch.profiler's device time of every kernel of one ``fn()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(chip_smoke._dev_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / (
                   reps * 1e3)


def served_inputs(dev):
    """The two NMS inputs of one served request (1000->64, 64->1)."""
    import chip_smoke
    from cfun_tpu_torch import config as port_config
    from cfun_tpu_torch import weights
    from cfun_tpu_torch.inference import Detector
    from cfun_tpu_torch.ops import sorted_nms as k1

    cfg = port_config.heart_inference_config("beginning",
                                             nms_backend="pallas")
    params, _ = weights.load_npz(
        os.path.join(ROOT, "weights", "heart_synth.npz"), cfg)
    det = Detector(cfg, params, device=dev)
    wire, window, _ = det.mold(chip_smoke.synth_heart(0))
    seen = []

    def plain(boxes, valid, thr, k):
        seen.append((f"served_{boxes.shape[0]}->{k}@{thr}", boxes.clone(),
                     valid.clone(), thr, k))
        return k1.sorted_nms_reference(boxes, valid, thr, k)

    det.infer(wire, window, nms=plain)
    for name, boxes, valid, thr, k in seen:
        idx, keep = k1.sorted_nms_reference(boxes, valid, thr, k)
        kept = idx[keep].tolist()
        print(f"{name}: {int(valid.sum())} of {boxes.shape[0]} valid, "
              f"kept {len(kept)} at {kept}", flush=True)
    return seen


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_compare: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from cfun_tpu_torch.ops import sorted_nms as k1

    named = []
    for arg in sys.argv[1:]:
        if arg == "floor":
            os.makedirs(OUT_DIR, exist_ok=True)
            arg = "floor=" + os.path.join(OUT_DIR, "floor.cu")
            with open(arg[6:], "w") as f:
                f.write(FLOOR_SOURCE)
        named.append(arg.split("=", 1))
    if not named or any(len(p) != 2 for p in named):
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card {card}", flush=True)
    dev = torch.device("cuda", 0)
    libs = build_all(named)
    callers = {name: Caller(lib) for name, lib in libs.items()}
    served = served_inputs(dev)
    wrong, times = {}, []

    cases = chip_smoke.nms_cases(dev) + served
    for name, call in callers.items():
        bad = []
        for cname, boxes, valid, thr, k in cases:
            try:
                idx, keep = call(boxes, valid, thr, k)
                torch.cuda.synchronize()
            except RuntimeError as e:
                bad.append(f"{cname}: {e}")
                break
            ridx, rkeep = k1.sorted_nms_reference(boxes, valid, thr, k)
            if not (torch.equal(idx, ridx) and torch.equal(keep, rkeep)):
                bad.append(cname)
        wrong[name] = bad
        print(json.dumps({"build": name, "cases": len(cases),
                          "wrong": bad[:10], "n_wrong": len(bad)}),
              flush=True)

    big = [c for c in cases if c[0] == "n4096_k4096_t0.7_allvalid"]
    order = [name for name in callers
             if name == "floor" or not wrong[name]]
    turns = order + order[::-1] + order + order[::-1]
    for cname, boxes, valid, thr, k in served + big:
        for name in turns:
            call = callers[name]

            def fn():
                return call(boxes, valid, thr, k)

            rec = {"case": cname, "build": name,
                   "device_ms": chip_smoke.graph_ms(fn),
                   "wrapped_ms": chip_smoke.cuda_ms(fn, 50),
                   "kernel_ms": kernel_ms(fn)}
            times.append(rec)
            print(json.dumps(rec), flush=True)
    med = {}
    for rec in times:
        med.setdefault((rec["case"], rec["build"]), []).append(rec)
    for (cname, name), recs in med.items():
        got = {key: sorted(round(r[key], 5) for r in recs)
               for key in ("device_ms", "kernel_ms", "wrapped_ms")}
        print(f"summary {cname} {name}: {got}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
