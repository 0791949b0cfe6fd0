#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cfun_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as ``phase <name> start`` / ``phase <name> done <s>``:

  env     torch / CUDA versions and the card (nvidia-smi name, power limit)
  build   nvcc-builds the port's CUDA kernels from cfun_tpu_torch/csrc
  k1      holds the sorted-NMS kernel against its plain PyTorch version on
          edge cases (exact idx / keep) and times it at the served shapes
  serve   whole-heart inference at full width (192x320x320, stage
          'beginning', heart_inference_config with nms_backend='pallas'):
          weights/heart_synth.npz, three requests through Detector.detect
          with the kernel launch counts reset before and read after; then
          the served graph with the plain NMS passed in must give the same
          detections, and the kernel is held against its plain version on
          the NMS inputs the served graph produced
  profile where a served request's device time goes (torch.profiler)
          and K1's device time without the host's launch cost (CUDA-graph
          replay)
  small   the port on the card against the port on the CPU (plain
          versions, float32, TF32 off) on the tiny config

Then one JSON line with the kernels, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises and the exit
code is non-zero; without a CUDA device the script exits 2 before any
phase.  A watchdog ends a hung run after 600 s with a traceback.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WATCHDOG_S = 600
H100_F32_OPS_PER_S = 67e12   # H100 SXM data sheet, f32 outside tensor cores
H100_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
IOU_OPS_PER_PAIR = 19        # 12 min/max/sub/clamp, 2 mul, 2 add/sub, +eps, div, >

_T0 = time.perf_counter()


@contextlib.contextmanager
def phase(name):
    print(f"phase {name} start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"phase {name} done {time.perf_counter() - t0:.3f}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"check failed: {what}")


def cuda_ms(fn, reps, warmup=3):
    """Median milliseconds of one call of ``fn()``: CUDA events around each
    of ``reps`` calls, after ``warmup`` calls.  Where a call's device work
    is shorter than the host's launch cost, this is the launch cost."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[len(times) // 2]


def nms_bound_ms(valid, idx, keep):
    """Least time for one sorted-NMS call on an H100, from what these
    inputs need: bytes moved once (boxes, valid in; idx, keep out) over
    the HBM rate, against operations over the f32 rate.  Greedy NMS visits
    boxes up to ``last`` (the k-th kept box when k is reached, else the
    end) and needs, for each kept box, its IoU with the valid boxes after
    it up to ``last``; plus one step per visited box.  ``idx``/``keep`` are
    the call's outputs.  Returns (ms, 'bytes' | 'operations', pairs)."""
    import torch

    n, k = valid.shape[0], keep.shape[0]
    kept = int(keep.sum())
    pos = idx[:kept].long().cpu()
    last = int(pos[-1]) if kept == k else n - 1
    upto = torch.cumsum(valid.cpu().long(), 0)  # valid boxes in [0, j]
    pairs = int((upto[last] - upto[pos]).sum()) if kept else 0
    nbytes = n * 6 * 4 + n + k * 4 + k
    ops = pairs * IOU_OPS_PER_PAIR + last + 1
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / H100_F32_OPS_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations", pairs
    return t_bytes * 1e3, "bytes", pairs


def synth_heart(seed, shape=(256, 256, 128)):
    """A raw [H, W, D] volume with nested ellipsoidal 'organs' over N(0, 1)
    noise: the kind of volume heart_synth.npz was trained on."""
    import numpy as np

    h, w, d = shape
    rng = np.random.default_rng(seed)
    labels = np.zeros((h, w, d), np.int8)
    cy, cx, cz = (rng.integers(h // 3, 2 * h // 3),
                  rng.integers(w // 3, 2 * w // 3), d // 2)
    yy, xx, zz = np.ogrid[:h, :w, :d]
    for cls in range(1, 8):
        frac = 1.0 - (cls - 1) / 7 * 0.8
        r, rz = max(2.0, (h // 4) * frac), max(1.0, (d // 4) * frac)
        ball = (((yy - cy) / r) ** 2 + ((xx - cx) / r) ** 2 +
                ((zz - cz) / rz) ** 2) < 1.0
        labels[ball] = cls
    image = rng.normal(0.0, 1.0, size=(h, w, d)).astype(np.float32)
    image += 3.0 * (labels > 0)
    return image


def nms_cases(device):
    """(name, boxes [N, 6] f32 score-sorted, valid [N] bool, thr, k)."""
    import numpy as np
    import torch

    cases = []
    for n in (1, 63, 64, 65, 1000, 1024, 3000):
        rng = np.random.default_rng(n)
        lo = rng.uniform(0, 60, size=(n, 3))
        sz = rng.uniform(2, 30, size=(n, 3))
        boxes = np.concatenate([lo, lo + sz], 1).astype(np.float32)
        # duplicates and integer corners (refine_detections rounds boxes)
        if n > 4:
            boxes[n // 2] = boxes[1]
            boxes[-1] = boxes[0]
            boxes[: n // 4] = np.round(boxes[: n // 4])
        # tied scores: a stable sort keeps ties in index order
        scores = np.round(rng.uniform(size=n), 2)
        order = np.argsort(-scores, kind="stable")
        boxes = boxes[order]
        valid = rng.uniform(size=n) > 0.2
        for k in sorted({1, 64, n}):
            for thr in (0.3, 0.7):
                cases.append((f"n{n}_k{k}_t{thr}_someinvalid",
                              boxes, valid, thr, k))
            cases.append((f"n{n}_k{k}_t0.7_allvalid", boxes,
                          np.ones(n, bool), 0.7, k))
        # k reached early: a loose threshold keeps many, k stops it
        cases.append((f"n{n}_k3_t0.9_early", boxes, np.ones(n, bool), 0.9, 3))
    out = []
    for name, b, v, thr, k in cases:
        out.append((name, torch.from_numpy(np.ascontiguousarray(b)).to(device),
                    torch.from_numpy(np.ascontiguousarray(v)).to(device),
                    thr, k))
    return out


def _dev_us(event) -> float:
    """Device microseconds of a profiler event (the attribute's name
    changed across PyTorch versions)."""
    return (getattr(event, "device_time_total", None)
            or getattr(event, "cuda_time_total", 0))


def profile_requests(det, vols, seen, k1):
    """Where a served request's device time goes, and K1's device time.

    Three requests under torch.profiler: device time summed over all
    kernels, and the kernels with the most of it.  Then K1 on the captured
    inputs of both NMS sites, without the host's launch cost: the median
    replay of a CUDA graph of one call (CUDA events), and torch.profiler's
    device time of its two kernels a call.  Returns the graph-replay ms of
    each site."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for vol in vols:
            det.detect(vol)
        torch.cuda.synchronize()
    dev = sorted(((_dev_us(e), e.key, e.count) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 reverse=True)
    print(f"profile: device busy {sum(d for d, _, _ in dev) / 3e3:.3f} ms "
          f"per request", flush=True)
    for us, name, count in dev[:12]:
        print(f"profile: {us / 3e3:.3f} ms/request {count / 3:g} "
              f"calls/request {name[:100]}", flush=True)

    graph_ms = []
    for boxes, valid, thr, k in seen:
        def call():
            k1.sorted_nms(boxes, valid, thr, k)

        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            call()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            call()
        graph_ms.append(cuda_ms(graph.replay, 200, 10))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        kernel_us = sum(_dev_us(e) for e in prof.key_averages()
                        if "iou_mask_kernel" in e.key
                        or "sweep_kernel" in e.key)
        print(f"profile: k1 N={boxes.shape[0]} k={k} thr={thr}: device "
              f"{graph_ms[-1]:.4f} ms (graph replay), {kernel_us / 20e3:.4f} "
              f"ms (profiler)", flush=True)
    return graph_ms


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr, flush=True)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from cfun_tpu_torch import _build
    from cfun_tpu_torch import config as port_config
    from cfun_tpu_torch import weights
    from cfun_tpu_torch.inference import Detector
    from cfun_tpu_torch.models import cfun
    from cfun_tpu_torch.ops import sorted_nms as k1

    dev = torch.device("cuda", 0)

    with phase("env"):
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}",
              flush=True)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        card = smi.splitlines()[0].strip()
        print(f"card {torch.cuda.get_device_name(0)} "
              f"(nvidia-smi: {card})", flush=True)

    with phase("build"):
        lib = _build.library()
        print(f"kernels {os.path.relpath(lib._name, ROOT)} built in "
              f"{_build.last_build_seconds:.3f} s from "
              f"{len(_build.sources())} source(s)", flush=True)

    with phase("k1"):
        n_cases = 0
        for name, boxes, valid, thr, k in nms_cases(dev):
            idx, keep = k1.sorted_nms(boxes, valid, thr, k)
            torch.cuda.synchronize()
            ridx, rkeep = k1.sorted_nms_reference(boxes, valid, thr, k)
            check(torch.equal(keep, rkeep), f"k1 {name}: keep differs")
            check(torch.equal(idx, ridx), f"k1 {name}: idx differs "
                  f"{idx[:8].tolist()} vs {ridx[:8].tolist()}")
            n_cases += 1
        print(f"k1 exact on {n_cases} cases", flush=True)

    with phase("serve"):
        cfg = port_config.heart_inference_config("beginning",
                                                 nms_backend="pallas")
        wpath = os.path.join(ROOT, "weights", "heart_synth.npz")
        params, meta = weights.load_npz(wpath, cfg)
        print(f"weights {os.path.relpath(wpath, ROOT)} tag={meta.get('tag')} "
              f"stage={meta.get('stage')}", flush=True)
        det = Detector(cfg, params)
        vols = [synth_heart(seed) for seed in range(3)]
        det.detect(vols[0])  # first call: cuDNN set-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        k1.launches = 0
        results, timings = [], []
        for vol in vols:
            results.append(det.detect(vol))
            timings.append(dict(det.last_timings))
        torch.cuda.synchronize()
        served_launches = k1.launches

        n_found = 0
        for i, (vol, res, t) in enumerate(zip(vols, results, timings)):
            check(res["mask"].shape == vol.shape, f"request {i} mask shape")
            check(res["mask"].dtype == np.int16, f"request {i} mask dtype")
            check(int(res["mask"].min()) >= 0 and
                  int(res["mask"].max()) < cfg.num_classes,
                  f"request {i} labels in [0, {cfg.num_classes})")
            check(res["rois"].ndim == 2 and res["rois"].shape[1] == 6,
                  f"request {i} rois shape")
            check(np.all(np.isfinite(res["scores"])), f"request {i} scores")
            n_found += len(res["scores"])
            print(f"request {i}: mold {t['mold'] * 1e3:.1f} ms device "
                  f"{t['device'] * 1e3:.1f} ms unmold {t['unmold'] * 1e3:.1f}"
                  f" ms total {t['total'] * 1e3:.1f} ms; rois "
                  f"{res['rois'].tolist()} scores {res['scores'].tolist()} "
                  f"labelled voxels {int((res['mask'] > 0).sum())}",
                  flush=True)
        print(f"served 3 requests, {n_found} detection(s), sorted_nms "
              f"launches {served_launches}", flush=True)
        check(served_launches >= 1, "the served path launched sorted_nms")
        check(served_launches == 6, "two sorted_nms launches per request")
        check(n_found >= 1, "the trained model detects the synthetic heart")
        print(f"max_memory_allocated {torch.cuda.max_memory_allocated()} B",
              flush=True)

        # the same request through the plain NMS: same detections
        wire, window, _ = det.mold(vols[0])
        seen = []

        def plain(boxes, valid, thr, k):
            seen.append((boxes.clone(), valid.clone(), thr, k))
            return k1.sorted_nms_reference(boxes, valid, thr, k)

        buf_plain = det.infer(wire, window, nms=plain).cpu().numpy()
        buf_kernel = det.infer(wire, window).cpu().numpy()
        nd = cfg.detection_max_instances
        det_p = cfun.unpack_fast_output(buf_plain, nd, det.labels_shape)
        det_k = cfun.unpack_fast_output(buf_kernel, nd, det.labels_shape)
        check(np.array_equal(det_p[0], det_k[0]) and
              np.array_equal(det_p[1], det_k[1]),
              f"served detections with the plain NMS {det_p[0].tolist()} vs "
              f"kernel {det_k[0].tolist()}")
        agree = float((det_p[2] == det_k[2]).mean())
        print(f"plain-NMS graph: same detections; labels agree {agree}",
              flush=True)
        check(len(seen) == 2, "two NMS sites per request")

        kern = []
        for boxes, valid, thr, k in seen:
            idx, keep = k1.sorted_nms(boxes, valid, thr, k)
            ridx, rkeep = k1.sorted_nms_reference(boxes, valid, thr, k)
            check(torch.equal(idx, ridx) and torch.equal(keep, rkeep),
                  f"k1 at served shape N={boxes.shape[0]} k={k}")
            err = float((idx.long() - ridx.long()).abs().max())
            kept = int(rkeep.sum())
            ms = cuda_ms(lambda: k1.sorted_nms(boxes, valid, thr, k), 50)
            plain_ms = cuda_ms(
                lambda: k1.sorted_nms_reference(boxes, valid, thr, k), 5, 1)
            bound, by, pairs = nms_bound_ms(valid, ridx, rkeep)
            kern.append({"shape": f"{boxes.shape[0]}->{k}@{thr}",
                         "kept": kept, "iou_pairs_needed": pairs,
                         "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": by,
                         "max_abs_err": err})
            print(f"k1 N={boxes.shape[0]} k={k} thr={thr}: kernel {ms:.4f} ms,"
                  f" plain {plain_ms:.3f} ms, bound {bound:.3g} ms ({by}), "
                  f"kept {kept}, IoU pairs needed {pairs}", flush=True)

    with phase("profile"):
        for site, ms in zip(kern, profile_requests(det, vols, seen, k1)):
            site["device_ms"] = ms

    with phase("small"):
        tcfg = port_config.tiny_config(detection_max_instances=1,
                                       wire_image_dtype="int8",
                                       fast_unmold=True,
                                       device_normalize=True)
        tparams = weights.init_params(tcfg, seed=0)
        # a confident FG class, so the small graph has a detection to hold
        tparams["classifier"]["cls"]["b"] = torch.tensor([0.0, 3.0])
        d, h, w = tcfg.image_shape
        vol = synth_heart(7, (h + 16, w, d + 8))
        # full float32 on the card (cuDNN convs default to TF32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        r_gpu = Detector(tcfg, tparams).detect(vol)
        r_cpu = Detector(tcfg, tparams, device="cpu").detect(vol)
        check(len(r_cpu["scores"]) >= 1, "small: a detection to compare")
        check(r_gpu["rois"].shape == r_cpu["rois"].shape,
              "small: detection count")
        check(np.abs(r_gpu["rois"] - r_cpu["rois"]).max(initial=0) <= 1,
              f"small: boxes {r_gpu['rois'].tolist()} vs "
              f"{r_cpu['rois'].tolist()}")
        check(np.allclose(r_gpu["scores"], r_cpu["scores"], atol=1e-4),
              "small: scores")
        small_agree = float((r_gpu["mask"] == r_cpu["mask"]).mean())
        check(small_agree >= 0.99, f"small: labels agree {small_agree}")
        print(f"small config: card vs CPU rois {r_gpu['rois'].tolist()} / "
              f"{r_cpu['rois'].tolist()}, labels agree {small_agree}",
              flush=True)

    total = time.perf_counter() - _T0
    print(f"total {total:.3f} s", flush=True)
    per_req_ms = sum(s["ms"] for s in kern)
    line = {"kernels": [{
        "name": "sorted_nms", "route": "cuda",
        "source": "cfun_tpu_torch/csrc/sorted_nms.cu",
        "replaces": "cfun_tpu/ops/pallas_nms.py:93",
        "shape": " + ".join(s["shape"] for s in kern),
        "launches": served_launches, "launches_per_request": 2,
        "max_abs_err": max(s["max_abs_err"] for s in kern),
        "ms": per_req_ms,
        "plain_ms": sum(s["plain_ms"] for s in kern),
        "bound_ms": sum(s["bound_ms"] for s in kern),
        "bound_by": max(kern, key=lambda s: s["bound_ms"])["bound_by"],
        "library_ms": None, "exact_match": True,
        "per_shape": kern}]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
