#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cfun_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # every phase, both model families
    python3 chip_smoke.py heart      # the shared phases + the heart paths
    python3 chip_smoke.py lits       # the shared phases + the LiTS paths

With no argument it needs all three checkpoints (weights/heart_synth.npz,
weights/heart_synth_ft.npz, weights/lits_synth.npz); ``heart`` needs the
first two, ``lits`` the third.  A missing checkpoint is an error (exit 1).

Phases, each printed as ``phase <name> start`` / ``phase <name> done <s>``
(shared: env build k1 k2; heart: serve serve_fused serve_ft cli_heart;
LiTS: serve_lits serve_lits_fused cli_lits; then stream k2_served profile
small, each on the families that ran):

  env     torch / CUDA versions and the card (nvidia-smi name, power limit)
  build   nvcc-builds the port's CUDA kernels from cfun_tpu_torch/csrc
          and prints what ptxas reported for each (registers, shared
          memory, spills); at the same time g++-builds the host ops
          (csrc/host_ops.cc) and prints the seconds, the flags and the
          thread counts (OpenMP's, the CPU's, PyTorch's)
  k1      holds the sorted-NMS kernel against its plain PyTorch version on
          edge cases, N from 1 to 4096 around the 64-box words (exact idx /
          keep), on two new inputs replayed through one CUDA graph of it,
          and on two streams at once; then the LiTS sites' sizes (1000->50
          and 50->10 at IoU 0.7) on seeded boxes, checked and timed beside
          their bound
  serve   whole-heart inference at full width (192x320x320, stage
          'beginning', heart_inference_config with nms_backend='pallas'):
          weights/heart_synth.npz, three requests through Detector.detect
          with the kernel launch counts reset before and read after, each
          printed with its mold / device / unmold ms, the unmold's parts
          and the bytes up and down; the mold is the native slab pipeline
          (int8 slabs from page-locked buffers, uploaded while the next
          resizes).  One more request with native=False (the NumPy mold)
          on the same card, for comparison.  Then the served graph with
          the plain NMS passed in must give the same detections, and the
          kernel is held against its plain version on the NMS inputs the
          served graph produced
  k2      holds the fused-conv kernel against its plain PyTorch version
          on edge cases (y within one bf16 ulp, moments to 1e-4, two
          launches bit-equal), among them C_in and C_out around the
          kernel's pads and tiles, W = 1 and H, W off the output tile
  serve_fused  the same three requests with the fused U-Net
          (pallas_unet=True): K2 12 times a request at the shapes of
          K2_SERVED, by the kernel's own record of its launches, the same
          detections as 'serve', and on one served crop at full size the
          fused and the dense bf16 U-Net held against the dense f32 one
          (TF32 off)
  serve_ft  stage 'finetune' with the fused U-Net and
          weights/heart_synth_ft.npz: three requests, K2 at the same
          shapes, 192^3 label volumes, and the same criterion against the
          dense finetune U-Net; on one served crop in float32 (TF32 off)
          the phase-decomposed upscale head against the explicit one
          (1e-5 of the logits' largest magnitude, labels >= 99.9%), and
          the dense U-Net with the phase up-convs against the explicit
          ones (2e-4 of the logits' largest magnitude, labels >= 99.9%)
  cli_heart  the heart CLI (cfun_tpu_torch.cli.heart_main.main, in this
          process, in a temporary directory) on the JAX package's
          held-out heart set (SyntheticDataset n=12, seed 3000,
          144x144x96, written as float32 .nii.gz with a dataset.json)
          with weights/heart_synth.npz: 'test' (K1 twice a volume at the
          served shapes and no call of its plain version, each export
          equal to Detector.detect's mask, Dice from the exports >= the
          JAX package's recorded 0.6691 - 0.03, box IoU beside its
          0.8875), 'submit' (exports equal test's), 'test --exact' (its
          Dice mean within 0.01 of the fast path's; the per-class gaps
          taken apart into the wire's and the unmold's through
          Detector.detect) and 'test --limit 1 --trace' (the trace file
          names K1's kernel); each volume's load / detect (mold, device,
          unmold) / metrics / save ms, submit's sustained s a volume, the
          bytes read and written
  serve_lits  LiTS inference at full width (256x320x320, P3D35,
          lits_inference_config('finetune'): FPN 160, U-Net base 32 at
          batch 10, the device overlap paste, the 2-bit wire) with
          weights/lits_synth.npz: the three seeded held-out volumes its
          training evaluated (400x400x280, SyntheticLiTS(n=3, seed=90)) and
          one 512x512x400 volume, through Detector.detect (the native
          pipelined LiTS mold from page-locked buffers, the native unmold),
          launch counts reset before and read after; per-class Dice
          against the drawn labels beside the JAX package's recorded
          numbers; one native=False request; the served graph with the
          plain NMS; K1 timed at the NMS inputs it served
  serve_lits_fused  the same requests with pallas_unet=True: the same
          detections, K2 8 times a request at the shapes of K2_SERVED_LITS
          (batch 10), and the fused U-Net as close to dense f32 as dense
          bf16 on one served crop
  cli_lits  the LiTS CLI (cfun_tpu_torch.cli.lits_main.main) on the
          three held-out volumes of serve_lits written as the .npy cache:
          'test --limit 0' (every volume scored, K1 twice a volume, no
          plain NMS, exports equal to Detector.detect's masks, Dice from
          the exports at serve_lits' floors; the parts of one export's
          save), 'submit' of one test volume whose raw scan is
          512x512x128 (the export has that geometry and is the test mask
          resized there), and 'test --exact' on liver_0 (the host overlap
          unmold of the probability stacks), its Dice beside the fast
          path's
  stream  Detector.detect_stream over four full-width heart volumes on the
          dense path: the same results as serial detect, in order, the
          sustained ms a volume beside the serial ms, the launch counts
          reset before and read after; then the synchronizing CUDA calls
          one request's mold and dispatch make (heart, and LiTS),
          counted under torch.cuda.set_sync_debug_mode('warn')
  k2_served  the fused-conv kernel at each shape serve_fused and
          serve_lits_fused launched it at, as recorded there: checked as
          in 'k2', and timed beside its
          bound, the plain version and cuDNN's bf16 conv alone, with its
          TFLOP/s, its share of the bound and its ratio to cuDNN's conv;
          each shape and the sum weighted by the launches recorded a
          request
  profile where a served request's device time goes (torch.profiler), on
          the dense, fused and finetune paths and both LiTS paths, with
          every host-device copy by kind (the wire's upload is Pinned ->
          Device), the LiTS overlap paste's device time and kernels, and
          K1's device time without the host's launch cost (CUDA-graph
          replay; K2's is taken in phase k2_served)
  small   the port on the card against the port on the CPU (plain
          versions, float32, TF32 off) on the tiny config, and on a tiny
          LiTS config

Each served phase (and 'stream', and each CLI command) sets every
kernel's launch count and its record of launch shapes to 0 just before its
requests and reads them just after; the CLI paths are in the kernels
line's launches_by_path.

Then a ``{"serving": ...}`` JSON line, one with the kernels, the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.  Any failed check raises and the exit
code is non-zero; without a CUDA device the script exits 2 before any
phase.  A watchdog ends a hung run after 600 s with a traceback.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
WATCHDOG_S = 600
H100_F32_OPS_PER_S = 67e12   # H100 SXM data sheet, f32 outside tensor cores
H100_BF16_OPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
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


def k2_bound_ms(b, c_in, c_out, v):
    """Least time for one fused-conv call on an H100: 2 * 27 * C_in *
    C_out multiply-adds a voxel over the bf16 tensor-core rate, against
    the bytes moved once (x read and y written in bf16, w in bf16, scale,
    shift and sums in f32) over the HBM rate.  Returns (ms, 'bytes' |
    'operations')."""
    ops = 2 * 27 * c_in * c_out * v * b
    nbytes = (b * c_in * v * 2 + b * c_out * v * 2 + c_out * c_in * 27 * 2
              + 2 * b * c_in * 4 + b * 2 * c_out * 4)
    t_ops = ops / H100_BF16_OPS_PER_S
    t_bytes = nbytes / H100_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


# the device kernels of one K2 call: the weights' repack, then the conv
K2_KERNELS = ("pack_weights_kernel", "fused_conv3d_kernel")
# the device kernel of one K1 call
K1_KERNELS = ("sorted_nms_kernel",)

# The K2 launches a request that the fused U-Net must make at a 96^3 crop,
# base 20 and min_fused_voxels 4096 with one detection a request, by
# (B, C_in, C_out, D, H, W): serve_fused checks its recorded launches
# against this table.
K2_SERVED = {(1, ci, co, n, n, n): calls for ci, co, n, calls in (
    (20, 20, 96, 2), (40, 20, 96, 1), (40, 40, 96, 1), (40, 40, 48, 2),
    (80, 40, 48, 1), (80, 80, 48, 1), (80, 80, 24, 2), (160, 80, 24, 1),
    (160, 160, 24, 1))}
# The K2 launches a LiTS request makes (lits_inference_config('finetune',
# pallas_unet=True)): ten crops of (32, 80, 80), base 32, min_fused_voxels
# 4096, so the 8x20x20 level and below stay on cuDNN.
K2_SERVED_LITS = {(10, ci, co, *dhw): calls for ci, co, dhw, calls in (
    (32, 32, (32, 80, 80), 2), (64, 32, (32, 80, 80), 1),
    (64, 64, (32, 80, 80), 1), (64, 64, (16, 40, 40), 2),
    (128, 64, (16, 40, 40), 1), (128, 128, (16, 40, 40), 1))}
# K1 at the LiTS NMS sites: propose (1000 -> 50) and refine_detections
# (50 -> 10), both at IoU 0.7
LITS_K1 = ((1000, 50, 0.7), (50, 10, 0.7))
# the JAX package's held-out per-class Dice of weights/lits_synth.npz
# (benchmarks/lits_synth_e2e.json, stage finetune): liver, tumour
LITS_JAX_DICE = (0.975, 0.9597)
CHECKPOINTS = {"heart": ("weights/heart_synth.npz",
                         "weights/heart_synth_ft.npz"),
               "lits": ("weights/lits_synth.npz",)}
# CLI runs: the JAX package's held-out heart evaluation set
# (benchmarks/heart_synth_eval.py: SyntheticDataset(n=12, seed=3000,
# host_shape=(144, 144, 96), n_fg=7)) and its recorded numbers for
# weights/heart_synth.npz at stage 'beginning'
# (benchmarks/heart_synth_eval.json)
HEART_EVAL = dict(n=12, seed=3000, host_shape=(144, 144, 96), n_fg=7)
HEART_JAX_EVAL = {"dice_mean": 0.6691, "box_iou_mean": 0.8875}
# (B, C_in, C_out, D, H, W, pre_lrelu): D = 1, B = 2, sizes and channel
# counts that are not multiples of the kernel's tiles and chunks; then
# C_in of 8, 20, 24 and 25 (around the pad to 8 and the 32-channel
# chunk), C_out of 24, 81 and 161 (around the 80-channel N tile), W = 1,
# and H, W off the 2 x 8 x 8 output tile
K2_EDGE = ((1, 4, 4, 1, 8, 8, True), (2, 6, 5, 5, 7, 9, True),
           (2, 6, 5, 5, 7, 9, False), (1, 33, 47, 9, 9, 9, True),
           (1, 160, 160, 3, 5, 17, False), (1, 4, 160, 4, 8, 8, True),
           (1, 160, 4, 4, 8, 8, True), (3, 20, 20, 7, 13, 11, True),
           (1, 8, 24, 3, 5, 1, True), (1, 20, 81, 4, 9, 10, False),
           (2, 24, 161, 3, 7, 12, True), (1, 25, 24, 5, 11, 13, True),
           (1, 40, 81, 3, 6, 1, True), (1, 20, 20, 5, 24, 24, True))


def ptxas_summary(log):
    """Per kernel of the build: (name, registers, static shared bytes,
    spill stores, spill loads, stack bytes), from ptxas -v's report.  A
    template instance of K2 is named by its <NTW, WN>."""
    import re

    out, name, props = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            name = next((k for k in K2_KERNELS + K1_KERNELS
                         if k in mangled), mangled)
            t = re.search(r"kernelILi(\d+)E(?:Li(\d+)E)?", mangled)
            if t:
                name += "<" + ",".join(v for v in t.groups() if v) + ">"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            props = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and name is not None:
            out.append({"kernel": name, "registers": int(m.group(1)),
                        "static_smem_bytes": int(m.group(2) or 0),
                        "stack_bytes": props[0], "spill_stores": props[1],
                        "spill_loads": props[2]})
            name, props = None, (0, 0, 0)
    return out


def k2_inputs(b, c_in, c_out, d, h, w, seed, device):
    """Seeded inputs for one fused-conv call: bf16 x, f32 weights at the
    scale of the U-Net's Xavier init, a random (non-identity) affine."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, c_in, d, h, w), generator=g).to(torch.bfloat16)
    lim = (6.0 / (27 * (c_in + c_out))) ** 0.5
    wt = (torch.rand((c_out, c_in, 3, 3, 3), generator=g) * 2 - 1) * lim
    scale = 1.0 + 0.2 * torch.randn((b, c_in), generator=g)
    shift = 0.3 * torch.randn((b, c_in), generator=g)
    return [t.to(device) for t in (x, wt, scale, shift)]


def k2_check(k2, args, pre_lrelu, what):
    """K2 against its plain version on ``args``: y within one bf16 ulp of
    its magnitude (2^-7 bounds an ulp) plus 2^-16 of the sum of |terms|
    (the f32 sums' reassociation), Σy within 1e-4 of Σ|y|, Σy^2 within
    1e-4 relative, and two launches bit-equal.  Returns max |y - y_plain|."""
    import torch
    import torch.nn.functional as F

    x, wt, scale, shift = args
    y, s = k2.fused_conv3d(*args, pre_lrelu=pre_lrelu)
    y2, s2 = k2.fused_conv3d(*args, pre_lrelu=pre_lrelu)
    ry, rs = k2.fused_conv3d_reference(*args, pre_lrelu=pre_lrelu)
    torch.cuda.synchronize()
    check(torch.equal(y.view(torch.int16), y2.view(torch.int16)) and
          torch.equal(s, s2), f"k2 {what}: two launches differ")
    act = x.float() * scale[:, :, None, None, None] + \
        shift[:, :, None, None, None]
    if pre_lrelu:
        act = F.leaky_relu(act, 0.01)
    y_abs = F.conv3d(act.abs(), wt.to(torch.bfloat16).float().abs(),
                     padding=1)
    yf, ryf = y.float(), ry.float()
    err = (yf - ryf).abs()
    tol = 2.0 ** -7 * torch.maximum(yf.abs(), ryf.abs()) + 2.0 ** -16 * y_abs
    n_bad = int((err > tol).sum())
    check(n_bad == 0, f"k2 {what}: {n_bad} outputs beyond one bf16 ulp "
          f"(max err {float(err.max())})")
    ysum_abs = ryf.abs().sum(dim=(2, 3, 4))
    check(bool(((s[:, 0] - rs[:, 0]).abs() <= 1e-4 * ysum_abs).all()),
          f"k2 {what}: sum(y)")
    check(bool(((s[:, 1] - rs[:, 1]).abs() <= 1e-4 * rs[:, 1]).all()),
          f"k2 {what}: sum(y^2)")
    return float(err.max())


def graph_ms(fn):
    """Median device ms of one call of ``fn`` from CUDA-graph replays (no
    host launch cost)."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    # captured on the warm-up's stream, so what a wrapper holds per stream
    # (K1's workspace) is set up before the capture, not inside it
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    return cuda_ms(graph.replay, 100, 5)


def unet_criterion(apply_unet, apply_unet_fused, uparams, crop, stage):
    """The fused and the dense bf16 U-Net on one served crop, held against
    the dense f32 U-Net with TF32 off (tests/test_pallas_conv.py's
    criterion): fused mean error <= 1.5 x dense bf16's + 1e-3, fused argmax
    agreement >= dense bf16's - 0.01.  Returns the numbers."""
    import torch

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            ref = apply_unet(uparams, crop, stage=stage,
                             dtype=torch.float32)
            dense = apply_unet(uparams, crop, stage=stage,
                               dtype=torch.bfloat16).float()
            fused = apply_unet_fused(uparams, crop, stage=stage).float()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    check(fused.shape == ref.shape, f"{stage}: fused shape {fused.shape}")
    check(bool(torch.isfinite(fused).all()), f"{stage}: fused finite")
    out = {"dense_err": float((dense - ref).abs().mean()),
           "fused_err": float((fused - ref).abs().mean()),
           "dense_agree": float((dense.argmax(1) == ref.argmax(1))
                                .float().mean()),
           "fused_agree": float((fused.argmax(1) == ref.argmax(1))
                                .float().mean())}
    print(f"{stage} crop {tuple(crop.shape)}: vs f32 dense, mean err "
          f"dense bf16 {out['dense_err']:.6f} fused {out['fused_err']:.6f};"
          f" argmax agree dense bf16 {out['dense_agree']:.6f} fused "
          f"{out['fused_agree']:.6f}", flush=True)
    check(out["fused_err"] <= 1.5 * out["dense_err"] + 1e-3,
          f"{stage}: fused error {out}")
    check(out["fused_agree"] >= out["dense_agree"] - 0.01,
          f"{stage}: fused agreement {out}")
    return out


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


def synthetic_lits(n, seed, host_shape=(400, 400, 280)):
    """``n`` raw [H, W, D] HU volumes and their drawn [H, W, D] labels: a
    bright (low-HU) liver ellipsoid with a tumour core over ~300 HU
    background noise, volume ``i`` from seed ``seed + i``.  A copy of the
    formula of benchmarks/lits_train_steps.py::SyntheticLiTS, which made
    the data weights/lits_synth.npz was trained and evaluated on."""
    import numpy as np

    out = []
    h, w, d = host_shape
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        labels = np.zeros((h, w, d), np.int8)
        cy, cx, cz = (rng.integers(h // 3, 2 * h // 3),
                      rng.integers(w // 3, 2 * w // 3), d // 2)
        yy, xx, zz = np.ogrid[:h, :w, :d]
        liver = (((yy - cy) / (h // 5)) ** 2 + ((xx - cx) / (w // 5)) ** 2
                 + ((zz - cz) / (d // 4)) ** 2) < 1.0
        tumor = (((yy - cy) / (h // 12)) ** 2
                 + ((xx - cx) / (w // 12)) ** 2
                 + ((zz - cz) / (d // 10)) ** 2) < 1.0
        labels[liver] = 1
        labels[tumor] = 2
        vol = np.full((h, w, d), 300.0, np.float32)
        vol += rng.normal(0, 40, size=(h, w, d)).astype(np.float32)
        vol[liver] = -150.0
        vol[tumor] = -280.0
        out.append((vol, labels))
    return out


def per_class_dice(gt_labels, pred_labels, num_classes):
    """Dice per foreground class (a copy of
    cfun_tpu/utils/metrics.py::per_class_dice)."""
    import numpy as np

    dice = np.zeros(num_classes - 1, np.float64)
    for c in range(1, num_classes):
        gt = gt_labels == c
        pr = pred_labels == c
        inter = np.logical_and(gt, pr).sum(dtype=np.float64)
        denom = gt.sum(dtype=np.float64) + pr.sum(dtype=np.float64)
        dice[c - 1] = 2.0 * inter / (denom + 1e-6)
    return dice


def nms_random(n, seed, device):
    """Seeded score-sorted boxes [n, 6] and a validity mask, ~80% valid."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 60, size=(n, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(2, 30, size=(n, 3))], 1)
    return (torch.from_numpy(boxes.astype(np.float32)).to(device),
            torch.from_numpy(rng.uniform(size=n) > 0.2).to(device))


def k1_replay_and_streams(k1, device, n=1000, thr=0.7, k=64):
    """K1 captured once in a CUDA graph and replayed on two new inputs
    copied into its static input, and K1 on two streams at once; each
    result must equal the plain version on its own input."""
    import torch

    static_boxes, static_valid = nms_random(n, 10, device)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        k1.sorted_nms(static_boxes, static_valid, thr, k)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        idx, keep = k1.sorted_nms(static_boxes, static_valid, thr, k)
    for seed in (11, 12):
        boxes, valid = nms_random(n, seed, device)
        static_boxes.copy_(boxes)
        static_valid.copy_(valid)
        graph.replay()
        torch.cuda.synchronize()
        ridx, rkeep = k1.sorted_nms_reference(boxes, valid, thr, k)
        check(torch.equal(idx, ridx) and torch.equal(keep, rkeep),
              f"k1 graph replay on new input (seed {seed})")
    inputs = [nms_random(n, seed, device) for seed in (13, 14)]
    streams = [torch.cuda.Stream() for _ in inputs]
    for _ in range(3):  # the first round sets up each stream's workspace
        outs = []
        for s, (boxes, valid) in zip(streams, inputs):
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                outs.append(k1.sorted_nms(boxes, valid, thr, k))
        for s in streams:
            torch.cuda.current_stream().wait_stream(s)
        torch.cuda.synchronize()
        for (boxes, valid), (idx, keep) in zip(inputs, outs):
            ridx, rkeep = k1.sorted_nms_reference(boxes, valid, thr, k)
            check(torch.equal(idx, ridx) and torch.equal(keep, rkeep),
                  "k1 on two streams at once")
    print(f"k1 exact across 2 CUDA-graph replays on new inputs and on 2 "
          f"streams at once (N={n} k={k} thr={thr})", flush=True)


def nms_cases(device):
    """(name, boxes [N, 6] f32 score-sorted, valid [N] bool, thr, k)."""
    import numpy as np
    import torch

    cases = []
    for n in (1, 63, 64, 65, 127, 128, 129, 1000, 1024, 1025, 3000, 4096):
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


def profile_requests(det, vols, label):
    """Where a served request's device time goes: the requests ``vols``
    under torch.profiler, device time summed over all kernels, and the
    kernels with the most of it.  Returns (busy ms a request, {kernel: ms
    a request})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = len(vols)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for vol in vols:
            det.detect(vol)
        torch.cuda.synchronize()
    dev = sorted(((_dev_us(e), e.key, e.count) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 reverse=True)
    busy = sum(d for d, _, _ in dev) / (n * 1e3)
    n_ops = sum(c for _, _, c in dev) / n
    print(f"profile {label}: device busy {busy:.3f} ms per request in "
          f"{n_ops:g} kernels and copies ({n} requests)", flush=True)
    for us, name, count in dev[:14]:
        print(f"profile {label}: {us / (n * 1e3):.3f} ms/request "
              f"{count / n:g} calls/request {name[:100]}", flush=True)
    for us, name, count in dev:
        if "memcpy" in name.lower():
            print(f"profile {label} copy: {us / (n * 1e3):.4f} ms/request "
                  f"{count / n:g} calls/request {name}", flush=True)
    return busy, {name: us / (n * 1e3) for us, name, _ in dev}


def paste_profile(cfun, det, vol):
    """The LiTS overlap paste alone, on the inputs one served request gives
    it: its device ms (CUDA-graph replay, no host launch cost), its host
    + device ms as called (CUDA events), and its kernels by name
    (torch.profiler, ms a call).  Returns a dict."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen = []
    orig = cfun.overlap_paste_labels

    def record(mask_probs, detections, valid, cfg):
        seen.append((mask_probs.clone(), detections.clone(), valid.clone(),
                     cfg))
        return orig(mask_probs, detections, valid, cfg)

    wire, window, _ = det.mold(vol)
    cfun.overlap_paste_labels = record
    try:
        det.infer(wire, window)
    finally:
        cfun.overlap_paste_labels = orig
    check(len(seen) == 1, "one overlap paste a request")
    args = seen[0]

    def call():
        return orig(*args)

    ms = cuda_ms(call, 20)
    replay = graph_ms(call)
    reps = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    kernels = sorted(((_dev_us(e) / (reps * 1e3), e.key, e.count / reps)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    busy = sum(k[0] for k in kernels)
    print(f"profile overlap paste ({args[0].shape[0]} slots, probs "
          f"{tuple(args[0].shape)} {args[0].dtype}, "
          f"{int(args[2].sum())} valid): device {replay:.4f} ms (graph "
          f"replay), {busy:.4f} ms (profiler, kernels), {ms:.4f} ms as "
          f"called", flush=True)
    for k_ms, name, count in kernels:
        print(f"profile overlap paste: {k_ms:.4f} ms/call {count:g} "
              f"calls {name[:100]}", flush=True)
    return {"ms": ms, "device_ms": replay, "kernel_ms": busy,
            "kernels": {name: k_ms for k_ms, name, _ in kernels}}


def kernel_device_ms(call, names, reps=20):
    """Device ms of one ``call()``: the median replay of a CUDA graph of
    it (CUDA events), and torch.profiler's device time of the kernels
    whose names contain one of ``names``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    replay = graph_ms(call)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    kernel_us = sum(_dev_us(e) for e in prof.key_averages()
                    if any(n in e.key for n in names))
    return replay, kernel_us / (reps * 1e3)


def serve_requests(det, vols, counters, label):
    """One warm-up request (cuDNN set-up, not counted), then every kernel
    launch count and launch-shape record set to 0, the requests ``vols``
    through ``Detector.detect``, and both read just after.  Checks each
    result's shape, labels and scores.  Returns (results, {kernel:
    launches}, {kernel: {shape: launches}}, detections found, [timings],
    peak device bytes)."""
    import numpy as np
    import torch

    cfg = det.cfg
    det.warmup()
    det.detect(vols[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    results, timings = [], []
    for vol in vols:
        results.append(det.detect(vol))
        timings.append((dict(det.last_timings), dict(det.last_sub_timings),
                        dict(det.last_wire_bytes)))
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in counters.items()}
    shapes = {name: dict(mod.launch_shapes)
              for name, mod in counters.items()}

    n_found = 0
    for i, (vol, res, (t, sub, wire)) in enumerate(zip(vols, results,
                                                        timings)):
        check(res["mask"].shape == vol.shape, f"{label} {i} mask shape")
        check(res["mask"].dtype == np.int16, f"{label} {i} mask dtype")
        check(int(res["mask"].min()) >= 0 and
              int(res["mask"].max()) < cfg.num_classes,
              f"{label} {i} labels in [0, {cfg.num_classes})")
        check(res["rois"].ndim == 2 and res["rois"].shape[1] == 6,
              f"{label} {i} rois shape")
        check(np.all(np.isfinite(res["scores"])), f"{label} {i} scores")
        n_found += len(res["scores"])
        print(f"{label} request {i}: {request_line(t, sub, wire)}; rois "
              f"{res['rois'].tolist()} scores {res['scores'].tolist()} "
              f"labelled voxels {int((res['mask'] > 0).sum())}",
              flush=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: served {len(vols)} requests, {n_found} detection(s), "
          f"launches {launches} by shape {shapes}; max_memory_allocated "
          f"{peak} B", flush=True)
    return (results, launches, shapes, n_found, [t for t, _, _ in timings],
            peak)


def request_line(t, sub, wire):
    """One request's buckets (ms), the unmold's parts (ms) and the bytes
    up and down, as ``Detector.detect`` recorded them."""
    return (f"mold {t['mold'] * 1e3:.3f} ms device {t['device'] * 1e3:.3f}"
            f" ms unmold {t['unmold'] * 1e3:.3f} ms total "
            f"{t['total'] * 1e3:.3f} ms (fetch {sub['fetch'] * 1e3:.3f} "
            f"unpack {sub['unpack'] * 1e3:.3f} paste "
            f"{sub['paste'] * 1e3:.3f} ms); bytes up {wire['up']} down "
            f"{wire['down']}")


def reset_counts(counters):
    for mod in counters.values():
        mod.launches = 0
        mod.launch_shapes.clear()


def head_check(apply_unet, uparams, crop):
    """The finetune U-Net's phase forms against its explicit forms on one
    served crop, float32 with TF32 off: the upscale head alone on the same
    pre-head logits (within 1e-5 of the logits' largest magnitude, plus
    1e-5 relative: the CPU test's tolerance scaled), and the whole U-Net
    with the phase up-convs and head against the explicit one (within
    2e-4 of its logits' largest magnitude, plus 1e-4 relative: the CPU
    U-Net test's tolerance scaled the same way); labels (argmax) agreeing
    on >= 99.9% of voxels for both.  Returns the numbers."""
    import torch

    from cfun_tpu_torch import nn as tnn

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            pre = apply_unet(uparams, crop, stage="beginning",
                             up_impl="phase")
            phase = tnn.upsample2_conv_residual(uparams["out_upscale"], pre)
            explicit = tnn.upsample2_conv_residual_explicit(
                uparams["out_upscale"], pre)
            head_err = float((phase - explicit).abs().max())
            scale = float(explicit.abs().max())
            head_ok = bool(((phase - explicit).abs() <=
                            1e-5 * scale + 1e-5 * explicit.abs()).all())
            head_agree = float((phase.argmax(1) == explicit.argmax(1))
                               .float().mean())
            del phase, explicit
            full_phase = apply_unet(uparams, crop, stage="finetune",
                                    up_impl="phase", head_impl="phase")
            full_explicit = apply_unet(uparams, crop, stage="finetune")
            unet_err = float((full_phase - full_explicit).abs().max())
            unet_scale = float(full_explicit.abs().max())
            unet_ok = bool(((full_phase - full_explicit).abs() <=
                            2e-4 * unet_scale + 1e-4 * full_explicit.abs())
                           .all())
            unet_agree = float((full_phase.argmax(1) ==
                                full_explicit.argmax(1)).float().mean())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    out = {"head_max_err": head_err, "head_logit_max": scale,
           "head_label_agree": head_agree, "unet_max_err": unet_err,
           "unet_logit_max": unet_scale, "unet_label_agree": unet_agree}
    print(f"finetune crop {tuple(crop.shape)} f32: phase head vs explicit "
          f"max err {head_err:.3g} (logits up to {scale:.4g}), labels agree"
          f" {head_agree:.6f}; U-Net with phase up-convs + head vs explicit"
          f" max err {unet_err:.3g} (logits up to {unet_scale:.4g}), labels"
          f" agree {unet_agree:.6f}", flush=True)
    check(head_ok, f"phase head within 1e-5 of the logits' range: {out}")
    check(unet_ok, f"phase U-Net within 2e-4 of the logits' range: {out}")
    check(head_agree >= 0.999 and unet_agree >= 0.999,
          f"phase forms' labels agree on >= 99.9%: {out}")
    return out


@contextlib.contextmanager
def stage_timeline(det):
    """Record when each of ``det``'s stages ran: a list of (stage, thread
    name, start ms, end ms) that ``mold``, ``_dispatch`` (the host's
    enqueue of the device graph) and ``_finish`` (the wait for the output,
    the unpack and the paste) append to while the block runs."""
    import threading

    t0 = time.perf_counter()
    records = []

    def timed(name, fn):
        def run(*args, **kw):
            start = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                records.append((name, threading.current_thread().name,
                                (start - t0) * 1e3,
                                (time.perf_counter() - t0) * 1e3))
        return run

    for name in ("mold", "_dispatch", "_finish"):
        setattr(det, name, timed(name.strip("_"), getattr(det, name)))
    try:
        yield records
    finally:
        for name in ("mold", "_dispatch", "_finish"):
            delattr(det, name)


def print_timeline(label, records):
    for name, thread, start, end in records:
        print(f"{label} timeline: {name:8s} {start:9.3f} -> {end:9.3f} ms "
              f"({end - start:7.3f} ms) on {thread}", flush=True)


def sync_count(det, vol):
    """Synchronizing CUDA calls made by one request's mold and dispatch
    (everything the host enqueues before it waits for the output), under
    torch.cuda.set_sync_debug_mode('warn').  Returns (count, distinct
    messages)."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            wire, window, _ = det.mold(vol)
            pending = det._dispatch(wire, window)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    pending.event.synchronize()
    msgs = [str(w.message) for w in seen
            if "called a synchronizing" in str(w.message)]
    return len(msgs), sorted(set(m.splitlines()[0][:160] for m in msgs))


def capture_crop(cfun, det, vol):
    """The mask head's input crops [Dmax, 1, *mask_pool_size] f32 of one
    request (the served graph's own RoIAlign output)."""
    seen = []
    orig = cfun.apply_mask_head

    def record(params, crops, **kw):
        seen.append(crops.clone())
        return orig(params, crops, **kw)

    wire, window, _ = det.mold(vol)
    cfun.apply_mask_head = record
    try:
        det.infer(wire, window)
    finally:
        cfun.apply_mask_head = orig
    check(len(seen) == 1, "one mask-head call a request")
    return seen[0]


def k1_time(k1, boxes, valid, thr, k, label):
    """K1 against its plain version on one input (exact), timed beside its
    plain version and its bound.  Returns the per-shape record."""
    import torch

    idx, keep = k1.sorted_nms(boxes, valid, thr, k)
    ridx, rkeep = k1.sorted_nms_reference(boxes, valid, thr, k)
    check(torch.equal(idx, ridx) and torch.equal(keep, rkeep),
          f"k1 {label} N={boxes.shape[0]} k={k} thr={thr}")
    err = float((idx.long() - ridx.long()).abs().max())
    kept = int(rkeep.sum())
    ms = cuda_ms(lambda: k1.sorted_nms(boxes, valid, thr, k), 50)
    plain_ms = cuda_ms(
        lambda: k1.sorted_nms_reference(boxes, valid, thr, k), 5, 1)
    bound, by, pairs = nms_bound_ms(valid, ridx, rkeep)
    print(f"k1 {label} N={boxes.shape[0]} k={k} thr={thr}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.3g} ms "
          f"({by}), kept {kept}, IoU pairs needed {pairs}", flush=True)
    return {"shape": f"{boxes.shape[0]}->{k}@{thr}", "site": label,
            "kept": kept, "iou_pairs_needed": pairs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "max_abs_err": err}


def k1_at_served_sites(k1, cfun, det, vol, served_shapes, n_requests,
                       label):
    """The served graph on one request with the plain NMS passed in: the
    same detections as with the kernel, and the kernel's launches by shape
    in the served run those of these NMS inputs, ``n_requests`` times.
    Then the kernel at each site's inputs (``k1_time``).  Returns (sites,
    [(boxes, valid, thr, k)])."""
    import numpy as np

    cfg = det.cfg
    wire, window, _ = det.mold(vol)
    seen = []

    def plain(boxes, valid, thr, k):
        seen.append((boxes.clone(), valid.clone(), thr, k))
        return k1.sorted_nms_reference(boxes, valid, thr, k)

    buf_plain = det.infer(wire, window, nms=plain).cpu().numpy()
    buf_kernel = det.infer(wire, window).cpu().numpy()
    nd = cfg.detection_max_instances
    det_p = cfun.unpack_fast_output(buf_plain, nd, det.labels_shape,
                                    bits=det.pack_bits)
    det_k = cfun.unpack_fast_output(buf_kernel, nd, det.labels_shape,
                                    bits=det.pack_bits)
    check(np.array_equal(det_p[0], det_k[0]) and
          np.array_equal(det_p[1], det_k[1]),
          f"{label}: served detections with the plain NMS "
          f"{det_p[0].tolist()} vs kernel {det_k[0].tolist()}")
    agree = float((det_p[2] == det_k[2]).mean())
    print(f"{label} plain-NMS graph: same detections; labels agree {agree}",
          flush=True)
    check(len(seen) == 2, "two NMS sites per request")
    seen_shapes = {}
    for boxes, _, _, k in seen:
        key = (boxes.shape[0], k)
        seen_shapes[key] = seen_shapes.get(key, 0) + n_requests
    check(served_shapes == seen_shapes,
          f"{label}: the served K1 launches by shape {served_shapes} are "
          f"those of the NMS inputs taken here, {n_requests}x {seen_shapes}")
    sites = [k1_time(k1, boxes, valid, thr, k, f"{label} site")
             for boxes, valid, thr, k in seen]
    return sites, seen


def k2_time(k2, shape, n_rec, n_requests, seed, dev):
    """K2 at one recorded launch shape: checked as in phase k2 and timed
    beside its bound, its plain version and cuDNN's bf16 conv alone."""
    import torch

    b, ci, co, d, h, w = shape
    calls = n_rec / n_requests
    args = k2_inputs(b, ci, co, d, h, w, seed, dev)
    name = f"B={b} {ci}->{co} @{d}x{h}x{w}"
    err = k2_check(k2, args, True, f"served {name}")
    x, wt, scale, shift = args
    w16 = wt.to(torch.bfloat16)
    ms = cuda_ms(lambda: k2.fused_conv3d(*args), 50)
    plain_ms = cuda_ms(lambda: k2.fused_conv3d_reference(*args), 10)
    library_ms = cuda_ms(
        lambda: torch.nn.functional.conv3d(x, w16, padding=1), 50)
    device_ms, kernel_ms = kernel_device_ms(
        lambda: k2.fused_conv3d(*args), K2_KERNELS)
    bound, by = k2_bound_ms(b, ci, co, d * h * w)
    flops = 2 * 27 * ci * co * d * h * w * b
    print(f"k2 {name} x{calls:g} a request: kernel {ms:.4f} ms "
          f"(device {device_ms:.4f} graph / {kernel_ms:.4f} profiler), "
          f"plain {plain_ms:.4f} ms, cuDNN bf16 conv alone "
          f"{library_ms:.4f} ms, bound {bound:.4g} ms ({by}); "
          f"{flops / ms * 1e-9:.1f} TFLOP/s, {bound / ms:.4f} of the bound,"
          f" {ms / library_ms:.3f}x cuDNN's time; max err {err:.3g}",
          flush=True)
    return {"shape": name, "launches": n_rec, "calls_per_request": calls,
            "ms": ms, "device_ms": device_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms, "max_abs_err": err, "flops": flops,
            "tflops": flops / ms * 1e-9, "bound_share": bound / ms,
            "vs_library": ms / library_ms}


def k2_request(shapes, label):
    """A request's K2 numbers: each shape's weighted by its calls."""
    req = {key: sum(s[key] * s["calls_per_request"] for s in shapes)
           for key in ("ms", "device_ms", "plain_ms", "bound_ms",
                       "library_ms", "flops")}
    n_calls = sum(s["calls_per_request"] for s in shapes)
    print(f"k2 {label} a request ({n_calls:g} calls): kernel "
          f"{req['ms']:.4f} ms (device {req['device_ms']:.4f}), cuDNN bf16 "
          f"conv alone {req['library_ms']:.4f} ms, plain "
          f"{req['plain_ms']:.4f} ms, bound {req['bound_ms']:.4f} ms; "
          f"{req['flops'] / req['ms'] * 1e-9:.1f} TFLOP/s, "
          f"{req['bound_ms'] / req['ms']:.4f} of the bound, "
          f"{req['ms'] / req['library_ms']:.3f}x cuDNN's time", flush=True)
    req.update(calls=n_calls, tflops=req["flops"] / req["ms"] * 1e-9,
               bound_share=req["bound_ms"] / req["ms"],
               vs_library=req["ms"] / req["library_ms"])
    return req


def k1_request(sites):
    return {key: sum(s[key] for s in sites)
            for key in ("ms", "device_ms", "kernel_ms", "plain_ms",
                        "bound_ms")}


@contextlib.contextmanager
def cli_probe():
    """Record what a CLI command does while the block runs: each volume
    file read ('load': ``nifti.load`` and ``np.load`` of a .npy), each
    ``Detector.detect`` with its ``last_timings``, each metric
    ('metrics') and each file written ('save': ``nifti.save``), as
    (stage, start s, end s, detail); and every call of K1's plain
    version.  Yields (records, plain-NMS calls)."""
    import numpy as np

    from cfun_tpu_torch.data import nifti
    from cfun_tpu_torch.inference import pipeline
    from cfun_tpu_torch.ops import sorted_nms as k1
    from cfun_tpu_torch.utils import metrics

    records, plain = [], []

    def timed(stage, fn, keep=None, detail=None):
        def run(*args, **kw):
            start = time.perf_counter()
            out = fn(*args, **kw)
            if keep is None or keep(*args):
                records.append((stage, start, time.perf_counter(),
                                detail(args) if detail else None))
            return out
        return run

    def counted(*args, **kw):
        plain.append(args[0].shape[0])
        return orig_plain(*args, **kw)

    orig_plain = k1.sorted_nms_reference
    patches = [
        (nifti, "load", timed("load", nifti.load)),
        (np, "load", timed("load", np.load,
                           keep=lambda path, *a: str(path).endswith(".npy"))),
        (nifti, "save", timed("save", nifti.save)),
        (metrics, "per_class_mask_iou",
         timed("metrics", metrics.per_class_mask_iou)),
        (metrics, "per_class_dice", timed("metrics", metrics.per_class_dice)),
        (pipeline.Detector, "detect",
         timed("detect", pipeline.Detector.detect,
               detail=lambda args: dict(args[0].last_timings))),
        (k1, "sorted_nms_reference", counted)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield records, plain
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def cli_volumes(records):
    """Per volume of a ``test`` run, from ``cli_probe``'s records: the ms
    of 'load', 'detect' (and its 'mold' / 'device' / 'unmold'),
    'metrics' and 'save', and the wall ms from the volume's first read to
    the end of its last stage.  A volume's reads come before its detect;
    its metrics and saves after."""
    starts = sorted(start for stage, start, _, _ in records
                    if stage == "detect")
    vols = [{"load": 0.0, "detect": 0.0, "metrics": 0.0, "save": 0.0,
             "first": None, "last": 0.0} for _ in starts]
    for stage, start, end, detail in records:
        n_before = sum(s < start for s in starts)
        i = n_before if stage == "load" else n_before - 1
        if stage == "detect":
            i = starts.index(start)
            vols[i].update({k: v * 1e3 for k, v in detail.items()
                            if k != "total"})
        v = vols[i]
        v[stage] += (end - start) * 1e3
        v["first"] = start if v["first"] is None else min(v["first"], start)
        v["last"] = max(v["last"], end)
    for v in vols:
        v["wall"] = (v.pop("last") - v.pop("first")) * 1e3
    return vols


def print_cli_volumes(label, vols):
    for i, v in enumerate(vols):
        print(f"{label} volume {i}: load {v['load']:.3f} ms, detect "
              f"{v['detect']:.3f} ms (mold {v['mold']:.3f} device "
              f"{v['device']:.3f} unmold {v['unmold']:.3f}), metrics "
              f"{v['metrics']:.3f} ms, save {v['save']:.3f} ms; wall "
              f"{v['wall']:.3f} ms", flush=True)


def run_cli(label, main_fn, argv, cwd, counters):
    """``main_fn(argv)`` in ``cwd`` with every kernel launch count and
    launch-shape record set to 0 just before and read just after, under
    ``cli_probe``.  Returns (its return value, {kernel: launches},
    {kernel: {shape: launches}}, probe records, plain-NMS calls, wall
    s)."""
    os.makedirs(cwd, exist_ok=True)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with cli_probe() as (records, plain):
            reset_counts(counters)
            t0 = time.perf_counter()
            out = main_fn(argv)
            wall = time.perf_counter() - t0
            launches = {name: mod.launches for name, mod in counters.items()}
            shapes = {name: dict(mod.launch_shapes)
                      for name, mod in counters.items()}
    finally:
        os.chdir(here)
    print(f"{label}: {' '.join(argv)}: {wall:.3f} s, launches {launches} "
          f"by shape {shapes}, plain NMS calls {len(plain)}", flush=True)
    return out, launches, shapes, records, plain, wall


def dir_bytes(path):
    """Bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(path) for n in names)


def cli_heart_phase(tmp, counters, k1_per_request):
    """``python -m cfun_tpu_torch.cli.heart_main`` in this process on the
    JAX package's held-out heart set, written as float32 .nii.gz with a
    manifest under ``tmp``: ``test`` (K1 twice a volume at the served
    shapes ``k1_per_request``, no plain NMS; each export equal to
    ``Detector.detect``'s mask; Dice and box IoU against the JAX
    package's recorded numbers), ``submit`` (its exports equal
    ``test``'s), ``test --exact`` (its Dice mean within 0.01 of the fast
    path's; the per-class gaps taken apart into the wire's and the
    unmold's) and ``test --limit 1 --trace`` (the trace names K1's
    kernel).  Returns ({path: {kernel: launches}}, stats)."""
    import glob

    import numpy as np

    from cfun_tpu_torch import config as port_config
    from cfun_tpu_torch import weights
    from cfun_tpu_torch.cli import heart_main
    from cfun_tpu_torch.cli.lits_main import _box_iou, _gt_extended_box_yxz
    from cfun_tpu_torch.data import nifti
    from cfun_tpu_torch.data.datasets import SyntheticDataset
    from cfun_tpu_torch.inference import Detector
    from cfun_tpu_torch.utils import checkpoint
    from cfun_tpu_torch.utils.metrics import per_class_dice

    cfg = port_config.heart_inference_config("beginning")
    held = SyntheticDataset(cfg, **HEART_EVAL)
    n = held.num_images
    data = os.path.join(tmp, "data")
    os.makedirs(data)
    items = []
    t0 = time.perf_counter()
    for i in range(n):
        item = {"image": f"img_{i:02d}.nii.gz", "label": f"lbl_{i:02d}.nii.gz"}
        # float32: the volumes are z-scored, which int16 would erase
        nifti.save(os.path.join(data, item["image"]),
                   held.load_image(i)[..., 0].astype(np.float32), np.eye(4))
        nifti.save(os.path.join(data, item["label"]), held.load_mask(i),
                   np.eye(4))
        items.append(item)
    with open(os.path.join(data, "dataset.json"), "w") as f:
        json.dump({"train_and_test": items}, f)
    read_bytes = dir_bytes(data)
    print(f"cli_heart: wrote the {n} held-out {HEART_EVAL['host_shape']} "
          f"volumes and labels ({read_bytes} B) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    wpath = os.path.join(ROOT, "weights", "heart_synth.npz")
    common = ["--weights", wpath, "--stage", "beginning", "--data", data]
    by_path, stats = {}, {"volumes": n, "read_bytes": read_bytes}

    def run(path, argv):
        out, launches, shapes, records, plain, wall = run_cli(
            f"cli_heart {path}", heart_main.main, argv,
            os.path.join(tmp, path), counters)
        n_run = 1 if path == "trace" else n
        by_path[f"cli_heart_{path}"] = launches
        check(launches["sorted_nms"] == 2 * n_run and
              shapes["sorted_nms"] == {s: c * n_run for s, c
                                       in k1_per_request.items()},
              f"cli_heart {path}: K1 twice a volume at the served shapes "
              f"{k1_per_request}: {launches} {shapes}")
        check(launches["fused_conv3d"] == 0, "the dense U-Net: no K2")
        check(plain == [], f"cli_heart {path}: no plain NMS call ({plain})")
        stats[f"{path}_s"] = wall
        return out, records

    (ious, dices), records = run("test", ["test", *common, "--limit", str(n),
                                          "--save", "true"])
    vols = cli_volumes(records)
    check(len(vols) == n, f"cli_heart test: {len(vols)} volumes detected")
    print_cli_volumes("cli_heart test", vols)
    out_dir = os.path.join(tmp, "test", "results")
    stats.update(test_volumes_ms=vols, test_written_bytes=dir_bytes(out_dir))

    # the exports against Detector.detect on the same card and weights
    params, _ = checkpoint.load_any(wpath, cfg,
                                    weights.init_params(cfg, seed=0))
    det = Detector(cfg, params)
    files = {name.split("_", 1)[1]: name for name in os.listdir(out_dir)}
    check(sorted(files) == [it["image"] for it in items],
          f"cli_heart test: one export a volume: {sorted(files)}")
    masks, file_dice, box_ious, fast_rois = [], [], [], []
    for i, item in enumerate(items):
        saved, _ = nifti.load(os.path.join(out_dir, files[item["image"]]))
        image, _ = nifti.load(os.path.join(data, item["image"]))
        res = det.detect(image)
        check(saved.dtype == np.int32 and np.array_equal(saved, res["mask"]),
              f"cli_heart: the export of {item['image']} is "
              f"Detector.detect's mask")
        label = held.load_mask(i)
        file_dice.append(per_class_dice(label, saved, cfg.num_classes))
        rois = np.clip(res["rois"], 0, None).astype(np.int64)
        if len(rois):
            box_ious.append(_box_iou(_gt_extended_box_yxz(label).astype(
                np.float64), rois[0].astype(np.float64)))
        masks.append(saved)
        fast_rois.append(res["rois"])
    file_dice = np.array(file_dice)
    check(np.array_equal(file_dice, dices),
          "cli_heart: the CLI's Dice is the exported files'")
    dice_mean = float(file_dice.mean())
    box_iou_mean = float(np.mean(box_ious))
    print(f"cli_heart test: Dice per class "
          f"{[round(float(v), 4) for v in file_dice.mean(axis=0)]} mean "
          f"{dice_mean:.4f}, box IoU mean {box_iou_mean:.4f} ({len(box_ious)}"
          f" detections); the JAX package's recorded dice_mean "
          f"{HEART_JAX_EVAL['dice_mean']}, box_iou_mean "
          f"{HEART_JAX_EVAL['box_iou_mean']}", flush=True)
    check(dice_mean >= HEART_JAX_EVAL["dice_mean"] - 0.03,
          f"cli_heart: Dice mean {dice_mean} >= "
          f"{HEART_JAX_EVAL['dice_mean']} - 0.03")
    stats.update(dice_per_class=file_dice.mean(axis=0).tolist(),
                 dice_mean=dice_mean, box_iou_mean=box_iou_mean,
                 jax_recorded=HEART_JAX_EVAL)

    per_volume, records = run("submit", ["submit", *common, "--limit",
                                         str(n)])
    sub_dir = os.path.join(tmp, "submit", "results", "heart_submissions")
    for item, mask in zip(items, masks):
        got, _ = nifti.load(os.path.join(sub_dir, item["image"]))
        check(np.array_equal(got, mask),
              f"cli_heart submit: {item['image']} equals test's export")
    stats.update(
        submit_s_per_volume=per_volume,
        submit_load_ms=[(e - s) * 1e3 for st, s, e, _ in records
                        if st == "load"],
        submit_save_ms=[(e - s) * 1e3 for st, s, e, _ in records
                        if st == "save"],
        submit_written_bytes=dir_bytes(sub_dir))
    print(f"cli_heart submit: {per_volume:.3f} s/volume sustained over {n} "
          f"volumes, equal to test's exports", flush=True)

    (_, exact_dices), records = run("exact", [
        "test", *common, "--limit", str(n), "--save", "false", "--exact"])
    evols = cli_volumes(records)
    print_cli_volumes("cli_heart exact", evols)
    gap = exact_dices.mean(axis=0) - dices.mean(axis=0)
    print(f"cli_heart exact: Dice per class "
          f"{[round(float(v), 4) for v in exact_dices.mean(axis=0)]} mean "
          f"{float(exact_dices.mean()):.4f} against the fast path's "
          f"{dice_mean:.4f}; per-class gaps {np.round(gap, 4).tolist()}",
          flush=True)
    check(abs(float(exact_dices.mean()) - dice_mean) <= 0.01,
          f"cli_heart: the Dice mean of --exact within 0.01 of the fast "
          f"path's: {float(exact_dices.mean())} vs {dice_mean}")
    stats.update(exact_volumes_ms=evols,
                 exact_dice_per_class=exact_dices.mean(axis=0).tolist(),
                 exact_gap_per_class=gap.tolist())

    # where the per-class gaps come from: the wire (int8 + device z-score
    # against bf16 + host z-score) and the unmold (device 2x upsample,
    # argmax, nearest paste against the host's trilinear paste of the
    # probabilities, then argmax) apart, through Detector.detect
    variants = {"int8 wire, exact unmold": dict(fast_unmold=False),
                "bf16 wire, fast unmold": dict(wire_image_dtype="bfloat16",
                                               device_normalize=False),
                "bf16 wire, exact unmold (--exact)": dict(
                    wire_image_dtype="bfloat16", device_normalize=False,
                    fast_unmold=False)}
    stats["exact_decomposition"] = {}
    for name, overrides in variants.items():
        vdet = Detector(cfg.replace(**overrides), params)
        vdice, same_boxes = [], 0
        for i, item in enumerate(items):
            image, _ = nifti.load(os.path.join(data, item["image"]))
            res = vdet.detect(image)
            vdice.append(per_class_dice(held.load_mask(i), res["mask"],
                                        cfg.num_classes))
            same_boxes += int(np.array_equal(res["rois"], fast_rois[i]))
        vdice = np.array(vdice)
        vgap = vdice.mean(axis=0) - dices.mean(axis=0)
        print(f"cli_heart exact decomposition, {name}: Dice per class "
              f"{np.round(vdice.mean(axis=0), 4).tolist()} mean "
              f"{float(vdice.mean()):.4f}; gaps to the fast path "
              f"{np.round(vgap, 4).tolist()}; boxes equal to the fast "
              f"path's on {same_boxes} of {n} volumes", flush=True)
        stats["exact_decomposition"][name] = {
            "dice_per_class": vdice.mean(axis=0).tolist(),
            "gap_per_class": vgap.tolist(), "same_boxes": same_boxes}
        if "--exact" in name:
            check(np.allclose(vdice, exact_dices, atol=1e-9),
                  "cli_heart: Detector.detect in the --exact config gives "
                  "the CLI's --exact Dice")
        del vdet

    trace_dir = os.path.join(tmp, "trace_out")
    run("trace", ["test", *common, "--limit", "1", "--save", "false",
                  "--trace", trace_dir])
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    check(len(traces) == 1, f"cli_heart --trace: one trace file {traces}")
    with open(traces[0]) as f:
        named = K1_KERNELS[0] in f.read()
    check(named, f"cli_heart --trace: the trace names {K1_KERNELS[0]}")
    stats["trace_bytes"] = os.path.getsize(traces[0])
    print(f"cli_heart trace: {os.path.basename(traces[0])} "
          f"({stats['trace_bytes']} B) names {K1_KERNELS[0]}", flush=True)
    det.close()
    return by_path, stats


def cli_lits_phase(tmp, counters, k1_per_request, held):
    """``python -m cfun_tpu_torch.cli.lits_main`` in this process on the
    held-out LiTS volumes ``held`` ([(raw HU volume, labels)]) written in
    the preprocessed cache layout under ``tmp``: ``test --limit 0``
    (every volume scored, K1 twice a volume at the served shapes, no
    plain NMS, each export equal to ``Detector.detect``'s mask, the
    exported Dice at the ``serve_lits`` floors), ``submit`` of one test
    volume whose raw scan has another geometry (restored), and ``test
    --exact`` on ``liver_0``.  Returns ({path: {kernel: launches}},
    stats)."""
    import gzip

    import numpy as np

    from cfun_tpu_torch import config as port_config
    from cfun_tpu_torch import weights
    from cfun_tpu_torch.cli import lits_main
    from cfun_tpu_torch.data import nifti
    from cfun_tpu_torch.data.resample import resize
    from cfun_tpu_torch.inference import Detector
    from cfun_tpu_torch.utils import checkpoint
    from cfun_tpu_torch.utils.metrics import per_class_dice

    cfg = port_config.lits_inference_config("finetune")
    n = len(held)
    cache, one = os.path.join(tmp, "cache"), os.path.join(tmp, "cache_0")
    for root in (cache, one):
        for sub in ("image_np", "label_np"):
            os.makedirs(os.path.join(root, sub))
    for sub in ("image_test_np", "imagesTs"):
        os.makedirs(os.path.join(cache, sub))
    t0 = time.perf_counter()
    for i, (vol, lab) in enumerate(held):
        np.save(os.path.join(cache, "image_np", f"liver_{i}.npy"),
                vol.astype(np.float32))
        np.save(os.path.join(cache, "label_np", f"liver_label_{i}.npy"),
                lab.astype(np.int8))
    for sub, name in (("image_np", "liver_0.npy"),
                      ("label_np", "liver_label_0.npy")):
        os.symlink(os.path.join(cache, sub, name),
                   os.path.join(one, sub, name))
    read_bytes = dir_bytes(cache)
    print(f"cli_lits: wrote the {n} held-out volumes and labels as the "
          f"preprocessed cache ({read_bytes} B) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    wpath = os.path.join(ROOT, "weights", "lits_synth.npz")
    common = ["--weights", wpath, "--stage", "finetune"]
    by_path, stats = {}, {"volumes": n, "read_bytes": read_bytes}

    def run(path, argv, n_run):
        out, launches, shapes, records, plain, wall = run_cli(
            f"cli_lits {path}", lits_main.main, argv,
            os.path.join(tmp, path), counters)
        by_path[f"cli_lits_{path}"] = launches
        check(launches["sorted_nms"] == 2 * n_run and
              shapes["sorted_nms"] == {s: c * n_run for s, c
                                       in k1_per_request.items()},
              f"cli_lits {path}: K1 twice a volume at the served shapes "
              f"{k1_per_request}: {launches} {shapes}")
        check(launches["fused_conv3d"] == 0, "the dense U-Net: no K2")
        check(plain == [], f"cli_lits {path}: no plain NMS call ({plain})")
        stats[f"{path}_s"] = wall
        return out, records

    (box_ious, ious), records = run("test", [
        "test", *common, "--data", cache, "--limit", "0", "--save",
        "true"], n)
    vols = cli_volumes(records)
    # run_test skips a volume whose detection raised: count what it scored
    check(len(ious) == n and len(vols) == n,
          f"cli_lits test: {len(ious)} volumes scored, {len(vols)} detected"
          f", of {n}")
    print_cli_volumes("cli_lits test", vols)
    out_dir = os.path.join(tmp, "test", "results", "lits")
    stats.update(test_volumes_ms=vols, test_written_bytes=dir_bytes(out_dir),
                 box_ious=[float(v) for v in box_ious])

    params, _ = checkpoint.load_any(wpath, cfg,
                                    weights.init_params(cfg, seed=0))
    det = Detector(cfg, params)
    files = {name.split("_", 1)[1]: name for name in os.listdir(out_dir)}
    check(sorted(files) == [f"liver_{i}.nii.gz" for i in range(n)],
          f"cli_lits test: one export a volume: {sorted(files)}")
    masks, file_dice = [], []
    for i, (vol, lab) in enumerate(held):
        saved, _ = nifti.load(os.path.join(out_dir,
                                           files[f"liver_{i}.nii.gz"]))
        res = det.detect(vol)
        check(saved.dtype == np.uint8 and np.array_equal(saved, res["mask"]),
              f"cli_lits: the export of liver_{i} is Detector.detect's mask")
        file_dice.append(per_class_dice(lab, saved, cfg.num_classes))
        masks.append(saved)
    det.close()
    del det
    dice = np.array(file_dice).mean(axis=0)
    print(f"cli_lits test: Dice (liver, tumour) per volume "
          f"{np.round(file_dice, 4).tolist()}, mean {dice.tolist()}; box "
          f"IoUs {box_ious}", flush=True)
    check(dice[0] >= 0.95 and dice[1] >= 0.93,
          f"cli_lits: mean Dice liver >= 0.95 and tumour >= 0.93: {dice}")
    stats["dice"] = dice.tolist()
    # the parts of one export's save as nifti.save does them on the CLI's
    # C-ordered uint8 mask: the copy that lays the volume out x-fastest,
    # gzip at level 1, the write
    mask = np.ascontiguousarray(masks[0])
    t0 = time.perf_counter()
    payload = mask.transpose(2, 1, 0).tobytes()
    t1 = time.perf_counter()
    packed = gzip.compress(payload, compresslevel=1)
    t2 = time.perf_counter()
    with open(os.path.join(tmp, "save_probe.gz"), "wb") as f:
        f.write(packed)
    t3 = time.perf_counter()
    stats["save_parts_ms"] = {"x_fastest_copy": (t1 - t0) * 1e3,
                              "gzip_level_1": (t2 - t1) * 1e3,
                              "write": (t3 - t2) * 1e3,
                              "raw_bytes": len(payload),
                              "gzip_bytes": len(packed)}
    print(f"cli_lits save parts of one export: {stats['save_parts_ms']}",
          flush=True)

    # submit: one test volume whose raw scan has the LiTS scans' in-plane
    # size and another depth and spacing
    raw_shape = (512, 512, 128)
    np.save(os.path.join(cache, "image_test_np", "liver_0.npy"),
            held[0][0].astype(np.float32))
    raw_path = os.path.join(cache, "imagesTs", "test-volume-0.nii.gz")
    nifti.save(raw_path, resize(held[0][0], raw_shape, order=0)
               .astype(np.int16), np.diag([0.7, 0.7, 2.5, 1.0]))
    _, raw_affine = nifti.load(raw_path)
    per_volume, records = run("submit", ["submit", *common, "--data",
                                         cache], 1)
    sub_path = os.path.join(tmp, "submit", "results", "submissions",
                            "test-segmentation-0.nii")
    got, affine = nifti.load(sub_path)
    check(got.shape == raw_shape and np.array_equal(affine, raw_affine),
          f"cli_lits submit: the raw geometry {got.shape}")
    check(np.array_equal(got, resize(masks[0], raw_shape, order=0)),
          "cli_lits submit: the test mask resized to the raw geometry")
    stats.update(submit_s_per_volume=per_volume,
                 submit_load_ms=[(e - s) * 1e3 for st, s, e, _ in records
                                 if st == "load"],
                 submit_save_ms=[(e - s) * 1e3 for st, s, e, _ in records
                                 if st == "save"],
                 submit_written_bytes=os.path.getsize(sub_path))
    print(f"cli_lits submit: {per_volume:.3f} s/volume; "
          f"test-segmentation-0.nii {got.shape} restored", flush=True)

    (_, exact_ious), records = run("exact", [
        "test", *common, "--data", one, "--limit", "0", "--save", "true",
        "--exact"], 1)
    check(len(exact_ious) == 1, "cli_lits exact: liver_0 scored")
    evols = cli_volumes(records)
    print_cli_volumes("cli_lits exact", evols)
    edir = os.path.join(tmp, "exact", "results", "lits")
    saved, _ = nifti.load(os.path.join(edir, os.listdir(edir)[0]))
    exact_dice = per_class_dice(held[0][1], saved, cfg.num_classes)
    agree = float((saved == masks[0]).mean())
    print(f"cli_lits exact: liver_0 Dice (liver, tumour) "
          f"{exact_dice.tolist()} against the fast path's "
          f"{file_dice[0].tolist()}; labels agree {agree:.6f}", flush=True)
    stats.update(exact_volumes_ms=evols, exact_dice=exact_dice.tolist(),
                 exact_fast_dice=file_dice[0].tolist(),
                 exact_label_agree=agree)
    return by_path, stats


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr, flush=True)
        return 2
    args = sys.argv[1:]
    if len(args) > 1 or (args and args[0] not in CHECKPOINTS):
        print(f"usage: chip_smoke.py [{' | '.join(CHECKPOINTS)}]",
              file=sys.stderr, flush=True)
        return 2
    families = tuple(args) if args else tuple(CHECKPOINTS)
    heart, lits = "heart" in families, "lits" in families
    missing = [p for f in families for p in CHECKPOINTS[f]
               if not os.path.isfile(os.path.join(ROOT, p))]
    if missing:
        print(f"chip_smoke: missing checkpoint(s) {missing} for "
              f"{'/'.join(families)}", file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from cfun_tpu_torch import _build
    from cfun_tpu_torch import config as port_config
    from cfun_tpu_torch import native
    from cfun_tpu_torch import weights
    from cfun_tpu_torch.inference import Detector
    from cfun_tpu_torch.models import cfun
    from cfun_tpu_torch.models.unet3d import apply_unet, apply_unet_fused
    from cfun_tpu_torch.ops import fused_conv as k2
    from cfun_tpu_torch.ops import sorted_nms as k1

    counters = {"sorted_nms": k1, "fused_conv3d": k2}
    dev = torch.device("cuda", 0)
    # by path: {kernel: launches}, request timings, device busy, peak bytes
    launches_by_path, request_ms, busy, peak = {}, {}, {}, {}
    # by family: the CLI runs' per-volume stages, bytes, Dice
    cli_stats = {}
    detectors = []

    with phase("env"):
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}"
              f"; families {'/'.join(families)}", flush=True)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        card = smi.splitlines()[0].strip()
        print(f"card {torch.cuda.get_device_name(0)} "
              f"(nvidia-smi: {card})", flush=True)

    with phase("build"):
        with ThreadPoolExecutor(max_workers=2) as ex:
            host_built = ex.submit(native.library)
            lib = _build.library()
            host_lib = host_built.result()
        print(f"kernels {os.path.relpath(lib._name, ROOT)} built in "
              f"{_build.last_build_seconds:.3f} s from "
              f"{len(_build.sources())} source(s)", flush=True)
        threads = {"openmp": native.num_threads(), "cpus": os.cpu_count(),
                   "torch": torch.get_num_threads()}
        print(f"host ops {os.path.relpath(host_lib._name, ROOT)} built in "
              f"{_build.last_host_build_seconds:.3f} s with g++ "
              f"{' '.join(_build.GXX_FLAGS)}; threads: OpenMP "
              f"{threads['openmp']}, os.cpu_count() {threads['cpus']}, "
              f"torch.get_num_threads() {threads['torch']}", flush=True)
        ptxas = ptxas_summary(_build.last_build_log)
        for k in ptxas:
            print(f"ptxas {k['kernel']}: {k['registers']} registers, "
                  f"{k['static_smem_bytes']} B static smem, "
                  f"{k['spill_stores']} B spill stores, {k['spill_loads']} "
                  f"B spill loads, {k['stack_bytes']} B stack", flush=True)

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
        k1_replay_and_streams(k1, dev)
        # the LiTS sites' sizes on seeded boxes (also with every box valid)
        k1_lits_cases = []
        for i, (n, k, thr) in enumerate(LITS_K1):
            boxes, valid = nms_random(n, 20 + i, dev)
            for tag, v in (("someinvalid", valid),
                           ("allvalid", torch.ones_like(valid))):
                rec = k1_time(k1, boxes, v, thr, k, f"lits-size {tag}")
                rec["device_ms"], rec["kernel_ms"] = kernel_device_ms(
                    lambda: k1.sorted_nms(boxes, v, thr, k), K1_KERNELS)
                print(f"k1 lits-size {tag} N={n} k={k}: device "
                      f"{rec['device_ms']:.4f} ms (graph replay), "
                      f"{rec['kernel_ms']:.4f} ms (profiler, kernel alone)",
                      flush=True)
                k1_lits_cases.append(rec)

    with phase("k2"):
        for i, (b, ci, co, d, h, w, pre) in enumerate(K2_EDGE):
            k2_check(k2, k2_inputs(b, ci, co, d, h, w, 100 + i, dev), pre,
                     f"edge B={b} {ci}->{co} {d}x{h}x{w} pre_lrelu={pre}")
        print(f"k2 within tolerance and deterministic on {len(K2_EDGE)} "
              f"edge cases", flush=True)

    if heart:
        with phase("serve"):
            cfg = port_config.heart_inference_config("beginning",
                                                     nms_backend="pallas")
            wpath = os.path.join(ROOT, "weights", "heart_synth.npz")
            params, meta = weights.load_npz(wpath, cfg)
            print(f"weights {os.path.relpath(wpath, ROOT)} "
                  f"tag={meta.get('tag')} stage={meta.get('stage')}",
                  flush=True)
            det = Detector(cfg, params)
            detectors.append(det)
            check(det._pipelined and
                  len(det._slab_ranges()) == cfg.wire_slabs,
                  "the served mold is the native slab pipeline")
            vols = [synth_heart(seed) for seed in range(3)]
            (results, served, served_shapes, n_found, request_ms["serve"],
             peak["serve"]) = serve_requests(det, vols, counters, "serve")
            launches_by_path["serve"] = served
            check(served["sorted_nms"] == 6,
                  "two sorted_nms launches per request")
            check(served["fused_conv3d"] == 0,
                  "the dense U-Net launches no K2")
            check(n_found >= 1,
                  "the trained model detects the synthetic heart")

            # the same card and weights with the NumPy mold and unmold
            ndet = Detector(cfg, det.params, native=False)
            nres = ndet.detect(vols[0])
            numpy_t = dict(ndet.last_timings)
            print(f"serve native=False request 0: "
                  f"{request_line(numpy_t, ndet.last_sub_timings, ndet.last_wire_bytes)}"
                  f"; rois {nres['rois'].tolist()} (native "
                  f"{results[0]['rois'].tolist()})", flush=True)
            # its int8 affine comes from the molded volume's exact stats,
            # not from a sample of the raw one: the wires differ by a step
            # here and there, and the box may move by a voxel
            check(nres["rois"].shape == results[0]["rois"].shape and
                  np.abs(nres["rois"] - results[0]["rois"]).max(initial=0)
                  <= 1, "the NumPy mold gives the native mold's detection")
            del ndet
            kern, seen = k1_at_served_sites(
                k1, cfun, det, vols[0], served_shapes["sorted_nms"], 3,
                "serve")

        with phase("serve_fused"):
            fcfg = port_config.heart_inference_config(
                "beginning", nms_backend="pallas", pallas_unet=True)
            fdet = Detector(fcfg, params)
            detectors.append(fdet)
            (fresults, fused_launches, fused_shapes, _,
             request_ms["serve_fused"], peak["serve_fused"]) = \
                serve_requests(fdet, vols, counters, "serve_fused")
            launches_by_path["serve_fused"] = fused_launches
            check(fused_launches["fused_conv3d"] == 36,
                  f"12 K2 launches a request, got {fused_launches}")
            k2_record = fused_shapes["fused_conv3d"]
            check(sum(k2_record.values()) == fused_launches["fused_conv3d"],
                  f"K2's shape record {k2_record} adds up to its launches")
            check({s: n / 3 for s, n in k2_record.items()} == K2_SERVED,
                  f"K2 launches a request by (B, C_in, C_out, D, H, W): "
                  f"recorded {k2_record} over 3 requests, want {K2_SERVED}")
            check(fused_launches["sorted_nms"] == 6,
                  f"two K1 launches a request, got {fused_launches}")
            for i, (rd, rf) in enumerate(zip(results, fresults)):
                check(np.array_equal(rd["rois"], rf["rois"]) and
                      np.array_equal(rd["scores"], rf["scores"]),
                      f"serve_fused {i}: detections {rf['rois'].tolist()} "
                      f"{rf['scores'].tolist()} vs dense "
                      f"{rd['rois'].tolist()} {rd['scores'].tolist()}")
            agree_fd = [float((rd["mask"] == rf["mask"]).mean())
                        for rd, rf in zip(results, fresults)]
            print(f"serve_fused: same detections as serve; label agreement "
                  f"with the dense path {agree_fd}", flush=True)
            crop = capture_crop(cfun, fdet, vols[0])
            crit_fused = unet_criterion(apply_unet, apply_unet_fused,
                                        fdet.params["mask"]["unet"], crop,
                                        "beginning")

        with phase("serve_ft"):
            tcfg_ft = port_config.heart_inference_config(
                "finetune", nms_backend="pallas", pallas_unet=True)
            wpath_ft = os.path.join(ROOT, "weights", "heart_synth_ft.npz")
            params_ft, meta_ft = weights.load_npz(wpath_ft, tcfg_ft)
            print(f"weights {os.path.relpath(wpath_ft, ROOT)} "
                  f"tag={meta_ft.get('tag')} stage={meta_ft.get('stage')}",
                  flush=True)
            check(meta_ft.get("stage") == "finetune", "finetune checkpoint")
            ftdet = Detector(tcfg_ft, params_ft)
            detectors.append(ftdet)
            check(ftdet.labels_shape == (1, 192, 192, 192),
                  f"finetune labels shape {ftdet.labels_shape}")
            (_, ft_launches, ft_shapes, _, request_ms["serve_ft"],
             peak["serve_ft"]) = serve_requests(ftdet, vols, counters,
                                                "serve_ft")
            launches_by_path["serve_ft"] = ft_launches
            check(ft_launches["fused_conv3d"] == 36,
                  f"12 K2 launches a request, got {ft_launches}")
            check(ft_shapes["fused_conv3d"] == k2_record,
                  f"finetune K2 shapes {ft_shapes['fused_conv3d']} are the "
                  f"fused 'beginning' path's {k2_record}")
            check(ft_launches["sorted_nms"] == 6,
                  f"two K1 launches a request, got {ft_launches}")
            wire, window, _ = ftdet.mold(vols[0])
            buf = ftdet.infer(wire, window).cpu().numpy()
            _, _, labels = cfun.unpack_fast_output(
                buf, tcfg_ft.detection_max_instances, ftdet.labels_shape)
            check(labels.shape == (1, 192, 192, 192) and labels.min() >= 0
                  and labels.max() < tcfg_ft.num_classes,
                  f"finetune label volume {labels.shape}")
            crop = capture_crop(cfun, ftdet, vols[0])
            crit_ft = unet_criterion(apply_unet, apply_unet_fused,
                                     ftdet.params["mask"]["unet"], crop,
                                     "finetune")
            crit_phase = head_check(apply_unet,
                                    ftdet.params["mask"]["unet"], crop)
            del crop

        with phase("cli_heart"):
            tmp = tempfile.mkdtemp(prefix="cfun_cli_heart_")
            try:
                cli_launches, cli_stats["heart"] = cli_heart_phase(
                    tmp, counters, {s: c // 3 for s, c in
                                    served_shapes["sorted_nms"].items()})
            finally:
                shutil.rmtree(tmp)
            launches_by_path.update(cli_launches)

    if lits:
        with phase("serve_lits"):
            lcfg = port_config.lits_inference_config("finetune")
            lpath = os.path.join(ROOT, "weights", "lits_synth.npz")
            lparams, lmeta = weights.load_npz(lpath, lcfg)
            print(f"weights {os.path.relpath(lpath, ROOT)} "
                  f"tag={lmeta.get('tag')} stage={lmeta.get('stage')}",
                  flush=True)
            check(lmeta.get("stage") == "finetune", "finetune checkpoint")
            ldet = Detector(lcfg, lparams)
            detectors.append(ldet)
            check(ldet._pipelined_lits and
                  len(ldet._slab_ranges()) == lcfg.wire_slabs,
                  "the served LiTS mold is the native slab pipeline")
            check(ldet.labels_shape == lcfg.image_shape and
                  ldet.pack_bits == 2, "LiTS: one molded label volume on "
                  "the 2-bit wire")
            t0 = time.perf_counter()
            held = synthetic_lits(3, 90)
            big = synthetic_lits(1, 93, (512, 512, 400))[0][0]
            print(f"serve_lits: made the 3 held-out 400x400x280 volumes "
                  f"(seed 90) and one 512x512x400 in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            lvols = [v for v, _ in held] + [big]
            nl = len(lvols)
            (lresults, llaunch, lshapes, _, request_ms["serve_lits"],
             peak["serve_lits"]) = serve_requests(ldet, lvols, counters,
                                                  "serve_lits")
            launches_by_path["serve_lits"] = llaunch
            check(llaunch["sorted_nms"] == 2 * nl,
                  f"two K1 launches a request, got {llaunch}")
            check(llaunch["fused_conv3d"] == 0,
                  "the dense U-Net launches no K2")
            for i, r in enumerate(lresults):
                check(set(np.unique(r["mask"]).tolist()) <= {0, 1, 2},
                      f"serve_lits {i}: labels within {{0, 1, 2}}")
                check(len(r["scores"]) >= 1 or i == nl - 1,
                      f"serve_lits {i}: a detection on each held-out volume")
            wire_up = ldet.last_wire_bytes
            check(wire_up == {"up": 256 * 320 * 320,
                              "down": 10 * 33 + 256 * 320 * 320 // 4},
                  f"LiTS wire bytes {wire_up}")
            dice = np.array([per_class_dice(lab, r["mask"], 3)
                             for (_, lab), r in zip(held, lresults)])
            lits_dice = [float(v) for v in dice.mean(axis=0)]
            print(f"serve_lits Dice (liver, tumour) per held-out volume "
                  f"{dice.tolist()}; mean {lits_dice}; the JAX package's "
                  f"recorded {list(LITS_JAX_DICE)}", flush=True)
            check(lits_dice[0] >= 0.95 and lits_dice[1] >= 0.93,
                  f"mean Dice liver >= 0.95 and tumour >= 0.93: "
                  f"{lits_dice}")

            ndet = Detector(lcfg, ldet.params, native=False)
            nres = ndet.detect(held[0][0])
            lnumpy_t = dict(ndet.last_timings)
            print(f"serve_lits native=False request 0: "
                  f"{request_line(lnumpy_t, ndet.last_sub_timings, ndet.last_wire_bytes)}"
                  f"; rois {nres['rois'].tolist()} (native "
                  f"{lresults[0]['rois'].tolist()})", flush=True)
            check(nres["rois"].shape == lresults[0]["rois"].shape and
                  np.abs(nres["rois"] - lresults[0]["rois"]).max(initial=0)
                  <= 1, "the NumPy LiTS mold gives the native mold's "
                  "detections")
            lnumpy_agree = float((nres["mask"] == lresults[0]["mask"]).mean())
            print(f"serve_lits native=False labels agree {lnumpy_agree}",
                  flush=True)
            del ndet
            lkern, lseen = k1_at_served_sites(
                k1, cfun, ldet, held[0][0], lshapes["sorted_nms"], nl,
                "serve_lits")
            check(sorted((s["shape"] for s in lkern)) ==
                  sorted(f"{n}->{k}@{t}" for n, k, t in LITS_K1),
                  f"the LiTS NMS sites {[s['shape'] for s in lkern]}")

        with phase("serve_lits_fused"):
            lfcfg = port_config.lits_inference_config("finetune",
                                                      pallas_unet=True)
            lfdet = Detector(lfcfg, ldet.params)
            detectors.append(lfdet)
            (lfresults, lflaunch, lfshapes, _,
             request_ms["serve_lits_fused"], peak["serve_lits_fused"]) = \
                serve_requests(lfdet, lvols, counters, "serve_lits_fused")
            launches_by_path["serve_lits_fused"] = lflaunch
            check(lflaunch["fused_conv3d"] == 8 * nl,
                  f"8 K2 launches a request, got {lflaunch}")
            lk2_record = lfshapes["fused_conv3d"]
            check({s: n / nl for s, n in lk2_record.items()} ==
                  K2_SERVED_LITS,
                  f"LiTS K2 launches a request by (B, C_in, C_out, D, H, "
                  f"W): recorded {lk2_record} over {nl} requests, want "
                  f"{K2_SERVED_LITS}")
            check(lflaunch["sorted_nms"] == 2 * nl,
                  f"two K1 launches a request, got {lflaunch}")
            for i, (rd, rf) in enumerate(zip(lresults, lfresults)):
                check(np.array_equal(rd["rois"], rf["rois"]) and
                      np.array_equal(rd["scores"], rf["scores"]),
                      f"serve_lits_fused {i}: detections "
                      f"{rf['rois'].tolist()} {rf['scores'].tolist()} vs "
                      f"dense {rd['rois'].tolist()} {rd['scores'].tolist()}")
            fdice = np.array([per_class_dice(lab, r["mask"], 3)
                              for (_, lab), r in zip(held, lfresults)])
            lits_fused_dice = [float(v) for v in fdice.mean(axis=0)]
            agree_lf = [float((rd["mask"] == rf["mask"]).mean())
                        for rd, rf in zip(lresults, lfresults)]
            print(f"serve_lits_fused: same detections as serve_lits; label "
                  f"agreement with the dense path {agree_lf}; mean Dice "
                  f"{lits_fused_dice}", flush=True)
            crop = capture_crop(cfun, lfdet, held[0][0])
            check(tuple(crop.shape) == (10, 1, 32, 80, 80),
                  f"LiTS crops {tuple(crop.shape)}")
            crit_lits = unet_criterion(apply_unet, apply_unet_fused,
                                       lfdet.params["mask"]["unet"], crop,
                                       "finetune")
            del crop

        with phase("cli_lits"):
            tmp = tempfile.mkdtemp(prefix="cfun_cli_lits_")
            try:
                cli_launches, cli_stats["lits"] = cli_lits_phase(
                    tmp, counters, {s: c // nl for s, c in
                                    lshapes["sorted_nms"].items()}, held)
            finally:
                shutil.rmtree(tmp)
            launches_by_path.update(cli_launches)

    with phase("stream"):
        n_sync, sync_msgs, stream_stats = None, [], None
        if heart:
            svols = [synth_heart(seed) for seed in range(4)]
            torch.cuda.synchronize()
            with stage_timeline(det) as serial_records:
                t0 = time.perf_counter()
                serial = [det.detect(v) for v in svols]
                serial_ms = (time.perf_counter() - t0) * 1e3
            reset_counts(counters)
            with stage_timeline(det) as stream_records:
                t0 = time.perf_counter()
                streamed = list(det.detect_stream(svols))
                stream_ms = (time.perf_counter() - t0) * 1e3
            stream_launches = {name: mod.launches
                               for name, mod in counters.items()}
            launches_by_path["stream"] = stream_launches
            print_timeline("serial", serial_records)
            print_timeline("stream", stream_records)
            check(len(streamed) == len(serial), "stream: one result a volume")
            for i, (a, b) in enumerate(zip(streamed, serial)):
                check(np.array_equal(a["mask"], b["mask"]) and
                      np.array_equal(a["rois"], b["rois"]) and
                      np.array_equal(a["scores"], b["scores"]),
                      f"stream result {i} equals serial detect")
            check(stream_launches["sorted_nms"] == 2 * len(svols),
                  f"two K1 launches a volume in the stream: "
                  f"{stream_launches}")
            n_sync, sync_msgs = sync_count(det, svols[0])
            # the pipeline's period once full: the ms between the first and
            # the last result over the results in between
            done = sorted(end for name, _, _, end in stream_records
                          if name == "finish")
            period_ms = (done[-1] - done[0]) / (len(done) - 1)
            print(f"stream: {len(svols)} volumes equal serial detect; "
                  f"{stream_ms / len(svols):.3f} ms a volume sustained "
                  f"({stream_ms:.3f} ms in all; {period_ms:.3f} ms between "
                  f"results) against {serial_ms / len(svols):.3f} ms a "
                  f"volume serial ({serial_ms:.3f} ms); launches "
                  f"{stream_launches}", flush=True)
            print(f"stream: one request's mold + dispatch made {n_sync} "
                  f"synchronizing CUDA call(s) {sync_msgs}", flush=True)
            stream_stats = {
                "volumes": len(svols),
                "sustained_ms_per_volume": stream_ms / len(svols),
                "serial_ms_per_volume": serial_ms / len(svols),
                "ms_between_results": period_ms,
                "sync_calls_per_request": n_sync,
                "sync_messages": sync_msgs}
        if lits:
            n_sync_lits, sync_msgs_lits = sync_count(ldet, held[1][0])
            print(f"stream: one LiTS request's mold + dispatch made "
                  f"{n_sync_lits} synchronizing CUDA call(s) "
                  f"{sync_msgs_lits}", flush=True)

    with phase("k2_served"):
        k2_paths = {}
        if heart:
            k2_paths["serve_fused"] = [
                k2_time(k2, shape, n_rec, 3, 200 + i, dev)
                for i, (shape, n_rec) in enumerate(sorted(k2_record.items()))]
        if lits:
            k2_paths["serve_lits_fused"] = [
                k2_time(k2, shape, n_rec, nl, 300 + i, dev)
                for i, (shape, n_rec) in enumerate(sorted(lk2_record.items()))]
        k2_req = {path: k2_request(shapes, path)
                  for path, shapes in k2_paths.items()}

    with phase("profile"):
        h2d, paste = {}, None
        if heart:
            busy["serve"], dense_kernels = profile_requests(det, vols,
                                                            "serve")
            h2d["serve"] = {name: ms for name, ms in dense_kernels.items()
                            if "memcpy htod" in name.lower()}
            busy["serve_fused"], by_kernel = profile_requests(
                fdet, vols, "serve_fused")
            busy["serve_ft"], _ = profile_requests(ftdet, vols, "serve_ft")
            k2_busy = sum(ms for name, ms in by_kernel.items()
                          if any(k in name for k in K2_KERNELS))
            print(f"profile: K2 {k2_busy:.3f} ms of "
                  f"{busy['serve_fused']:.3f} ms device busy a fused request "
                  f"(dense request {busy['serve']:.3f} ms, fused finetune "
                  f"request {busy['serve_ft']:.3f} ms)", flush=True)
            for site, (boxes, valid, thr, k) in zip(kern, seen):
                site["device_ms"], site["kernel_ms"] = kernel_device_ms(
                    lambda: k1.sorted_nms(boxes, valid, thr, k), K1_KERNELS)
                print(f"profile: k1 serve N={boxes.shape[0]} k={k} "
                      f"thr={thr}: device {site['device_ms']:.4f} ms (graph "
                      f"replay), {site['kernel_ms']:.4f} ms (profiler, "
                      f"kernel alone)", flush=True)
        if lits:
            hvols = [v for v, _ in held]
            busy["serve_lits"], lits_kernels = profile_requests(
                ldet, hvols, "serve_lits")
            h2d["serve_lits"] = {name: ms for name, ms in lits_kernels.items()
                                 if "memcpy htod" in name.lower()}
            busy["serve_lits_fused"], lf_kernels = profile_requests(
                lfdet, hvols, "serve_lits_fused")
            lk2_busy = sum(ms for name, ms in lf_kernels.items()
                           if any(k in name for k in K2_KERNELS))
            print(f"profile: K2 {lk2_busy:.3f} ms of "
                  f"{busy['serve_lits_fused']:.3f} ms device busy a fused "
                  f"LiTS request (dense LiTS request "
                  f"{busy['serve_lits']:.3f} ms)", flush=True)
            paste = paste_profile(cfun, ldet, held[0][0])
            for site, (boxes, valid, thr, k) in zip(lkern, lseen):
                site["device_ms"], site["kernel_ms"] = kernel_device_ms(
                    lambda: k1.sorted_nms(boxes, valid, thr, k), K1_KERNELS)
                print(f"profile: k1 serve_lits N={boxes.shape[0]} k={k} "
                      f"thr={thr}: device {site['device_ms']:.4f} ms (graph "
                      f"replay), {site['kernel_ms']:.4f} ms (profiler, "
                      f"kernel alone)", flush=True)
        for path, pinned in h2d.items():
            check(any("pinned" in name.lower() for name in pinned),
                  f"{path}: the wire uploads from page-locked memory: "
                  f"{pinned}")

    with phase("small"):
        # full float32 on the card (cuDNN convs default to TF32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        small_cfgs = []
        if heart:
            small_cfgs.append(("tiny heart", port_config.tiny_config(
                detection_max_instances=1, wire_image_dtype="int8",
                fast_unmold=True, device_normalize=True)))
        if lits:
            small_cfgs.append(("tiny LiTS", port_config.tiny_config().replace(
                name="lits", num_classes=3, backbone="P3D35",
                backbone_stem_kernel=(5, 7, 7), intensity_norm="hu_window",
                pad_shape=(64, 128, 128), mask_shape_override=(16, 16, 16),
                mask_pool_size=(16, 16, 16), unet_dropout_rate=0.0,
                detection_max_instances=3, wire_image_dtype="int8",
                wire_int8_scale=127.0, fast_unmold=True)))
        small_agree = {}
        for name, tcfg in small_cfgs:
            tparams = weights.init_params(tcfg, seed=0)
            # a confident FG class, so the small graph has detections
            tparams["classifier"]["cls"]["b"] = torch.tensor([0.0, 3.0])
            d, h, w = tcfg.image_shape
            if tcfg.name == "lits":
                vol = synthetic_lits(1, 7, (100, 110, 50))[0][0]
            else:
                vol = synth_heart(7, (h + 16, w, d + 8))
            r_gpu = Detector(tcfg, tparams).detect(vol)
            r_cpu = Detector(tcfg, tparams, device="cpu").detect(vol)
            check(len(r_cpu["scores"]) >= 1, f"small {name}: a detection")
            check(r_gpu["rois"].shape == r_cpu["rois"].shape,
                  f"small {name}: detection count")
            check(np.abs(r_gpu["rois"] - r_cpu["rois"]).max(initial=0) <= 1,
                  f"small {name}: boxes {r_gpu['rois'].tolist()} vs "
                  f"{r_cpu['rois'].tolist()}")
            check(np.allclose(r_gpu["scores"], r_cpu["scores"], atol=1e-4),
                  f"small {name}: scores")
            agree = float((r_gpu["mask"] == r_cpu["mask"]).mean())
            check(agree >= 0.99, f"small {name}: labels agree {agree}")
            small_agree[name] = agree
            print(f"small {name} config: card vs CPU rois "
                  f"{r_gpu['rois'].tolist()} / {r_cpu['rois'].tolist()}, "
                  f"labels agree {agree}", flush=True)

    for d in detectors:
        d.close()
    total = time.perf_counter() - _T0
    print(f"total {total:.3f} s", flush=True)

    # K1: every site the served paths launched it at; its request numbers
    # are the first served path's (serve, else serve_lits)
    k1_paths = {}
    if heart:
        k1_paths["serve"] = kern
    if lits:
        k1_paths["serve_lits"] = lkern
    k1_main = next(iter(k1_paths.values()))
    k1_req = k1_request(k1_main)
    k1_launch = {p: v["sorted_nms"] for p, v in launches_by_path.items()}
    k2_launch = {p: v["fused_conv3d"] for p, v in launches_by_path.items()}
    for path, n in k1_launch.items():
        check(n >= 1, f"K1 launched on {path}")
    for path in ("serve_fused", "serve_ft", "serve_lits_fused"):
        if path in k2_launch:
            check(k2_launch[path] >= 1, f"K2 launched on {path}")
    k2_main_path = "serve_fused" if heart else "serve_lits_fused"
    k2_main = k2_req[k2_main_path]
    k2_shapes = [s for shapes in k2_paths.values() for s in shapes]
    line = {"kernels": [{
        "name": "sorted_nms", "route": "cuda",
        "source": "cfun_tpu_torch/csrc/sorted_nms.cu",
        "replaces": "cfun_tpu/ops/pallas_nms.py:93",
        "shape": " + ".join(s["shape"] for s in k1_main),
        "launches": sum(k1_launch.values()),
        "max_abs_err": max(s["max_abs_err"]
                           for sites in k1_paths.values() for s in sites),
        "ms": k1_req["ms"], "device_ms": k1_req["device_ms"],
        "kernel_ms": k1_req["kernel_ms"], "plain_ms": k1_req["plain_ms"],
        "bound_ms": k1_req["bound_ms"],
        "bound_by": max(k1_main, key=lambda s: s["bound_ms"])["bound_by"],
        "library_ms": None, "exact_match": True,
        "request_of": next(iter(k1_paths)),
        "per_request_by_path": {p: k1_request(s)
                                for p, s in k1_paths.items()},
        "ptxas": [k for k in ptxas if k["kernel"].startswith(K1_KERNELS)],
        "launches_by_path": k1_launch,
        "per_shape": [s for sites in k1_paths.values() for s in sites],
        "lits_size_cases": k1_lits_cases}, {
        "name": "fused_conv3d", "route": "cuda",
        "route_note": "tensor cores (mma.sync m16n8k16 bf16, f32 "
                      "accumulation), implicit GEMM",
        "source": "cfun_tpu_torch/csrc/fused_conv3d.cu",
        "replaces": "cfun_tpu/ops/pallas_conv.py:179",
        "shape": " + ".join(f"{s['calls_per_request']:g}x {s['shape']}"
                            for s in k2_paths[k2_main_path]),
        "launches": sum(k2_launch.values()),
        "launches_by_path": k2_launch,
        "max_abs_err": max(s["max_abs_err"] for s in k2_shapes),
        "ms": k2_main["ms"], "device_ms": k2_main["device_ms"],
        "plain_ms": k2_main["plain_ms"], "bound_ms": k2_main["bound_ms"],
        "bound_by": max(k2_paths[k2_main_path], key=lambda s: s["bound_ms"]
                        * s["calls_per_request"])["bound_by"],
        "library_ms": k2_main["library_ms"],
        "tflops": k2_main["tflops"], "bound_share": k2_main["bound_share"],
        "vs_library": k2_main["vs_library"],
        "request_of": k2_main_path, "per_request_by_path": k2_req,
        "ptxas": [k for k in ptxas if k["kernel"].startswith(K2_KERNELS)],
        "library": "torch.nn.functional.conv3d in bf16 (cuDNN), the conv "
                   "alone: no PyTorch call computes the fused function",
        "unet_criterion": dict(
            **({"beginning": crit_fused, "finetune": crit_ft}
               if heart else {}),
            **({"lits_finetune": crit_lits} if lits else {})),
        "per_shape": k2_shapes}]}
    serving = {"serving": {
        "card": card, "threads": threads, "families": list(families),
        "request_ms": {label: [{k: v * 1e3 for k, v in t.items()}
                               for t in ts]
                       for label, ts in request_ms.items()},
        "device_busy_ms": busy, "peak_bytes": peak,
        "launches_by_path": launches_by_path, "h2d_ms": h2d}}
    if heart:
        serving["serving"].update(
            numpy_mold_request_ms={k: v * 1e3 for k, v in numpy_t.items()},
            stream=stream_stats, phase_forms=crit_phase)
    if lits:
        serving["serving"].update(
            lits_numpy_request_ms={k: v * 1e3 for k, v in lnumpy_t.items()},
            lits_numpy_label_agree=lnumpy_agree,
            lits_dice={"serve_lits": lits_dice,
                       "serve_lits_fused": lits_fused_dice,
                       "jax_recorded": list(LITS_JAX_DICE)},
            lits_sync_calls_per_request=n_sync_lits,
            lits_sync_messages=sync_msgs_lits,
            overlap_paste=paste, lits_wire_bytes=wire_up)
    serving["serving"]["small_label_agree"] = small_agree
    serving["serving"]["cli"] = cli_stats
    print(json.dumps(serving), flush=True)
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
