#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cfun_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # every phase, both model families
    python3 chip_smoke.py heart      # the shared phases + the heart paths
    python3 chip_smoke.py lits       # the shared phases + the LiTS paths
    python3 chip_smoke.py schedule   # env build k1, then phase schedule
    python3 chip_smoke.py schedule START.npz  # the same from a checkpoint
    python3 chip_smoke.py multicard  # env build k1, then phase multicard
                                     # (four cards)

With no argument it needs all three checkpoints (weights/heart_synth.npz,
weights/heart_synth_ft.npz, weights/lits_synth.npz); ``heart`` needs the
first two, ``lits`` the third, ``schedule`` none, ``multicard`` the
first two.  A missing checkpoint is
an error (exit 1).

Phases, each printed as ``phase <name> start`` / ``phase <name> done <s>``
(shared: env build k1 k2 train_tiny; heart: serve serve_fused serve_ft
cli_heart train_heart roofline train_loop_heart mesh_heart; LiTS:
serve_lits serve_lits_fused roofline cli_lits train_lits train_loop_lits
mesh_lits; then stream k2_served profile small, each on the families that
ran):

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
  train_tiny  one train step (cfun_tpu_torch.train.step.make_train_step)
          of the tiny config (float32, TF32 off) on the card and one on
          the CPU, from the same seeded port weights, batch and draws:
          the same proposals (K1 at 64->32 on the card, its plain version
          on the CPU), the loss parts to rtol 1e-4, every updated leaf
          within 1e-5 of its largest magnitude
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
  train_heart  training at full width (192x320x320, bf16):
          heart_config('beginning') from weights/heart_synth.npz, 6 steps,
          and heart_config('finetune') (remat U-Net, dropout 0.6, 192^3
          masks, the edge loss) from weights/heart_synth_ft.npz, 2 steps,
          on volume 0 of the cli_heart set molded the NumPy way (the bf16
          wire, 4-bit labels); per step the seconds, the six loss parts
          and the ROI sample's positives (>= 1 on every step); the checks
          of train_path (K1 once a step at 1000->500, no plain NMS, no K2,
          frozen leaves unchanged, the loss falls); the median s/step,
          max_memory_allocated and K1 at the step's NMS inputs beside its
          bound, with the card's clocks before and after
  roofline  (in each family's block) cfun_tpu_torch/utils/roofline.py on
          the served paths: heart dense, fused and finetune after
          train_heart, LiTS dense and fused after serve_lits_fused.  On
          each path the trunk (a seeded volume of the molded shape), the
          mask head (the served crops) and the whole packed request
          (packed_infer_program on a served volume): its dense form's
          GFLOP and GB by cost_of (the trunk's and the mask head's equal
          to their count on 'meta'), one eager call on a side stream,
          then 8 calls captured in one CUDA graph there (K1's and K2's
          launches in the capture the eager call's times 8, every
          replayed output bit-equal to the eager call's), and
          time_amortized: single / kernel / replay / dispatch ms, TFLOP/s,
          mfu and hbm_bw_util against the card's peaks; the dispatch
          floor; bench.py's key names for the heart dense path; the mfu of
          the isolated heart 'beginning' train step (cost_of of its
          forward and backward over train_heart's median s/step).  Phase
          profile prints each request's kernel and replay ms beside its
          device busy
  train_loop_heart  the training loop (cfun_tpu_torch/train/loop.py) on
          the card, three runs, each with every launch count set to 0
          before and read after (K1 exactly once a step and once a
          validation forward at 1000->500, its plain version and K2
          never, K1 equal to its plain version on the first and the last
          step's NMS inputs): the heart CLI's 'train --stage beginning'
          in this process from weights/heart_synth.npz for one epoch (its
          epoch 60 + 1: 45 steps through the threaded feeder and the
          native bf16 train mold, no validation) on the synthetic train
          set of benchmarks/train_synth.py (8 volumes, seed 1000) and 13
          validation volumes (seed 2000), 144x144x96, written as .nii
          with a manifest; train_model's short schedule (5 steps an
          epoch, validation every epoch): two identical 3-epoch runs (their
          spread), 2 epochs, and 1 more resumed from that checkpoint, held
          to 4x the spread; and --aug-device --device-cache for 2 epochs
          of 8 steps (no H2D byte in epoch 2, by the loop's count and the
          profiler's copies).  Each run prints s/step (median after the
          first, the first; stream time start to start), the feeder's item
          ms (load / mold / labels / RPN targets), the loop's wait on it a
          step, H2D bytes a step, busy / idle and the H2D copies' overlap
          with kernels over a profiled window of steps, the peak memory,
          the clocks; the CLI run also save / save_async ms and bytes
  train_loop_lits  the LiTS CLI's 'train --stage beginning' from
          weights/lits_synth.npz for one epoch (its epoch 6 + 1: 100
          steps) on the .npy cache of seeded 400x400x280 volumes (train
          ids 0-3, validation id 111), with train_loop_heart's checks and
          numbers
  mesh_heart  training over a mesh of ranks (cfun_tpu_torch/parallel/,
          started by parallel/launch.py as processes of their own), heart
          at full width from the checkpoints, each rank on volume 0 or 1
          of the cli_heart set: (1, 1) under NCCL from heart_synth.npz, 6
          steps, the losses and the parameters bit-equal to 6 plain steps
          in this process with the same draws; (2, 1), two ranks on
          cuda:0 under gloo (NCCL takes one card a rank), 4 steps, the
          first update equal to one process's step on the mean gradient
          of the two volumes with the same draws (losses rtol 1e-4, each
          leaf within 1e-5 of its largest magnitude); (1, 2) 'beginning'
          from heart_synth.npz and (1, 2) 'finetune' from
          heart_synth_ft.npz, each with the trunk split along H and, with
          shard_unet_spatial, the U-Net along D, in float32 (TF32 off),
          two gloo ranks on cuda:0, 2 steps, the loss parts against one
          dense step (rtol 1e-4), the all-reduced trunk and head
          gradients within 1e-4 of each leaf's largest magnitude from
          the dense step's, and the U-Net's as close to a float64
          evaluation of them on the dense step's crops as the dense
          step's (within twice its largest gap, or 1e-4, of a leaf's
          largest magnitude), the peak memory by rank beside the dense
          step's; on every path and rank
          K1 exactly once a step at 1000->500 and equal to its plain
          version on the first step's NMS inputs, its plain version and
          K2 never, the parameters the same on every rank after every
          step; each rank's s/step and gradient all-reduce ms (gloo on a
          card stages through the host: a rehearsal's time, not NCCL's);
          then the heart CLI's train --mesh N with N one more than the
          cards stops with exit code 2
  schedule  (only with the argument 'schedule') the JAX package's
          synthetic heart schedule (benchmarks/train_synth.py's defaults:
          60 epochs of 15 steps, seed 0, the bf16 wire, from seeded
          weights, or from START.npz), then the held-out evaluation of
          cli_heart's 12 volumes on the weights it wrote: the loss curve,
          Dice and box IoU beside the JAX package's recorded curve and
          0.6691 / 0.8875
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
  train_lits  lits_config('beginning') (P3D35 at 256x320x320, the trunk
          checkpointed, detection only) from weights/lits_synth.npz, 4
          steps on held-out volume 0 of serve_lits molded the NumPy way;
          as train_heart, with the mask subtree unchanged and the loss's
          descent checked on the first update (the first step's draws and
          ROI sample held)
  multicard  (only with the argument 'multicard', on four cards) the mesh
          under NCCL, one card a rank: heart 'beginning' (4, 1), 4 steps
          on held-out volumes 0-3, with mesh_heart's (2, 1) checks against
          the mean-gradient step of the four; heart 'finetune' float32
          (1, 2) across two cards with mesh_heart's (1, 2) checks
  mesh_lits  lits_config('beginning') from weights/lits_synth.npz on a
          (2, 1) mesh of two gloo ranks on cuda:0, 2 steps on held-out
          volumes 0 and 1 of serve_lits, with mesh_heart's (2, 1) checks;
          then in float32 on a (1, 2) mesh, the P3D35 trunk split along H
          and checkpointed block by block, on volume 0, with mesh_heart's
          (1, 2) checks
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

Each served phase (and 'stream', each CLI command and each train path)
sets every kernel's launch count and its record of launch shapes to 0 just
before its requests (or steps) and reads them just after; the CLI and
train paths are in the kernels line's launches_by_path, K1's training
shape in its per_shape.  Beside each profiled window and each train path
the card's SM clock, its maximum, the temperature and the power draw are
printed (nvidia-smi).

Then a ``{"serving": ...}`` JSON line, one with the kernels, the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.  Any failed check raises and the exit
code is non-zero; without a CUDA device the script exits 2 before any
phase.  A watchdog ends a hung run after 900 s with a traceback.
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
sys.path.insert(0, ROOT)
from cfun_tpu_torch.utils.roofline import PEAKS  # noqa: E402

WATCHDOG_S = 900
H100_F32_OPS_PER_S = 67e12   # H100 SXM data sheet, f32 outside tensor cores
# dense bf16 tensor cores and HBM3: the roofline module's one table
H100_BF16_OPS_PER_S = PEAKS["h100_sxm"]["flops_bf16"]
H100_BYTES_PER_S = PEAKS["h100_sxm"]["hbm_bw"]
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
# Training paths: the steps each takes at full width, and the seed of the
# generator its draws come from, re-seeded identically on every step so
# that the objective is one fixed function of the parameters
TRAIN_STEPS = {"heart beginning": 6, "heart finetune": 2, "lits beginning": 4}
TRAIN_SEED = 17
# K1's launch shape (N, max_out) in a full-width train step: propose's
# pre_nms_limit 1000 -> post_nms_rois_training 500, IoU 0.7
K1_TRAIN_SHAPE = (1000, 500)
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
    print_clocks(f"profile {label} before")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for vol in vols:
            det.detect(vol)
        torch.cuda.synchronize()
    print_clocks(f"profile {label} after")
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


def print_clocks(label):
    """The card's clock state beside a measured window: nvidia-smi's SM
    clock, its maximum, the temperature and the power draw."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
         "temperature.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    clocks = out.strip().splitlines()[0].strip()
    print(f"clocks {label}: {clocks} (clocks.sm, clocks.max.sm, "
          f"temperature.gpu, power.draw)", flush=True)
    return clocks


def train_batch(cfg, molded, labels, device, seed=0):
    """A TrainBatch on ``device`` built as the JAX package's feeder builds
    one at angle 0 (cfun_tpu/data/feeder.py:346-378): the GT box from the
    molded labels (np_mask_to_extended_bbox), the RPN targets
    (build_rpn_targets on config_anchors, NumPy generator ``seed``), the
    image in the compute dtype (the bf16 wire), the labels packed two a
    byte along W.  molded / labels: [D, H, W]."""
    import numpy as np
    import torch

    from cfun_tpu_torch.data.feeder import np_mask_to_extended_bbox
    from cfun_tpu_torch.models.cfun import compute_dtype
    from cfun_tpu_torch.ops.anchors import config_anchors
    from cfun_tpu_torch.train.step import TrainBatch, pack_labels_w
    from cfun_tpu_torch.train.targets import build_rpn_targets

    gt_box = np_mask_to_extended_bbox(labels)
    match, deltas = build_rpn_targets(config_anchors(cfg), gt_box, cfg,
                                      np.random.default_rng(seed))
    d, h, w = cfg.image_shape
    norm = np.array([d, h, w, d, h, w], np.float32)
    packed = pack_labels_w(labels) if cfg.num_classes <= 16 and w % 2 == 0 \
        else labels.astype(np.int8)
    image = torch.from_numpy(np.ascontiguousarray(molded, np.float32))
    return TrainBatch(
        image=image[None, None].to(compute_dtype(cfg)),
        rpn_match=torch.from_numpy(match),
        rpn_deltas=torch.from_numpy(deltas),
        gt_box_norm=torch.from_numpy(gt_box / norm),
        labels=torch.from_numpy(np.ascontiguousarray(packed))).to(device)


def heart_train_batch(cfg, device, index=0):
    """Volume ``index`` of the held-out heart set the cli_heart phase
    serves (SyntheticDataset(**HEART_EVAL)), molded the NumPy way: the
    port's trilinear mold and z-score, the labels by resize(order=0)."""
    import numpy as np

    from cfun_tpu_torch.data.datasets import SyntheticDataset
    from cfun_tpu_torch.data.mold import mold_volume, normalize_intensity
    from cfun_tpu_torch.data.resample import resize

    held = SyntheticDataset(cfg, **HEART_EVAL)
    molded, _ = mold_volume(held.load_image(index), cfg)
    d, h, w = cfg.image_shape
    labels = np.rint(resize(held.load_mask(index), (h, w, d),
                            order=0)).astype(
        np.int32).transpose(2, 0, 1)
    return train_batch(cfg, normalize_intensity(molded, cfg), labels, device)


def lits_train_batch(cfg, vol, mask, device):
    """One held-out LiTS volume molded the NumPy way: the port's LiTS
    mold (HU window, virtual centre-pad, nearest), the labels by
    pad_resize_nearest with the same offsets (feeder.py:101-117)."""
    import numpy as np

    from cfun_tpu_torch.data.mold import mold_volume, pad_offsets
    from cfun_tpu_torch.data.resample import pad_resize_nearest

    molded, _ = mold_volume(vol, cfg)
    pd, ph, pw = cfg.pad_shape
    d, h, w = cfg.image_shape
    labels = pad_resize_nearest(mask.astype(np.int32), (ph, pw, pd),
                                (h, w, d), pad_offsets(vol.shape,
                                                       cfg.pad_shape))
    return train_batch(cfg, molded, labels.transpose(2, 0, 1), device)


def _move_draws(draws, device):
    from cfun_tpu_torch.train.step import TrainDraws
    from cfun_tpu_torch.train.targets import TargetDraws

    return TrainDraws(
        TargetDraws(*(t.to(device) for t in draws.targets)),
        None if draws.dropout_masks is None
        else [m.to(device) for m in draws.dropout_masks])


def train_path(label, cfg, params, batch, n_steps, counters, k1,
               falls_by_last=True):
    """``n_steps`` train steps (``make_train_step``) at full width on the
    batch's device, the draws re-seeded identically each step.  Every
    kernel's launch count and shape record is set to 0 just before the
    steps and read just after; K1's plain version is counted too (it must
    not run).  Checks: the six loss parts finite, those stage_flags turns
    off exactly 0; K1 once a step at K1_TRAIN_SHAPE, K2 never; each step's
    NMS inputs give K1's idx / keep through the plain version; the frozen
    leaves (BN statistics, the stage-frozen subtrees) bit-unchanged; the
    first update lowers the first step's objective (its draws and its ROI
    sample held: one fixed function of the parameters); with
    ``falls_by_last``, the loss after the last update below the first
    step's too.  Then K1 timed at the first step's NMS inputs.  Returns
    the path's record."""
    import numpy as np
    import torch

    from cfun_tpu_torch import weights
    from cfun_tpu_torch.ops.anchors import config_anchors
    from cfun_tpu_torch.train import step as tstep

    det_on, mask_on, edge_on = tstep.stage_flags(cfg)
    dev = batch.image.device
    init, step = tstep.make_train_step(cfg, config_anchors(cfg))
    state = init(params)
    frozen = {p: leaf.detach().clone()
              for p, leaf in weights._leaves(state.params).items()
              if not leaf.requires_grad}
    n_train = sum(leaf.numel() for leaf in state.opt_state.leaves)
    seen, tgts, plain_calls = [], [], [0]

    def nms(boxes, valid, thr, k):
        idx, keep = k1.sorted_nms(boxes, valid, thr, k)
        seen.append((boxes.clone(), valid.clone(), thr, k, idx.clone(),
                     keep.clone()))
        return idx, keep

    orig_targets, orig_plain = tstep.detection_targets, k1.sorted_nms_reference

    def targets(*args, **kw):
        tgt = orig_targets(*args, **kw)
        tgts.append(tgt)
        return tgt

    def plain(*args):
        plain_calls[0] += 1
        return orig_plain(*args)

    clocks = [print_clocks(f"{label} before")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold (their detectors), and this path's
    # parameters and batch
    base = torch.cuda.memory_allocated()
    tstep.detection_targets, k1.sorted_nms_reference = targets, plain
    reset_counts(counters)
    anchors = torch.from_numpy(config_anchors(cfg)).to(dev)
    secs, losses, n_pos = [], [], []
    try:
        for i in range(n_steps):
            draws = tstep.draw_train(
                cfg, torch.Generator().manual_seed(TRAIN_SEED), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, draws, nms=nms)
            parts = {k: float(v) for k, v in metrics.items()}
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(parts)
            n_pos.append(int(tgts[-1].pos_valid.sum()))
            print(f"{label} step {i}: {secs[-1]:.3f} s; n_pos {n_pos[-1]}; "
                  f"losses {parts}", flush=True)
            if i == 0:
                # the first step's objective after the first update: its
                # draws and ROI sample held (the proposals then matter
                # not: the recorded NMS result stands in, no launch)
                first = (tgts[0], seen[0][4], seen[0][5])
                tstep.detection_targets = lambda *a, **kw: first[0]
                with torch.no_grad():
                    held_1, _ = tstep.train_forward(
                        state.params, batch, anchors, cfg, draws,
                        nms=lambda *a: first[1:])
                tstep.detection_targets = targets
                loss_first_update = float(held_1)
        launches = {name: mod.launches for name, mod in counters.items()}
        shapes = {name: dict(mod.launch_shapes)
                  for name, mod in counters.items()}
        plain_in_steps = plain_calls[0]
        peak = torch.cuda.max_memory_allocated()
        clocks.append(print_clocks(f"{label} after"))
        with torch.no_grad():
            after, _ = tstep.train_forward(state.params, batch, anchors, cfg,
                                           draws)
        loss_after = float(after)
    finally:
        tstep.detection_targets, k1.sorted_nms_reference = (orig_targets,
                                                            orig_plain)

    for i, parts in enumerate(losses):
        for name, v in parts.items():
            check(np.isfinite(v), f"{label} step {i}: {name} finite")
        for name, on in (("rpn_class_loss", det_on), ("rpn_bbox_loss",
                                                      det_on),
                         ("mrcnn_class_loss", det_on),
                         ("mrcnn_bbox_loss", det_on),
                         ("mrcnn_mask_loss", mask_on),
                         ("mrcnn_mask_edge_loss", edge_on)):
            if not on:
                check(parts[name] == 0.0,
                      f"{label} step {i}: {name} is off and exactly 0")
    check(launches["sorted_nms"] == n_steps and
          shapes["sorted_nms"] == {K1_TRAIN_SHAPE: n_steps},
          f"{label}: K1 once a step at {K1_TRAIN_SHAPE}: {launches} "
          f"{shapes}")
    check(plain_in_steps == 0, f"{label}: the plain NMS ran in the steps")
    check(launches["fused_conv3d"] == 0, f"{label}: K2 launched")
    for i, (boxes, valid, thr, k, idx, keep) in enumerate(seen[:n_steps]):
        ridx, rkeep = orig_plain(boxes, valid, thr, k)
        check(torch.equal(idx, ridx) and torch.equal(keep, rkeep),
              f"{label} step {i}: K1 against its plain version on the "
              f"step's NMS inputs")
    for p, before in frozen.items():
        check(torch.equal(weights._leaves(state.params)[p], before),
              f"{label}: frozen leaf {p} changed")
    check(loss_first_update < losses[0]["total_loss"],
          f"{label}: the first update lowers the first step's objective: "
          f"{losses[0]['total_loss']} -> {loss_first_update}")
    if falls_by_last:
        check(loss_after < losses[0]["total_loss"],
              f"{label}: the loss after the last step {loss_after} is "
              f"below the first step's {losses[0]['total_loss']}")
    state, breakdown = train_breakdown(label, cfg, state, step, batch,
                                       draws)
    boxes, valid, thr, k = seen[0][:4]
    rec = k1_time(k1, boxes, valid, thr, k, f"{label} step")
    rec["device_ms"], rec["kernel_ms"] = kernel_device_ms(
        lambda: k1.sorted_nms(boxes, valid, thr, k), K1_KERNELS)
    rec["site"] = label
    med = float(np.median(secs[1:])) if n_steps > 1 else secs[0]
    print(f"{label}: {n_steps} steps, median {med:.4f} s/step after the "
          f"first, first step {secs[0]:.4f} s; max_memory_allocated {peak} "
          f"B ({peak - base} B above the {base} B allocated before the "
          f"steps); {len(frozen)} frozen leaves unchanged, {n_train} trainable "
          f"parameters; loss {losses[0]['total_loss']:.6g} -> "
          f"{losses[-1]['total_loss']:.6g} (after the last update "
          f"{loss_after:.6g}; the first step's objective after the first "
          f"update {loss_first_update:.6g}); n_pos {n_pos}; "
          f"K1 at {K1_TRAIN_SHAPE}: wrapped {rec['ms']:.4f} ms, device "
          f"{rec['device_ms']:.4f} ms (graph replay) / {rec['kernel_ms']:.4f}"
          f" ms (profiler), bound {rec['bound_ms']:.3g} ms "
          f"({rec['bound_by']}), kept {rec['kept']}", flush=True)
    return {"steps": n_steps, "s_per_step": secs,
            "median_s_per_step_after_first": med, "first_step_s": secs[0],
            "peak_bytes": peak, "allocated_before_bytes": base,
            "losses": losses, "loss_after": loss_after,
            "loss_first_update_held": loss_first_update, "n_pos": n_pos,
            "launches": launches, "clocks": clocks, "k1": rec,
            "frozen_leaves": len(frozen), "trainable_parameters": n_train,
            "breakdown": breakdown}


def train_breakdown(label, cfg, state, step, batch, draws):
    """Where a train step's time goes, on two more steps: CUDA events
    around the forward's layers (the trunk, the proposal layer with K1,
    the detection targets, the classifier branch, the mask branch, the
    losses), the backward pass and the optimizer, each span's ms as the
    stream saw it (the rest of the step is glue); then one step under
    torch.profiler, its device busy ms (kernel and copy time summed)
    against its wall ms.  Returns (state, record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cfun_tpu_torch.models import cfun
    from cfun_tpu_torch.train import losses as L
    from cfun_tpu_torch.train import step as tstep

    spans, in_backward = [], [False]

    def timed(name, fn):
        def run(*args, **kw):
            if in_backward[0]:  # a checkpoint's recomputation
                return fn(*args, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            spans.append((name, start, end))
            return out
        return run

    def backward(fn):
        def run(*args, **kw):
            in_backward[0] = True
            try:
                return fn(*args, **kw)
            finally:
                in_backward[0] = False
        return timed("backward", run)

    patches = [(cfun, "apply_trunk", "trunk fwd"),
               (cfun, "propose", "propose (K1)"),
               (tstep, "detection_targets", "detection targets"),
               (cfun, "pyramid_roi_align", "classifier fwd"),
               (tstep, "apply_classifier", "classifier fwd"),
               (tstep, "roi_align", "mask branch fwd"),
               (tstep, "apply_mask_head", "mask branch fwd"),
               (tstep, "apply_update", "optimizer")]
    patches += [(L, name, "losses fwd") for name in (
        "rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
        "mrcnn_bbox_loss", "mask_loss", "mask_edge_loss")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    grad = torch.autograd.grad
    torch.cuda.synchronize()
    t_start = torch.cuda.Event(enable_timing=True)
    t_end = torch.cuda.Event(enable_timing=True)
    try:
        for mod, name, span in patches:
            setattr(mod, name, timed(span, getattr(mod, name)))
        torch.autograd.grad = backward(grad)
        t_start.record()
        state, _ = step(state, batch, draws)
        t_end.record()
    finally:
        torch.autograd.grad = grad
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    by_span = {}
    for name, start, end in spans:
        by_span[name] = by_span.get(name, 0.0) + start.elapsed_time(end)
    step_ms = t_start.elapsed_time(t_end)
    by_span["glue"] = step_ms - sum(by_span.values())

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch, draws)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(_dev_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"{label} breakdown: a step {step_ms:.3f} ms on the stream; "
          + ", ".join(f"{k} {v:.3f}" for k, v in by_span.items())
          + f" ms; under the profiler device busy {busy:.3f} ms of "
          f"{wall:.3f} ms wall (idle {1 - busy / wall:.3f})", flush=True)
    return state, {"step_ms": step_ms, "span_ms": by_span,
                   "busy_ms": busy, "wall_ms": wall,
                   "idle_share": 1 - busy / wall}


def train_tiny(k1, counters, dev):
    """One train step of the tiny config (float32; the caller turns TF32
    off) on the card and one on the CPU, from the same seeded port weights,
    batch (tests/test_train_step.py:17-39) and draws: the same proposals
    (K1 at 64->32 on the card, its plain version on the CPU), the loss
    parts to rtol 1e-4, every updated leaf within 1e-5 of its largest
    magnitude.  Returns (K1 launches on the card, record)."""
    import numpy as np
    import torch

    from cfun_tpu_torch import config as port_config
    from cfun_tpu_torch import weights
    from cfun_tpu_torch.ops.anchors import config_anchors
    from cfun_tpu_torch.train import step as tstep

    cfg = port_config.tiny_config()
    d, h, w = cfg.image_shape
    rng = np.random.default_rng(0)
    labels = np.zeros((d, h, w), np.int32)
    labels[8:24, 16:48, 16:48] = 1
    labels[10:20, 20:40, 20:40] = 2
    labels[12:16, 24:32, 24:32] = 3
    image = rng.normal(size=(d, h, w)).astype(np.float32)
    image += 2.0 * (labels > 0)
    draws = tstep.draw_train(cfg, torch.Generator().manual_seed(TRAIN_SEED),
                             "cpu")
    out = {}
    for device in ("cpu", dev):
        init, step = tstep.make_train_step(cfg, config_anchors(cfg))
        state = init(weights.to_device(weights.init_params(cfg, seed=0),
                                       device))
        batch = train_batch(cfg, image, labels, device)
        seen = []

        def nms(boxes, valid, thr, k):
            idx, keep = k1.sorted_nms(boxes, valid, thr, k)
            seen.append((boxes.cpu(), idx.cpu(), keep.cpu(), k))
            return idx, keep

        reset_counts(counters)
        state, metrics = step(state, batch, _move_draws(draws, device),
                              nms=nms)
        if device != "cpu":
            torch.cuda.synchronize()
        out[str(device)] = (seen, {k: float(v) for k, v in metrics.items()},
                            {p: v.detach().cpu() for p, v in
                             weights._leaves(state.params).items()},
                            {name: mod.launches
                             for name, mod in counters.items()},
                            {name: dict(mod.launch_shapes)
                             for name, mod in counters.items()})
    (cseen, cparts, cparams, clines, _), (gseen, gparts, gparams, glaunch,
                                          gshapes) = out["cpu"], out[str(dev)]
    check(clines["sorted_nms"] == 0, "train_tiny: no K1 launch on the CPU")
    check(glaunch["sorted_nms"] == 1 and
          gshapes["sorted_nms"] == {(cfg.pre_nms_limit,
                                     cfg.post_nms_rois_training): 1},
          f"train_tiny: K1 once at (64, 32) on the card: {gshapes}")
    check(len(cseen) == len(gseen) == 1, "train_tiny: one NMS call a step")
    check(torch.equal(cseen[0][1], gseen[0][1]) and
          torch.equal(cseen[0][2], gseen[0][2]),
          "train_tiny: the card's proposals are the CPU's")
    check(torch.allclose(cseen[0][0], gseen[0][0], rtol=1e-4, atol=1e-4),
          "train_tiny: the NMS input boxes")
    for k, v in cparts.items():
        check(np.isfinite(v) and abs(gparts[k] - v) <= 1e-4 * abs(v),
              f"train_tiny: {k} card {gparts[k]} vs CPU {v}")
    worst = 0.0
    for p, v in cparams.items():
        scale = float(v.abs().max())
        err = float((gparams[p] - v).abs().max())
        check(err <= 1e-5 * scale, f"train_tiny: updated {p} differs by "
              f"{err} (largest magnitude {scale})")
        worst = max(worst, err / scale if scale else 0.0)
    print(f"train_tiny: one step on the card and on the CPU agree: "
          f"proposals equal ({int(gseen[0][2].sum())} kept), losses "
          f"{gparts} vs {cparts}; updated leaves within {worst:.3g} of "
          f"their largest magnitude", flush=True)
    return glaunch, {"losses_card": gparts, "losses_cpu": cparts,
                     "worst_leaf_rel": worst}


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
    params, _, _ = checkpoint.load_any(wpath, cfg,
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

    params, _, _ = checkpoint.load_any(wpath, cfg,
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


# ---- training loops ---------------------------------------------------------
#
# train_loop_heart / train_loop_lits run the port's train command and
# train_model; `schedule` reruns the JAX package's synthetic heart
# schedule.  The data: benchmarks/train_synth.py's synthetic heart train
# set (8 volumes, seed 1000, 144x144x96, 7 classes), its validation
# volumes (seed 2000; 13 for the CLI, whose manifest validates its first
# 13), and seeded 400x400x280 LiTS volumes as the .npy cache.
LOOP_HEART_TRAIN = dict(n=8, seed=1000, host_shape=(144, 144, 96), n_fg=7)
LOOP_HEART_VAL = dict(seed=2000, host_shape=(144, 144, 96), n_fg=7)
LOOP_LITS = dict(n_train=4, train_seed=120, val_id=111, val_seed=190)
# train_model's short schedule: the resume check and the mold cache
SHORT_LOOP = dict(steps_per_epoch=5, val_every_epochs=1, validation_steps=2)
# the resumed run is held to this many times the spread of two identical
# runs (cuDNN's backward sums in an order that varies between runs)
RESUME_SPREAD_FACTOR = 4.0
# the JAX package's synthetic heart schedule (benchmarks/train_synth.py
# defaults, --weights none) and its recorded loss curve
SCHEDULE = dict(epochs=60, steps_per_epoch=15, seed=0)
JAX_SCHEDULE_CURVE = os.path.join("benchmarks", "train_synth_extend.json")


def _window_stats(prof, wall_ms):
    """Busy and idle share of a profiled window of training steps, and
    its host-to-device copies: their device ms and the part of it that
    overlaps a kernel (union of the kernels' intervals)."""
    import torch

    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in evs)
    kernels = [(a, b) for a, b, n in spans if "memcpy" not in n.lower()
               and "memset" not in n.lower()]
    h2d = [(a, b) for a, b, n in spans if "htod" in n.lower()]

    def union(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    busy_iv = union([(a, b) for a, b, _ in spans])
    kern_iv = union(kernels)
    overlap = 0.0
    for a, b in h2d:
        for c, d in kern_iv:
            overlap += max(0.0, min(b, d) - max(a, c))
    busy = sum(b - a for a, b in busy_iv) / 1e3
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "h2d_copies": len(h2d),
            "h2d_ms": sum(b - a for a, b in h2d) / 1e3,
            "h2d_overlapped_ms": overlap / 1e3, "device_events": len(evs)}


class LoopProbe:
    """What a training loop run does on the card: CUDA events around each
    step call (``train/loop.py``'s ``make_train_step`` wrapped), the NMS
    inputs and K1's result of the first and the last step, torch.profiler
    windows over the step calls ``windows`` ([start, end) indices), calls
    of K1's plain version, and every kernel's launches and shapes (set to
    0 on entry, read on exit), the peak memory and the clocks."""

    def __init__(self, label, k1, counters, windows=()):
        self.label, self.k1, self.counters = label, k1, counters
        self.windows = list(windows)
        self.events, self.first, self.last = [], None, None
        self.plain, self.window_stats = 0, []
        self._prof = None
        # step calls a profiler window's end (its host-side stop) preceded
        self.closed_before = set()

    def _nms(self, boxes, valid, thr, k):
        idx, keep = self.k1.sorted_nms(boxes, valid, thr, k)
        rec = (boxes.clone(), valid.clone(), thr, k, idx.clone(),
               keep.clone())
        if self.first is None:
            self.first = rec
        self.last = rec
        return idx, keep

    def _edge(self, i):
        import torch
        from torch.profiler import ProfilerActivity, profile

        for a, b in self.windows:
            if i == b and self._prof is not None:
                self._close()
                self.closed_before.add(i)
            if i == a:
                torch.cuda.synchronize()
                self._prof = profile(activities=[ProfilerActivity.CUDA])
                self._prof.start()
                self._t0 = time.perf_counter()

    def _close(self):
        import torch

        torch.cuda.synchronize()
        wall = (time.perf_counter() - self._t0) * 1e3
        self._prof.stop()
        self.window_stats.append(_window_stats(self._prof, wall))
        self._prof = None

    def __enter__(self):
        import torch

        from cfun_tpu_torch.train import loop

        self._loop, self._orig_make = loop, loop.make_train_step
        self._orig_plain = self.k1.sorted_nms_reference

        def plain(*args):
            self.plain += 1
            return self._orig_plain(*args)

        def make(cfg, anchors):
            init, step = self._orig_make(cfg, anchors)

            def wrapped(state, batch, draws=None, generator=None, **kw):
                self._edge(len(self.events))
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(state, batch, draws, generator, nms=self._nms)
                end.record()
                self.events.append((start, end))
                return out

            return init, wrapped

        loop.make_train_step = make
        self.k1.sorted_nms_reference = plain
        self.clocks = [print_clocks(f"{self.label} before")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(self.counters)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        try:
            if self._prof is not None:
                self._close()
            torch.cuda.synchronize()
            self.wall = time.perf_counter() - self.t0
            self.launches = {n: m.launches for n, m in self.counters.items()}
            self.shapes = {n: dict(m.launch_shapes)
                           for n, m in self.counters.items()}
            self.peak = torch.cuda.max_memory_allocated()
        finally:
            self._loop.make_train_step = self._orig_make
            self.k1.sorted_nms_reference = self._orig_plain
        if exc[0] is None:
            self.clocks.append(print_clocks(f"{self.label} after"))
        return False

    def step_seconds(self):
        """Each step's seconds on the stream, start to next start (the
        loop's pace, waits on the host included); start to end for the
        last step and for one a profiler window's stop follows (the stop
        processes the window's events on the host for seconds)."""
        ev = self.events
        return [ev[i][0].elapsed_time(ev[i][1]) / 1e3
                if i + 1 == len(ev) or i + 1 in self.closed_before
                else ev[i][0].elapsed_time(ev[i + 1][0]) / 1e3
                for i in range(len(ev))]

    def check_k1(self, n_steps, n_val):
        """K1 once a step and once a validation forward at the train
        shape, its plain version and K2 never, K1 equal to its plain
        version on the first and last step's NMS inputs.  Returns the
        record of K1 timed at the first step's inputs."""
        import torch

        want = n_steps + n_val
        check(self.launches["sorted_nms"] == want and
              self.shapes["sorted_nms"] == {K1_TRAIN_SHAPE: want},
              f"{self.label}: K1 {want} times ({n_steps} steps + {n_val} "
              f"validation forwards) at {K1_TRAIN_SHAPE}: {self.launches} "
              f"{self.shapes}")
        check(self.plain == 0, f"{self.label}: the plain NMS ran")
        check(self.launches["fused_conv3d"] == 0, f"{self.label}: K2 ran")
        check(len(self.events) == n_steps,
              f"{self.label}: {len(self.events)} step calls, not {n_steps}")
        for tag, (boxes, valid, thr, k, idx, keep) in (("first", self.first),
                                                       ("last", self.last)):
            ridx, rkeep = self._orig_plain(boxes, valid, thr, k)
            check(torch.equal(idx, ridx) and torch.equal(keep, rkeep),
                  f"{self.label}: K1 against its plain version on the "
                  f"{tag} step's NMS inputs")
        boxes, valid, thr, k = self.first[:4]
        rec = k1_time(self.k1, boxes, valid, thr, k, f"{self.label} step")
        rec["device_ms"], rec["kernel_ms"] = kernel_device_ms(
            lambda: self.k1.sorted_nms(boxes, valid, thr, k), K1_KERNELS)
        rec["site"] = self.label
        return rec


def _metric_records(log_dir):
    import glob

    recs = []
    for f in sorted(glob.glob(os.path.join(log_dir, "**",
                                           "train_metrics.jsonl"),
                              recursive=True)):
        with open(f) as fh:
            recs.extend(json.loads(line) for line in fh)
    return ({r["epoch"]: r for r in recs if "loss" in r},
            {r["epoch"]: r for r in recs if "val_loss" in r})


def loop_report(probe, log_dir, n_steps):
    """The numbers of one loop run: s/step (median after the first, the
    first), the feeder's item ms by part and the loop's wait on it a step,
    H2D bytes a step, the profiled window's busy / idle and copies, the
    peak memory, the clocks."""
    import numpy as np

    epochs, vals = _metric_records(log_dir)
    secs = probe.step_seconds()
    med = float(np.median(secs[1:])) if len(secs) > 1 else secs[0]
    steps = sum(r["steps"] for r in epochs.values())
    check(steps == n_steps, f"{probe.label}: {steps} steps logged")
    for e, r in epochs.items():
        check(np.isfinite(r["loss"]), f"{probe.label}: epoch {e} loss")
    items = [r["feeder_item_ms"] for r in epochs.values()
             if r["feeder_item_ms"]]
    item_ms = {k: float(np.mean([it[k] for it in items]))
               for k in (items[0] if items else {})}
    wait = sum(r["feeder_wait_s"] for r in epochs.values()) / steps
    h2d = sum(r["h2d_bytes"] for r in epochs.values()) / steps
    rec = {"steps": steps, "s_per_step": secs,
           "median_s_per_step_after_first": med, "first_step_s": secs[0],
           "wall_s": probe.wall, "feeder_item_ms": item_ms,
           "feeder_wait_s_per_step": wait, "h2d_bytes_per_step": h2d,
           "windows": probe.window_stats, "peak_bytes": probe.peak,
           "clocks": probe.clocks, "launches": probe.launches,
           "epochs": {str(e): {k: v for k, v in r.items()
                               if k != "feeder_item_ms"}
                      for e, r in epochs.items()},
           "val_loss": {str(e): r["val_loss"] for e, r in vals.items()}}
    win = "; ".join(
        f"window {i}: busy {w['busy_ms']:.3f} of {w['wall_ms']:.3f} ms "
        f"(idle {w['idle_share']:.3f}), {w['h2d_copies']} H2D copies "
        f"{w['h2d_ms']:.3f} ms of which {w['h2d_overlapped_ms']:.3f} ms "
        f"under a kernel" for i, w in enumerate(probe.window_stats))
    print(f"{probe.label}: {steps} steps in {probe.wall:.3f} s, median "
          f"{med:.4f} s/step after the first, first {secs[0]:.4f} s; feeder "
          f"item ms {item_ms}; the loop's wait on the feeder "
          f"{wait * 1e3:.2f} ms/step; H2D {h2d:.0f} B/step; {win}; "
          f"max_memory_allocated {probe.peak} B; epoch losses "
          f"{[round(r['loss'], 6) for r in epochs.values()]}", flush=True)
    return rec


def checkpoint_times(cfg, ckpt, tmp, dev):
    """save and save_async (its caller's part, then flush) of the trained
    parameters and optimizer state, ms and bytes."""
    from cfun_tpu_torch import weights
    from cfun_tpu_torch.ops.anchors import config_anchors
    from cfun_tpu_torch.train.step import make_train_step
    from cfun_tpu_torch.utils import checkpoint

    init, _ = make_train_step(cfg, config_anchors(cfg))
    state = init(weights.to_device(weights.init_params(cfg, 0), dev))
    checkpoint.load(ckpt, state.params, state.opt_state)
    out = {}
    path = os.path.join(tmp, "timing")
    t0 = time.perf_counter()
    checkpoint.save(path, state.params, 1, 1, state.opt_state)
    out["save_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    checkpoint.save_async(path, state.params, 1, 1, state.opt_state)
    out["save_async_caller_ms"] = (time.perf_counter() - t0) * 1e3
    checkpoint.flush()
    out["save_async_total_ms"] = (time.perf_counter() - t0) * 1e3
    out["bytes"] = os.path.getsize(path + ".npz")
    os.remove(path + ".npz")
    print(f"checkpoint of {cfg.name} '{cfg.stage}': save "
          f"{out['save_ms']:.1f} ms, save_async {out['save_async_caller_ms']:.1f}"
          f" ms on the caller ({out['save_async_total_ms']:.1f} ms to "
          f"flush), {out['bytes']} B", flush=True)
    return out


def write_heart_manifest(data, val, train):
    """``val`` then ``train`` (SyntheticDataset) as float32 .nii volumes
    and labels with a dataset.json whose first len(val) entries the heart
    CLI validates on."""
    import numpy as np

    from cfun_tpu_torch.data import nifti

    os.makedirs(data, exist_ok=True)
    items = []
    for tag, ds in (("val", val), ("train", train)):
        for i in range(ds.num_images):
            item = {"image": f"{tag}_img_{i:02d}.nii",
                    "label": f"{tag}_lbl_{i:02d}.nii"}
            nifti.save(os.path.join(data, item["image"]),
                       ds.load_image(i)[..., 0].astype(np.float32))
            nifti.save(os.path.join(data, item["label"]),
                       ds.load_mask(i).astype(np.int16))
            items.append(item)
    with open(os.path.join(data, "dataset.json"), "w") as f:
        json.dump({"train_and_test": items}, f)


def _ckpt_meta(path):
    import numpy as np

    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def train_loop_heart(tmp, counters, k1, dev):
    """The heart CLI's train (45 steps of heart_config('beginning') from
    weights/heart_synth.npz, its epoch 60 + 1, no validation at epoch 61);
    train_model's short schedule, 3 epochs against 2 + resume 1, held to
    the spread of two identical runs; and --aug-device --device-cache for
    2 epochs, with no image upload in the second.  Returns ({path:
    launches}, {path: record})."""
    import numpy as np

    from cfun_tpu_torch import config as port_config
    from cfun_tpu_torch.cli import heart_main
    from cfun_tpu_torch.data.datasets import SyntheticDataset
    from cfun_tpu_torch.train.loop import train_model

    wpath = os.path.join(ROOT, "weights", "heart_synth.npz")
    start_epoch = _ckpt_meta(wpath)["epoch"]
    cfg = port_config.heart_config("beginning")
    train = SyntheticDataset(cfg, **LOOP_HEART_TRAIN)
    data = os.path.join(tmp, "heart_data")
    t0 = time.perf_counter()
    write_heart_manifest(data, SyntheticDataset(cfg, n=13, **LOOP_HEART_VAL),
                         train)
    print(f"train_loop_heart: wrote 13 validation and "
          f"{train.num_images} train volumes in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    launches, recs = {}, {}

    # 1. the CLI
    logs = os.path.join(tmp, "cli_logs")
    with LoopProbe("train_loop_heart cli", k1, counters,
                   windows=[(10, 20)]) as probe:
        ckpt = heart_main.main(["train", "--weights", wpath, "--stage",
                                "beginning", "--data", data, "--logs", logs,
                                "--epochs", str(start_epoch + 1),
                                "--workers", "8"])
    n = cfg.steps_per_epoch
    rec = loop_report(probe, logs, n)
    rec["k1"] = probe.check_k1(n, 0)
    meta = _ckpt_meta(ckpt)
    check((meta["epoch"], meta["step"]) == (start_epoch + 1, n),
          f"train_loop_heart cli: the checkpoint's epoch and step {meta}")
    rec["checkpoint"] = checkpoint_times(cfg, ckpt, tmp, dev)
    launches["train_loop_heart_cli"], recs["heart cli"] = probe.launches, rec

    # 2. the short schedule: the spread of identical runs, then the resume
    scfg = cfg.replace(**SHORT_LOOP)
    val = SyntheticDataset(cfg, n=2, **LOOP_HEART_VAL)
    runs = {}
    for name, epochs, weights in (("a", 3, wpath), ("a2", 3, wpath),
                                  ("b", 2, wpath), ("c", 3, "b")):
        log = os.path.join(tmp, f"short_{name}")
        w = runs["b"][0] if weights == "b" else weights
        n_ep = 1 if name == "c" else epochs
        with LoopProbe(f"train_loop_heart short {name}", k1,
                       counters) as probe:
            path = train_model(scfg, train, val, log_dir=log, weights=w,
                               epochs=start_epoch + epochs, num_workers=8)
        probe.check_k1(n_ep * scfg.steps_per_epoch,
                       n_ep * scfg.validation_steps)
        launches[f"train_loop_heart_short_{name}"] = probe.launches
        runs[name] = (path, _metric_records(log), probe)
    last = start_epoch + 3

    def gaps(x, y):
        ex, vx = runs[x][1]
        ey, vy = runs[y][1]
        out = {"loss": abs(ex[last]["loss"] - ey[last]["loss"]),
               "val_loss": abs(vx[last]["val_loss"] - vy[last]["val_loss"])}
        with np.load(runs[x][0]) as a, np.load(runs[y][0]) as b:
            out["params"] = max(float(np.abs(a[k] - b[k]).max())
                                for k in a.files if k.startswith("params/"))
        return out

    spread, resume = gaps("a", "a2"), gaps("a", "c")
    for k, s in spread.items():
        check(resume[k] <= RESUME_SPREAD_FACTOR * s,
              f"train_loop_heart short: the resumed run's {k} gap "
              f"{resume[k]:.3g} within {RESUME_SPREAD_FACTOR:g} x the "
              f"spread of identical runs {s:.3g}")
    ea = runs["a"][1][0]
    print(f"train_loop_heart short: epochs {sorted(ea)} losses "
          f"{[ea[e]['loss'] for e in sorted(ea)]}; identical runs part by "
          f"{spread}, the resumed run (2 + 1 epochs) from the straight one "
          f"by {resume}", flush=True)
    recs["heart short"] = {"spread": spread, "resume_gap": resume,
                           "losses": {str(e): r["loss"]
                                      for e, r in ea.items()},
                           "median_s_per_step_after_first": float(np.median(
                               runs["a"][2].step_seconds()[1:]))}

    # 3. rotation and targets on the device, the molds kept there
    acfg = cfg.replace(augment_on_device=True, device_mold_cache=True,
                       steps_per_epoch=train.num_images, val_every_epochs=1,
                       validation_steps=2)
    log = os.path.join(tmp, "aug_logs")
    n = acfg.steps_per_epoch
    with LoopProbe("train_loop_heart aug", k1, counters,
                   windows=[(1, n), (n + 1, 2 * n + 1)]) as probe:
        train_model(acfg, train, val, log_dir=log, weights=wpath,
                    epochs=start_epoch + 2, num_workers=8)
    rec = loop_report(probe, log, 2 * n)
    rec["k1"] = probe.check_k1(2 * n, 2 * acfg.validation_steps)
    ep = _metric_records(log)[0]
    first, second = (ep[start_epoch + 1]["h2d_bytes"],
                     ep[start_epoch + 2]["h2d_bytes"])
    w1, w2 = probe.window_stats
    check(first > 0 and second == 0,
          f"train_loop_heart aug: H2D bytes by epoch {first}, {second}")
    check(w2["h2d_ms"] <= 0.01 * w1["h2d_ms"],
          f"train_loop_heart aug: the profiler's H2D copies in epoch 2 "
          f"({w2['h2d_copies']}, {w2['h2d_ms']:.4f} ms) against epoch 1's "
          f"({w1['h2d_copies']}, {w1['h2d_ms']:.4f} ms)")
    launches["train_loop_heart_aug"], recs["heart aug"] = probe.launches, rec
    return launches, recs


def train_loop_lits(tmp, counters, k1, dev):
    """The LiTS CLI's train (100 steps of lits_config('beginning') from
    weights/lits_synth.npz, its epoch 6 + 1) on the .npy cache of seeded
    400x400x280 volumes (train ids 0.., validation id 111).  Returns
    (launches, record)."""
    import numpy as np

    from cfun_tpu_torch import config as port_config
    from cfun_tpu_torch.cli import lits_main

    wpath = os.path.join(ROOT, "weights", "lits_synth.npz")
    start_epoch = _ckpt_meta(wpath)["epoch"]
    cache = os.path.join(tmp, "lits_cache")
    for sub in ("image_np", "label_np"):
        os.makedirs(os.path.join(cache, sub))
    t0 = time.perf_counter()
    vols = synthetic_lits(LOOP_LITS["n_train"], LOOP_LITS["train_seed"])
    vols += synthetic_lits(1, LOOP_LITS["val_seed"])
    ids = list(range(LOOP_LITS["n_train"])) + [LOOP_LITS["val_id"]]
    for i, (vol, lab) in zip(ids, vols):
        np.save(os.path.join(cache, "image_np", f"liver_{i}.npy"), vol)
        np.save(os.path.join(cache, "label_np", f"liver_label_{i}.npy"), lab)
    del vols
    print(f"train_loop_lits: wrote {len(ids)} 400x400x280 volumes (ids "
          f"{ids}) in {time.perf_counter() - t0:.3f} s", flush=True)
    cfg = port_config.lits_config("beginning")
    logs = os.path.join(tmp, "logs")
    with LoopProbe("train_loop_lits cli", k1, counters,
                   windows=[(40, 60)]) as probe:
        ckpt = lits_main.main(["train", "--weights", wpath, "--stage",
                               "beginning", "--data", cache, "--logs", logs,
                               "--epochs", str(start_epoch + 1),
                               "--workers", "8"])
    n = cfg.steps_per_epoch
    rec = loop_report(probe, logs, n)
    rec["k1"] = probe.check_k1(n, 0)
    meta = _ckpt_meta(ckpt)
    check((meta["epoch"], meta["step"]) == (start_epoch + 1, n),
          f"train_loop_lits: the checkpoint's epoch and step {meta}")
    rec["checkpoint"] = checkpoint_times(cfg, ckpt, tmp, dev)
    return probe.launches, rec


def schedule_phase(tmp, counters, k1, dev, start="none"):
    """The JAX package's synthetic heart schedule from seeded random
    weights (``--weights none``), or from the checkpoint ``start`` (an
    epoch-0 .npz, e.g. the JAX package's own initial weights):
    benchmarks/train_synth.py's data, 60 epochs of 15 steps, seed 0, the
    bf16 wire; then the held-out evaluation of cli_heart (12 volumes, seed
    3000) on the weights it wrote: Dice and box IoU beside the JAX
    package's."""
    import numpy as np

    from cfun_tpu_torch import config as port_config
    from cfun_tpu_torch import weights
    from cfun_tpu_torch.cli.lits_main import _box_iou, _gt_extended_box_yxz
    from cfun_tpu_torch.data.datasets import SyntheticDataset
    from cfun_tpu_torch.inference import Detector
    from cfun_tpu_torch.train.loop import train_model
    from cfun_tpu_torch.utils import checkpoint
    from cfun_tpu_torch.utils.metrics import per_class_dice

    cfg = port_config.heart_config(
        "beginning", steps_per_epoch=SCHEDULE["steps_per_epoch"])
    train = SyntheticDataset(cfg, **LOOP_HEART_TRAIN)
    val = SyntheticDataset(cfg, n=2, **LOOP_HEART_VAL)
    log = os.path.join(tmp, "schedule")
    n_val = SCHEDULE["epochs"] // cfg.val_every_epochs
    with LoopProbe("schedule", k1, counters) as probe:
        ckpt = train_model(cfg, train, val, log_dir=log, weights=start,
                           epochs=SCHEDULE["epochs"], seed=SCHEDULE["seed"],
                           num_workers=8)
    n = SCHEDULE["epochs"] * cfg.steps_per_epoch
    rec = loop_report(probe, log, n)
    probe.check_k1(n, n_val * min(cfg.validation_steps, val.num_images))
    epochs, vals = _metric_records(log)
    curve = [round(epochs[e]["loss"], 4) for e in sorted(epochs)]
    with open(os.path.join(ROOT, JAX_SCHEDULE_CURVE)) as f:
        jax_curve = next(r for r in json.load(f)
                         if r.get("stage", "beginning") == "beginning"
                         and r["epochs"] == SCHEDULE["epochs"]
                         and r["wire"] == "bf16")["losses"]

    icfg = port_config.heart_inference_config("beginning")
    params, _, _ = checkpoint.load_any(ckpt, icfg,
                                       weights.init_params(icfg, 0))
    det = Detector(icfg, params)
    held = SyntheticDataset(icfg, **HEART_EVAL)
    dices, bious = [], []
    for i in range(held.num_images):
        label = np.asarray(held.load_mask(i), np.int32)
        res = det.detect(held.load_image(i)[..., 0])
        rois = np.clip(res["rois"], 0, None).astype(np.int64)
        if len(rois):
            bious.append(_box_iou(_gt_extended_box_yxz(label).astype(
                np.float64), rois[0].astype(np.float64)))
        dices.append(per_class_dice(label, res["mask"], icfg.num_classes))
    det.close()
    dice = float(np.mean(dices))
    biou = float(np.mean(bious)) if bious else float("nan")
    print(f"schedule: loss by epoch {curve}; validation loss "
          f"{[round(vals[e]['val_loss'], 4) for e in sorted(vals)]}; the JAX "
          f"package's recorded curve ({JAX_SCHEDULE_CURVE}, its last "
          f"{len(jax_curve)} epochs) {jax_curve}; held-out Dice {dice:.4f} "
          f"(per class {np.round(np.mean(dices, axis=0), 4).tolist()}), box "
          f"IoU {biou:.4f} ({len(bious)} boxes) beside the JAX package's "
          f"{HEART_JAX_EVAL}", flush=True)
    rec.update(start=start, loss_curve=curve, jax_loss_curve=jax_curve,
               val_loss={str(e): vals[e]["val_loss"] for e in sorted(vals)},
               dice_mean=dice, box_iou_mean=biou,
               dice_per_class=np.mean(dices, axis=0).tolist(),
               jax_recorded=HEART_JAX_EVAL)
    return probe.launches, rec


# Mesh paths (parallel/): the steps each takes, a rank's longest wait in a
# collective, and the tolerances of a mesh step against one process's.
# (2, 1) against the step on the mean gradient of its two items:
# train_tiny's rtol 1e-4 (losses) and 1e-5 of each updated leaf's largest
# magnitude, at the model's bf16 (both sides scale the same bf16 backward
# by 1/2, exactly).  (1, 2) 'finetune' against the dense step: float32
# with TF32 off on both sides (cuDNN picks other algorithms for the
# shards' shapes, so the sums run in other orders): the mask and edge
# losses to rtol 1e-4; the U-Net's gradients as close to a float64
# evaluation of them on the dense step's crops as the dense step's: the
# largest gap over the leaves (each over its leaf's largest magnitude)
# within SHARD_F64_FACTOR times the dense step's, or SHARD_GRAD_FLOOR.
# (A first criterion, 1e-3 of a leaf's largest magnitude between the split
# and the dense gradients, failed on the card at 1.15e-3 on c1_2/w; on the
# CPU both float32 evaluations sit ~1e-3 from float64 at the tiny
# finetune config, so the float64 evaluation is the reference.)
MESH_STEPS = {"heart 1x1": 6, "heart 2x1": 4, "heart 1x2 beginning": 2,
              "heart 1x2 finetune": 2, "lits 2x1": 2,
              "lits 1x2 beginning": 2, "heart 4x1 nccl": 4,
              "heart 1x2 finetune nccl": 2}
MESH_TIMEOUT_S = 300
MESH_LOSS_RTOL, MESH_LEAF_REL = 1e-4, 1e-5
# a (1, 2) mesh in float32 against the dense step: the loss parts, and the
# trunk's and the heads' summed gradients (each over its leaf's largest
# magnitude); the split U-Net's against float64 (above)
SPLIT_LOSS_RTOL, SPLIT_LEAF_REL = 1e-4, 1e-4
SHARD_F64_FACTOR, SHARD_GRAD_FLOOR = 2.0, 1e-4


def _sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _digest(params):
    """(sha256 of every leaf's bytes in path order, the leaves on the
    host)."""
    import hashlib

    from cfun_tpu_torch import weights

    host = {p: v.detach().to("cpu", copy=True) for p, v in
            weights._leaves(params).items()}
    h = hashlib.sha256()
    for p in sorted(host):
        h.update(host[p].numpy().tobytes())
    return h.hexdigest(), host


def mesh_rank(mesh, cfg, ckpt, batch_file, n_steps, grads_of=None):
    """One rank of a mesh path (run in the ranks parallel/launch.py
    starts): the checkpoint ``ckpt``, its row's batch from ``batch_file``
    (a list by data index), ``n_steps`` steps of make_parallel_train_step,
    each with draws from a generator seeded TRAIN_SEED + data index (the
    same on a row's ranks, re-seeded every step).  Every kernel's launch
    count is set to 0 just before the steps and read just after; K1's
    plain version is counted (it must not run); K1 is held against it on
    the first step's NMS inputs after the counts are read.  Float32
    configs run with TF32 off.  Returns each step's seconds, metrics and
    parameter digest, the launches, the gradient all-reduce's ms a step,
    the peak memory; rank 0 also its parameters after the first step and,
    with ``grads_of`` (a tree-path prefix, '' for all), the first step's
    all-reduced gradients of those leaves."""
    import torch

    from cfun_tpu_torch import weights
    from cfun_tpu_torch.ops import fused_conv as k2
    from cfun_tpu_torch.ops import sorted_nms as k1
    from cfun_tpu_torch.ops.anchors import config_anchors
    from cfun_tpu_torch.parallel import mesh as pmesh
    from cfun_tpu_torch.train import step as tstep

    if cfg.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    params, _ = weights.load_npz(os.path.join(ROOT, ckpt), cfg)
    batch = torch.load(batch_file, weights_only=False)[mesh.data_index]
    batch = batch.to(dev)
    init, step = pmesh.make_parallel_train_step(cfg, config_anchors(cfg),
                                                mesh)
    state = init(weights.to_device(params, dev))
    del params
    counters = {"sorted_nms": k1, "fused_conv3d": k2}
    seen, plain_calls, captured = [], [0], {}
    orig_plain, orig_reduce = (k1.sorted_nms_reference,
                               pmesh.all_reduce_gradients)

    def nms(boxes, valid, thr, k):
        idx, keep = k1.sorted_nms(boxes, valid, thr, k)
        if not seen:
            seen.append((boxes.clone(), valid.clone(), thr, k, idx.clone(),
                         keep.clone()))
        return idx, keep

    def plain(*args):
        plain_calls[0] += 1
        return orig_plain(*args)

    def reduce(grads, group=None):
        out = orig_reduce(grads, group)
        if grads_of is not None and mesh.rank == 0 and not captured:
            captured.update({p: g.detach().to("cpu", copy=True)
                             for p, g in out.items()
                             if p.startswith(grads_of)})
        return out

    secs, losses, digests, first = [], [], [], None
    cuda = dev.type == "cuda"
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    k1.sorted_nms_reference, pmesh.all_reduce_gradients = plain, reduce
    reset_counts(counters)
    try:
        for i in range(n_steps):
            draws = tstep.draw_train(
                cfg, torch.Generator().manual_seed(TRAIN_SEED +
                                                   mesh.data_index), dev)
            _sync(dev)
            t0 = time.perf_counter()
            state, metrics = step(state, batch, draws, nms=nms)
            parts = {k: float(v) for k, v in metrics.items()}
            _sync(dev)
            secs.append(time.perf_counter() - t0)
            losses.append(parts)
            digest, host = _digest(state.params)
            digests.append(digest)
            if i == 0 and mesh.rank == 0:
                first = host
        launches = {name: mod.launches for name, mod in counters.items()}
        shapes = {name: dict(mod.launch_shapes)
                  for name, mod in counters.items()}
        plain_in_steps = plain_calls[0]
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    finally:
        k1.sorted_nms_reference, pmesh.all_reduce_gradients = (orig_plain,
                                                               orig_reduce)
    boxes, valid, thr, k, idx, keep = seen[0]
    ridx, rkeep = orig_plain(boxes, valid, thr, k)
    return {"rank": mesh.rank, "data_index": mesh.data_index,
            "space_index": mesh.space_index, "backend": mesh.backend,
            "device": str(dev), "s_per_step": secs, "losses": losses,
            "digests": digests, "launches": launches, "shapes": shapes,
            "plain_calls": plain_in_steps,
            "k1_exact": bool(torch.equal(idx, ridx) and
                             torch.equal(keep, rkeep)),
            "kept": int(keep.sum()), "allreduce_ms": step.allreduce_ms(),
            "peak_bytes": peak, "first_params": first,
            "grads": captured or None}


def run_mesh(label, cfg, ckpt, batches, n_steps, layout, devices, backend,
             tmp, grads_of=None):
    """Launch ``mesh_rank`` on a ``layout`` (data, space) mesh; check each
    rank's launches (K1 exactly once a step at K1_TRAIN_SHAPE, its plain
    version and K2 never, K1 equal to its plain version on the first
    step's NMS inputs) and that every rank holds the same parameters
    after every step; print s/step, the all-reduce's ms and the peak
    memory by rank.  Returns (launches summed over the ranks, the ranks'
    records)."""
    import numpy as np
    import torch

    from cfun_tpu_torch.parallel.launch import launch

    batch_file = os.path.join(tmp, f"{label.replace(' ', '_')}.pt")
    torch.save([b.to("cpu") for b in batches], batch_file)
    t0 = time.perf_counter()
    recs = launch(mesh_rank, *layout, devices=devices, backend=backend,
                  timeout_s=MESH_TIMEOUT_S,
                  args=(cfg, ckpt, batch_file, n_steps, grads_of))
    wall = time.perf_counter() - t0
    os.remove(batch_file)
    for r in recs:
        check(r["launches"]["sorted_nms"] == n_steps and
              r["shapes"]["sorted_nms"] == {K1_TRAIN_SHAPE: n_steps},
              f"{label} rank {r['rank']}: K1 once a step at "
              f"{K1_TRAIN_SHAPE}: {r['launches']} {r['shapes']}")
        check(r["plain_calls"] == 0 and r["launches"]["fused_conv3d"] == 0,
              f"{label} rank {r['rank']}: the plain NMS or K2 ran")
        check(r["k1_exact"], f"{label} rank {r['rank']}: K1 against its "
              "plain version on the first step's NMS inputs")
        check(r["digests"] == recs[0]["digests"],
              f"{label} rank {r['rank']}: parameters differ from rank 0's")
        check(r["losses"] == recs[0]["losses"],
              f"{label} rank {r['rank']}: metrics differ from rank 0's")
        for parts in r["losses"]:
            check(all(np.isfinite(v) for v in parts.values()),
                  f"{label}: finite losses")
        med = float(np.median(r["s_per_step"][1:])) if n_steps > 1 \
            else r["s_per_step"][0]
        ar = r["allreduce_ms"]
        print(f"{label} rank {r['rank']} (data {r['data_index']}, space "
              f"{r['space_index']}, {r['backend']} on {r['device']}): "
              f"median {med:.4f} s/step after the first, first "
              f"{r['s_per_step'][0]:.4f} s; gradient all-reduce "
              f"{float(np.median(ar)):.3f} ms a step (median; each "
              f"{[round(x, 3) for x in ar]}); max_memory_allocated "
              f"{r['peak_bytes']} B; K1 {r['launches']['sorted_nms']} "
              f"launches, kept {r['kept']} on the first step", flush=True)
    print(f"{label}: {len(recs)} rank(s), parameters equal on every rank "
          f"after each of {n_steps} steps; launch wall {wall:.1f} s "
          f"(process start, CUDA set-up, checkpoint load included); "
          f"losses {[p['total_loss'] for p in recs[0]['losses']]}",
          flush=True)
    launches = {name: sum(r["launches"][name] for r in recs)
                for name in ("sorted_nms", "fused_conv3d")}
    return launches, recs


def plain_steps(label, cfg, ckpt, batch, n_steps, dev):
    """``n_steps`` of make_train_step in this process from ``ckpt`` on
    ``batch``, the draws re-seeded TRAIN_SEED every step, as mesh_rank
    takes them: each step's seconds, metrics and parameter digest."""
    import torch

    from cfun_tpu_torch import weights
    from cfun_tpu_torch.ops.anchors import config_anchors
    from cfun_tpu_torch.train import step as tstep

    params, _ = weights.load_npz(os.path.join(ROOT, ckpt), cfg)
    init, step = tstep.make_train_step(cfg, config_anchors(cfg))
    state = init(weights.to_device(params, dev))
    secs, losses, digests = [], [], []
    for _ in range(n_steps):
        draws = tstep.draw_train(
            cfg, torch.Generator().manual_seed(TRAIN_SEED), dev)
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, draws)
        parts = {k: float(v) for k, v in metrics.items()}
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        losses.append(parts)
        digests.append(_digest(state.params)[0])
    print(f"{label} plain step in this process: {secs} s", flush=True)
    return secs, losses, digests


def mean_gradient_update(cfg, ckpt, batches, dev):
    """One process's update on the mean gradient of ``batches`` (item r
    with mesh_rank's draws of row r) from ``ckpt`` with a fresh
    optimizer: (mean loss parts with the total, leaves on the host, the
    mean gradients on the host)."""
    import torch

    from cfun_tpu_torch import weights
    from cfun_tpu_torch.ops.anchors import config_anchors
    from cfun_tpu_torch.train import step as tstep

    params, _ = weights.load_npz(os.path.join(ROOT, ckpt), cfg)
    init, _ = tstep.make_train_step(cfg, config_anchors(cfg))
    state = init(weights.to_device(params, dev))
    anchors = torch.from_numpy(config_anchors(cfg)).to(dev)
    runs = []
    for r, batch in enumerate(batches):
        draws = tstep.draw_train(
            cfg, torch.Generator().manual_seed(TRAIN_SEED + r), dev)
        runs.append(tstep.loss_and_grads(state.params, batch, anchors, cfg,
                                         draws))
    n = len(runs)
    total = sum(t for t, _, _ in runs) / n
    parts = {k: sum(p[k] for _, p, _ in runs) / n for k in runs[0][1]}
    grads = {k: sum(g[k] for _, _, g in runs) / n for k in runs[0][2]}
    host_grads = {k: g.to("cpu", copy=True) for k, g in grads.items()}
    state, metrics = tstep.apply_update(cfg, state, grads, total, parts)
    return ({k: float(v) for k, v in metrics.items()},
            _digest(state.params)[1], host_grads)


def check_mean_gradient(label, recs, want):
    """The mesh's first step against mean_gradient_update's: the metrics
    to MESH_LOSS_RTOL, the gradients the ranks summed and every updated
    leaf within MESH_LEAF_REL of their largest magnitude (the global-norm
    clip would hide a gradient scaled by the mesh's size from the
    parameters).  Returns the worst leaf's error over its magnitude."""
    wparts, wparams, wgrads = want
    gworst, gleaf = worst_rel(recs[0]["grads"], wgrads)
    check(gworst <= MESH_LEAF_REL, f"{label}: the summed gradient {gleaf} "
          f"differs by {gworst:.3g} of its largest magnitude from the "
          "mean gradient")
    got = recs[0]["losses"][0]
    for k, v in wparts.items():
        check(abs(got[k] - v) <= MESH_LOSS_RTOL * abs(v),
              f"{label}: first step {k} {got[k]} against the mean-gradient "
              f"step's {v}")
    worst = 0.0
    for p, v in wparams.items():
        scale = float(v.abs().max())
        err = float((recs[0]["first_params"][p] - v).abs().max())
        check(err <= MESH_LEAF_REL * scale, f"{label}: updated {p} differs "
              f"by {err} from the mean-gradient step (largest {scale})")
        worst = max(worst, err / scale if scale else 0.0)
    print(f"{label}: the first update equals one process's step on the "
          f"mean gradient of the {len(recs)} items: losses {got} vs {wparts}; "
          f"the summed gradients within {gworst:.3g} and every updated leaf "
          f"within {worst:.3g} of their largest magnitude (tolerance "
          f"{MESH_LEAF_REL:g})", flush=True)
    return worst


def cli_mesh_refusal(tmp):
    """The heart CLI's ``train --mesh N`` with N one more than the cards
    visible stops with exit code 2, naming the count."""
    import io

    import torch

    from cfun_tpu_torch.cli import heart_main

    n = torch.cuda.device_count() + 1
    err, code = io.StringIO(), None
    with contextlib.redirect_stderr(err):
        try:
            heart_main.main(["train", "--weights", "none", "--stage",
                             "beginning", "--data", tmp, "--mesh", str(n)])
        except SystemExit as e:
            code = e.code
    visible = f"only {n - 1} CUDA device(s) are visible"
    check(code == 2 and visible in err.getvalue(),
          f"train --mesh {n}: exit {code}, {err.getvalue()!r}")
    print(f"cli: heart_main train --mesh {n} on {n - 1} card(s) stops with "
          f"exit code 2: {err.getvalue().strip().splitlines()[-1]}",
          flush=True)


def unet_grads_float64(cfg, params, crops, tgt, draws, edge_on=True):
    """The mask and (with ``edge_on``) edge losses' gradients with respect
    to the U-Net's leaves with every operation in float64 (the
    instance-norm statistics and both losses too), on the crops, targets
    and dropout masks a step used: the reference both float32 evaluations
    are held to.  Each ROI's edge term is checkpointed, as in the step."""
    import torch
    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint

    from cfun_tpu_torch import nn as pnn
    from cfun_tpu_torch import weights
    from cfun_tpu_torch.models.heads import apply_mask_head
    from cfun_tpu_torch.train.losses import _SOBEL

    def inorm64(x, eps=1e-5):
        dims = tuple(range(2, x.dim()))
        diff = x - x.mean(dim=dims, keepdim=True)
        return diff * torch.rsqrt(torch.mean(diff * diff, dim=dims,
                                             keepdim=True) + eps)

    sobel = torch.from_numpy(_SOBEL).to(crops.device, torch.float64)

    def roi_se(t, q):
        g_true = F.conv3d(t[1:, None], sobel)
        g_pred = F.conv3d(q[1:, None], sobel)
        m_true = torch.sqrt(torch.sum(g_true ** 2, dim=1) + 1e-12)
        m_pred = torch.sqrt(torch.sum(g_pred ** 2, dim=1) + 1e-12)
        return torch.sum(torch.mean((m_pred - m_true) ** 2, dim=(1, 2, 3)))

    unet = {k: v.detach().double().requires_grad_(True)
            for k, v in weights._leaves(params["mask"]["unet"]).items()}
    saved, pnn.instance_norm = pnn.instance_norm, inorm64
    try:
        logits = apply_mask_head(
            {"unet": weights._unflatten(unet)}, crops.double(),
            stage=cfg.stage, dropout_rate=cfg.unet_dropout_rate,
            dropout_masks=draws.dropout_masks, dtype=torch.float64,
            head_impl="explicit", up_impl="explicit")
    finally:
        pnn.instance_norm = saved
    t, pos = tgt.masks.double(), tgt.pos_valid.double()
    ce = torch.logsumexp(logits, dim=1) - torch.sum(logits * t, dim=1)
    valid = pos[:, None, None, None].expand(ce.shape)
    mask_l = torch.sum(ce * valid) / torch.clamp(torch.sum(valid), min=1.0)
    w = cfg.loss_weight_dict
    loss = w["mrcnn_mask_loss"] * mask_l
    if edge_on:
        probs = torch.softmax(logits, dim=1)
        se = torch.stack([checkpoint(roi_se, t[i], probs[i],
                                     use_reentrant=False)
                          for i in range(t.shape[0])])
        edge_l = torch.sum(se * pos) / torch.clamp(torch.sum(pos), min=1.0)
        loss = loss + w["mrcnn_mask_edge_loss"] * edge_l
    grads = torch.autograd.grad(loss, list(unet.values()), allow_unused=True)
    return {f"mask/unet/{p}": g.float().cpu() for p, g in zip(unet, grads)
            if g is not None}


def worst_rel(got, want):
    """(the largest over the leaves of max |got - want| over the leaf's
    largest magnitude in ``want``, that leaf)."""
    worst, leaf = 0.0, None
    for p, w in want.items():
        scale = float(w.abs().max())
        if scale:
            err = float((got[p] - w).abs().max()) / scale
            if err > worst:
                worst, leaf = err, p
    return worst, leaf


def split_vs_dense(label, cfg, ckpt, batch, dev, tmp, devices=None,
                   backend="gloo"):
    """A float32 ``cfg`` (TF32 off) on a (1, 2) mesh, whose two space ranks
    split the trunk along H and, with shard_unet_spatial, the mask U-Net
    and its losses along D.  First one dense step in this process: its
    loss parts and gradients, and where the U-Net is split the float64
    evaluation of its U-Net gradients on its crops
    (:func:`unet_grads_float64`).  Then MESH_STEPS[label] steps of the mesh
    (two ``backend`` ranks on ``devices``, by default two gloo ranks on
    ``dev``; run_mesh's checks): the first step's loss parts to
    SPLIT_LOSS_RTOL of the dense step's, every other gradient the ranks
    summed (the trunk's, the heads') within SPLIT_LEAF_REL of its largest
    magnitude from the dense one, and the split U-Net's as close to the
    float64 ones as the dense step's (within SHARD_F64_FACTOR times the
    dense step's largest gap, or SHARD_GRAD_FLOOR, of each leaf's largest
    magnitude); the peak memory by rank beside the dense step's.  Returns
    (launches, record)."""
    import torch

    from cfun_tpu_torch import weights
    from cfun_tpu_torch.ops.anchors import config_anchors
    from cfun_tpu_torch.train import step as tstep

    cuda = dev.type == "cuda"
    split_unet = cfg.shard_unet_spatial and tstep.stage_flags(cfg)[1]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seen = {}
    orig_roi, orig_targets = tstep.roi_align, tstep.detection_targets

    def roi(*args, **kw):
        seen["crops"] = orig_roi(*args, **kw)
        return seen["crops"]

    def targets(*args, **kw):
        seen["targets"] = orig_targets(*args, **kw)
        return seen["targets"]

    try:
        params, _ = weights.load_npz(os.path.join(ROOT, ckpt), cfg)
        init, _ = tstep.make_train_step(cfg, config_anchors(cfg))
        state = init(weights.to_device(params, dev))
        del params
        draws = tstep.draw_train(
            cfg, torch.Generator().manual_seed(TRAIN_SEED), dev)
        _sync(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else None
        t0 = time.perf_counter()
        tstep.roi_align, tstep.detection_targets = roi, targets
        try:
            _, parts, grads = tstep.loss_and_grads(
                state.params, batch,
                torch.from_numpy(config_anchors(cfg)).to(dev), cfg, draws)
        finally:
            tstep.roi_align, tstep.detection_targets = (orig_roi,
                                                        orig_targets)
        _sync(dev)
        dense_s = time.perf_counter() - t0
        dense_peak = torch.cuda.max_memory_allocated() if cuda else None
        dense_parts = {k: float(v) for k, v in parts.items()}
        dense_grads = {p: g.to("cpu", copy=True) for p, g in grads.items()}
        del grads, parts
        f64 = (unet_grads_float64(cfg, state.params, seen["crops"],
                                  seen["targets"], draws,
                                  edge_on=tstep.stage_flags(cfg)[2])
               if split_unet else None)
        del state, seen
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    if cuda:
        torch.cuda.empty_cache()
    launches, rs = run_mesh(label, cfg, ckpt, [batch], MESH_STEPS[label],
                            (1, 2), devices or [str(dev)] * 2, backend, tmp,
                            grads_of="")
    got, summed = rs[0]["losses"][0], rs[0]["grads"]
    for k, want in dense_parts.items():
        check(abs(got[k] - want) <= SPLIT_LOSS_RTOL * abs(want),
              f"{label}: {k} {got[k]} against the dense step's {want}")
    unet = {p for p in dense_grads if p.startswith("mask/unet/")}
    check(sorted(summed) == sorted(dense_grads),
          f"{label}: the mesh's gradient leaves are the dense step's")
    rest, rest_leaf = worst_rel(summed, {p: g for p, g in dense_grads.items()
                                         if p not in unet})
    check(rest <= SPLIT_LEAF_REL, f"{label}: the summed gradient "
          f"{rest_leaf} is {rest:.3g} of its largest magnitude from the "
          f"dense step's (tolerance {SPLIT_LEAF_REL:g})")
    rec = dict(_slim(rs), dense_losses=dense_parts,
               dense_peak_bytes=dense_peak, dense_s=dense_s,
               split_vs_dense_trunk_head_grad_rel=rest)
    unet_note = ""
    if split_unet:
        dense_f64, dense_leaf = worst_rel({p: dense_grads[p] for p in unet},
                                          f64)
        shard_f64, shard_leaf = worst_rel(summed, f64)
        worst, worst_leaf = worst_rel(summed, {p: dense_grads[p]
                                               for p in unet})
        tol = max(SHARD_F64_FACTOR * dense_f64, SHARD_GRAD_FLOOR)
        check(shard_f64 <= tol, f"{label}: the split U-Net's gradient "
              f"{shard_leaf} is {shard_f64:.3g} of its largest magnitude "
              f"from the float64 one; the dense step's is {dense_f64:.3g} "
              f"({dense_leaf}; tolerance {tol:.3g})")
        unet_note = (f"; U-Net gradients against the float64 evaluation: "
                     f"split {shard_f64:.3g} ({shard_leaf}), dense "
                     f"{dense_f64:.3g} ({dense_leaf}) of a leaf's largest "
                     f"magnitude (tolerance {tol:.3g}); split against dense "
                     f"{worst:.3g} ({worst_leaf})")
        rec.update(split_vs_dense_unet_grad_rel=worst,
                   split_vs_float64=shard_f64, dense_vs_float64=dense_f64)
    print(f"{label} (float32, TF32 off; trunk split along H"
          f"{', U-Net along D' if split_unet else ''}): loss parts {got} "
          f"against the dense step's {dense_parts}; trunk and head "
          f"gradients within {rest:.3g} ({rest_leaf}) of a leaf's largest "
          f"magnitude{unet_note}; peak memory by rank "
          f"{[r['peak_bytes'] for r in rs]} B against the dense step's "
          f"{dense_peak} B ({base} B allocated before it; the dense step "
          f"{dense_s:.3f} s)", flush=True)
    return launches, rec


def mesh_heart(tmp, dev):
    """Phase mesh_heart: (1, 1) under NCCL against the plain step, bit for
    bit; (2, 1) on two gloo ranks on one card against the mean-gradient
    step; (1, 2) 'beginning' and 'finetune' (the trunk split along H, the
    U-Net along D) against the dense step; the CLI's refusal.  Returns
    (launches by path, records)."""
    import torch

    from cfun_tpu_torch import config as port_config

    ckpt, ckpt_ft = CHECKPOINTS["heart"]
    launches, recs = {}, {}
    cfg = port_config.heart_config("beginning")
    batches = [heart_train_batch(cfg, dev, i) for i in (0, 1)]

    # (1, 1): the distributed path under NCCL, world size 1
    n = MESH_STEPS["heart 1x1"]
    secs, losses, digests = plain_steps("heart 1x1", cfg, ckpt, batches[0],
                                        n, dev)
    launches["mesh_heart_1x1"], rs = run_mesh(
        "heart 1x1", cfg, ckpt, batches[:1], n, (1, 1), "cuda", "nccl", tmp)
    check(rs[0]["backend"] == "nccl", "heart 1x1 under NCCL")
    check(rs[0]["losses"] == losses and rs[0]["digests"] == digests,
          "heart 1x1: losses and parameters bit-equal to the plain step's "
          f"after every step: {[p['total_loss'] for p in losses]}")
    print(f"heart 1x1: bit-equal to the plain step on every one of {n} "
          f"steps; s/step {rs[0]['s_per_step']} against the plain step's "
          f"{secs}", flush=True)
    recs["heart 1x1"] = dict(_slim(rs), plain_s_per_step=secs)

    # (2, 1): two gloo ranks on the one card
    n = MESH_STEPS["heart 2x1"]
    launches["mesh_heart_2x1"], rs = run_mesh(
        "heart 2x1", cfg, ckpt, batches, n, (2, 1), ["cuda:0", "cuda:0"],
        "gloo", tmp, grads_of="")
    worst = check_mean_gradient("heart 2x1", rs, mean_gradient_update(
        cfg, ckpt, batches, dev))
    recs["heart 2x1"] = dict(_slim(rs), worst_leaf_rel=worst)
    del batches
    torch.cuda.empty_cache()

    # (1, 2), float32: the trunk split along H, the U-Net and its losses
    # along D, at 'beginning' and at 'finetune'
    for stage, path in (("beginning", ckpt), ("finetune", ckpt_ft)):
        scfg = port_config.heart_config(stage, compute_dtype="float32",
                                        shard_unet_spatial=True)
        name = f"heart 1x2 {stage}"
        launches[f"mesh_heart_1x2_{stage}"], recs[name] = split_vs_dense(
            name, scfg, path, heart_train_batch(scfg, dev), dev, tmp)
    cli_mesh_refusal(tmp)
    return launches, recs


def mesh_multicard(tmp, dev):
    """Phase multicard (only with the argument 'multicard', on a machine
    with four cards): the mesh under NCCL with one card a rank, heart at
    full width: 'beginning' (4, 1) from heart_synth.npz, 4 steps on
    held-out volumes 0-3, against one process's step on the mean gradient
    of the four (mesh_heart's (2, 1) checks); 'finetune' float32 (1, 2)
    across two cards from heart_synth_ft.npz against the dense step and
    the float64 evaluation (mesh_heart's (1, 2) checks).  Returns
    (launches by path, records)."""
    import torch

    from cfun_tpu_torch import config as port_config

    check(torch.cuda.device_count() >= 4,
          f"multicard needs 4 cards; {torch.cuda.device_count()} visible")
    ckpt, ckpt_ft = CHECKPOINTS["heart"]
    launches, recs = {}, {}
    cfg = port_config.heart_config("beginning")
    batches = [heart_train_batch(cfg, dev, i) for i in range(4)]
    n = MESH_STEPS["heart 4x1 nccl"]
    launches["mesh_heart_4x1_nccl"], rs = run_mesh(
        "heart 4x1 nccl", cfg, ckpt, batches, n, (4, 1), "cuda", "nccl",
        tmp, grads_of="")
    worst = check_mean_gradient("heart 4x1 nccl", rs, mean_gradient_update(
        cfg, ckpt, batches, dev))
    recs["heart 4x1 nccl"] = dict(_slim(rs), worst_leaf_rel=worst)
    del batches
    torch.cuda.empty_cache()
    fcfg = port_config.heart_config("finetune", compute_dtype="float32",
                                    shard_unet_spatial=True)
    launches["mesh_heart_1x2_finetune_nccl"], \
        recs["heart 1x2 finetune nccl"] = split_vs_dense(
            "heart 1x2 finetune nccl", fcfg, ckpt_ft,
            heart_train_batch(fcfg, dev), dev, tmp, devices="cuda",
            backend="nccl")
    return launches, recs


def mesh_lits(tmp, dev, held):
    """Phase mesh_lits: (2, 1) 'beginning' on two gloo ranks on one card
    from lits_synth.npz, on held-out volumes 0 and 1, against the
    mean-gradient step; (1, 2) 'beginning' in float32 (the trunk split
    along H) against the dense step."""
    from cfun_tpu_torch import config as port_config

    cfg = port_config.lits_config("beginning")
    batches = [lits_train_batch(cfg, held[i][0], held[i][1], dev)
               for i in (0, 1)]
    ckpt = CHECKPOINTS["lits"][0]
    launches, rs = run_mesh("lits 2x1", cfg, ckpt, batches,
                            MESH_STEPS["lits 2x1"], (2, 1),
                            ["cuda:0", "cuda:0"], "gloo", tmp, grads_of="")
    worst = check_mean_gradient("lits 2x1", rs, mean_gradient_update(
        cfg, ckpt, batches, dev))
    del batches
    # (1, 2) float32: the P3D35 trunk split along H, checkpointed block by
    # block (remat_trunk)
    scfg = port_config.lits_config("beginning", compute_dtype="float32")
    split_launches, split = split_vs_dense(
        "lits 1x2 beginning", scfg, ckpt,
        lits_train_batch(scfg, held[0][0], held[0][1], dev), dev, tmp)
    return ({"mesh_lits_2x1": launches,
             "mesh_lits_1x2_beginning": split_launches},
            {"lits 2x1": dict(_slim(rs), worst_leaf_rel=worst),
             "lits 1x2 beginning": split})


def _slim(recs):
    """The ranks' records without their parameters, gradients and launch
    shapes (checked in run_mesh)."""
    return {"ranks": [{k: v for k, v in r.items()
                       if k not in ("first_params", "grads", "digests",
                                    "shapes")}
                      for r in recs]}


# phase roofline: calls a captured graph holds (the JAX package's chain)
# and timed singles; the dense forms' GFLOP and GB as cost_of counts them
# must be the same on the card and on 'meta'
ROOFLINE_CHAIN, ROOFLINE_REPS = 8, 5


def _tree_equal(a, b):
    """Every tensor leaf of ``a`` bit-equal to ``b``'s."""
    import torch
    from torch.utils._pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def meta_tree(params):
    """``params`` with every leaf an empty tensor of its shape on 'meta'."""
    import torch

    from cfun_tpu_torch import weights

    return weights._unflatten({k: torch.empty_like(v, device="meta")
                               for k, v in weights._leaves(params).items()})


def roofline_segment(label, fn, args, cost, counters, dev):
    """One segment of phase roofline: ``fn(*args)`` once on a side stream
    (the eager reference and its launches, the warm-up of the capture
    stream), then ROOFLINE_CHAIN calls captured in one CUDA graph on that
    stream (the launches counted in the capture must be the eager call's
    times the captures; a replay runs them again and counts none), one
    replay whose every call's outputs must be bit-equal to the eager
    call's, then ``roofline.time_amortized`` on that graph (and the
    outputs again).  ``cost``: cost_of of the segment's dense form.
    Returns (record, the launches counted in the capture)."""
    import torch

    from cfun_tpu_torch.utils import roofline

    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    reset_counts(counters)
    with torch.cuda.stream(stream):
        ref = fn(*args)
    stream.synchronize()
    eager = {name: mod.launches for name, mod in counters.items()}
    reset_counts(counters)
    chained = roofline.chain_graph(fn, args, ROOFLINE_CHAIN, dev, warmup=0,
                                   stream=stream)
    captured = {name: mod.launches for name, mod in counters.items()}
    check(captured == {k: v * ROOFLINE_CHAIN for k, v in eager.items()},
          f"roofline {label}: launches in the capture {captured}, one eager "
          f"call's {eager} x {ROOFLINE_CHAIN}")
    chained()
    torch.cuda.synchronize(dev)
    check(all(_tree_equal(out, ref) for out in chained.outputs),
          f"roofline {label}: a replayed call's outputs differ from the "
          "eager call's")
    tm = roofline.time_amortized(fn, args, device=dev, reps=ROOFLINE_REPS,
                                 chained=chained)
    replays = 2 + max(2, ROOFLINE_REPS - 1)  # the check's, time's warm-up
    check(all(_tree_equal(out, ref) for out in chained.outputs),
          f"roofline {label}: outputs after {replays} replays")
    gen = roofline.chip_generation(dev)
    rep = roofline.segment_report(tm["kernel_s"], gen=gen, **cost)
    rep_replay = roofline.segment_report(tm["replay_s"], gen=gen, **cost)
    rec = {"gflop": rep["gflop"], "gbytes": rep["gbytes"],
           "single_ms": tm["single_s"] * 1e3, "chain_ms": tm["chain_s"] * 1e3,
           "kernel_ms": tm["kernel_s"] * 1e3,
           "replay_ms": tm["replay_s"] * 1e3,
           "dispatch_ms": tm["dispatch_s"] * 1e3, "chain": tm["chain"],
           "tflops_per_s": rep["tflops_per_s"], "mfu": rep["mfu"],
           "hbm_bw_util": rep["hbm_bw_util"],
           "replay_tflops_per_s": rep_replay["tflops_per_s"],
           "replay_mfu": rep_replay["mfu"],
           "replay_hbm_bw_util": rep_replay["hbm_bw_util"],
           "launches_eager": eager, "launches_captured": captured,
           "replays": replays,
           "launches_replayed": {k: v * replays for k, v in captured.items()}}
    print(f"roofline {label}: {rec['gflop']} GFLOP, {rec['gbytes']} GB "
          f"(dense form, cost_of); single {rec['single_ms']:.3f} ms, kernel "
          f"{rec['kernel_ms']:.3f} ms, replay {rec['replay_ms']:.3f} ms, "
          f"dispatch {rec['dispatch_ms']:.3f} ms; kernel: "
          f"{rec['tflops_per_s']} TFLOP/s, mfu {rec['mfu']}, hbm_bw_util "
          f"{rec['hbm_bw_util']}; replay: {rec['replay_tflops_per_s']} "
          f"TFLOP/s, mfu {rec['replay_mfu']}, hbm_bw_util "
          f"{rec['replay_hbm_bw_util']}; launches eager {eager}, in the "
          f"capture {captured} ({ROOFLINE_CHAIN} captures x {replays} "
          "replays run them again); every replayed output bit-equal to the "
          "eager call's", flush=True)
    del chained
    torch.cuda.empty_cache()
    return rec, captured


def roofline_path(label, det, dense_det, vol, counters, dev):
    """Phase roofline on one served path: the trunk, the mask head and the
    whole packed request (``roofline.packed_infer_program``) of ``det``,
    each through :func:`roofline_segment`, counted on ``dense_det`` (the
    same configuration with pallas_unet=False, the same parameters).  The
    trunk takes a seeded volume of the molded shape in the compute dtype,
    the mask head the served crops of ``vol``; the trunk's and the mask
    head's counts on the card must equal their counts on 'meta'.  Returns
    (records by segment, the request capture's launches)."""
    import torch

    from cfun_tpu_torch.models import cfun
    from cfun_tpu_torch.models.heads import apply_mask_head
    from cfun_tpu_torch.utils import roofline

    cfg, params = det.cfg, det.params
    dt = cfun.compute_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    image = torch.randn((1, 1, *cfg.image_shape), generator=gen,
                        device=dev).to(dt)
    crops = capture_crop(cfun, det, vol)

    def trunk(p, im):
        with torch.inference_mode():
            return cfun.apply_trunk(p, im, cfg)

    def head(fused):
        def run(p, c):
            with torch.inference_mode():
                return apply_mask_head(p["mask"], c, stage=cfg.stage,
                                       dtype=dt, fused=fused)
        return run

    recs = {}
    meta = meta_tree(params)
    for seg, fn, dense_fn, args in (
            ("trunk", trunk, trunk, (params, image)),
            ("mask_head", head(cfg.pallas_unet), head(False),
             (params, crops))):
        meta_args = (meta, *(a.to("meta") for a in args[1:]))
        # one call first on each: the phase up-convs' kernels are composed
        # at a leaf's first use and kept (nn.py::_phase_kernel), once, not
        # a call's work
        dense_fn(*args)
        dense_fn(*meta_args)
        cost = roofline.cost_of(dense_fn, *args)
        on_meta = roofline.cost_of(dense_fn, *meta_args)
        check(cost == on_meta, f"roofline {label} {seg}: cost_of on the card "
              f"{cost} against 'meta' {on_meta}")
        recs[seg], _ = roofline_segment(f"{label} {seg}", fn, args, cost,
                                        counters, dev)
    wire, window, _ = det.mold(vol)
    fn, args = roofline.packed_infer_program(det, vol, molded=(wire, window))
    dfn, dargs = roofline.packed_infer_program(dense_det, vol,
                                               molded=(wire, window))
    cost = roofline.cost_of(dfn, *dargs)
    recs["request"], captured = roofline_segment(f"{label} request", fn,
                                                 args, cost, counters, dev)
    del crops, image
    torch.cuda.empty_cache()
    return recs, captured


def roofline_step(label, cfg, ckpt, batch, s_per_step, dev):
    """The mfu of an isolated train step: cost_of one step's forward and
    backward (``loss_and_grads``, K1 not counted) on the card, over the
    median s/step its train phase measured (the optimizer and the host's
    part of the step included)."""
    import torch

    from cfun_tpu_torch import weights
    from cfun_tpu_torch.ops.anchors import config_anchors
    from cfun_tpu_torch.train import step as tstep
    from cfun_tpu_torch.utils import roofline

    params, _ = weights.load_npz(os.path.join(ROOT, ckpt), cfg)
    init, _ = tstep.make_train_step(cfg, config_anchors(cfg))
    state = init(weights.to_device(params, dev))
    anchors = torch.from_numpy(config_anchors(cfg)).to(dev)
    draws = tstep.draw_train(cfg, torch.Generator().manual_seed(TRAIN_SEED),
                             dev)
    cost = roofline.cost_of(tstep.loss_and_grads, state.params, batch,
                            anchors, cfg, draws)
    rep = roofline.segment_report(s_per_step, gen=roofline.chip_generation(
        dev), **cost)
    print(f"roofline {label} train step: {rep['gflop']} GFLOP, "
          f"{rep['gbytes']} GB a step (forward and backward, cost_of) over "
          f"{s_per_step:.4f} s/step: {rep['tflops_per_s']} TFLOP/s, mfu "
          f"{rep['mfu']}, hbm_bw_util {rep['hbm_bw_util']}", flush=True)
    del state, params
    torch.cuda.empty_cache()
    return dict(rep, s_per_step=s_per_step)


def bench_keys(recs, floor_ms, gen):
    """bench.py's roofline extras (bench.py:229-271) from the dense heart
    path's trunk and mask head ('unet')."""
    out = {}
    for name, seg in (("trunk", "trunk"), ("unet", "mask_head")):
        r = recs[seg]
        out[f"{name}_mfu"] = r["mfu"]
        out[f"{name}_ms"] = round(r["single_ms"], 1)
        out[f"{name}_kernel_ms"] = round(r["kernel_ms"], 1)
        out[f"{name}_gflop"] = r["gflop"]
    out["dispatch_floor_ms"] = round(floor_ms, 2)
    out["chip"] = gen
    return out


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr, flush=True)
        return 2
    args = sys.argv[1:]
    schedule = bool(args) and args[0] == "schedule"
    multicard = args == ["multicard"]
    if (len(args) > (2 if schedule else 1)
            or (args and not (schedule or multicard)
                and args[0] not in CHECKPOINTS)):
        print(f"usage: chip_smoke.py [{' | '.join(CHECKPOINTS)} | "
              f"schedule [START.npz] | multicard]", file=sys.stderr,
              flush=True)
        return 2
    families = () if schedule or multicard else tuple(args) if args else \
        tuple(CHECKPOINTS)
    heart, lits = "heart" in families, "lits" in families
    need = CHECKPOINTS["heart"] if multicard else [
        p for f in families for p in CHECKPOINTS[f]]
    missing = [p for p in need if not os.path.isfile(os.path.join(ROOT, p))]
    if missing:
        print(f"chip_smoke: missing checkpoint(s) {missing} for "
              f"{'/'.join(families) or args[0]}", file=sys.stderr,
              flush=True)
        return 1
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
    from cfun_tpu_torch.utils import roofline

    counters = {"sorted_nms": k1, "fused_conv3d": k2}
    dev = torch.device("cuda", 0)
    # by path: {kernel: launches}, request timings, device busy, peak bytes
    launches_by_path, request_ms, busy, peak = {}, {}, {}, {}
    # by family: the CLI runs' per-volume stages, bytes, Dice
    cli_stats = {}
    # by train path: steps, s/step, peak bytes, losses, K1 at its shape
    training = {}
    # phase roofline: by served path, its segments' records
    roof = {}
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

    if multicard:
        with phase("multicard"):
            tmp = tempfile.mkdtemp(prefix="cfun_multicard_")
            try:
                launches, rec = mesh_multicard(tmp, dev)
            finally:
                shutil.rmtree(tmp)
        print(json.dumps({"multicard": rec, "launches_by_path": launches}),
              flush=True)
        print(card, flush=True)
        faulthandler.cancel_dump_traceback_later()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if schedule:
        with phase("schedule"):
            tmp = tempfile.mkdtemp(prefix="cfun_schedule_")
            try:
                _, rec = schedule_phase(tmp, counters, k1, dev,
                                        *args[1:])
            finally:
                shutil.rmtree(tmp)
        print(json.dumps({"schedule": rec}), flush=True)
        print(card, flush=True)
        faulthandler.cancel_dump_traceback_later()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    with phase("k2"):
        for i, (b, ci, co, d, h, w, pre) in enumerate(K2_EDGE):
            k2_check(k2, k2_inputs(b, ci, co, d, h, w, 100 + i, dev), pre,
                     f"edge B={b} {ci}->{co} {d}x{h}x{w} pre_lrelu={pre}")
        print(f"k2 within tolerance and deterministic on {len(K2_EDGE)} "
              f"edge cases", flush=True)

    with phase("train_tiny"):
        # full float32 on the card (cuDNN convs default to TF32)
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            launches_by_path["train_tiny"], training["tiny"] = train_tiny(
                k1, counters, dev)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32

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

        with phase("train_heart"):
            for stage, wname in (("beginning", "heart_synth.npz"),
                                 ("finetune", "heart_synth_ft.npz")):
                label = f"heart {stage}"
                tcfg = port_config.heart_config(stage)
                tparams, _ = weights.load_npz(
                    os.path.join(ROOT, "weights", wname), tcfg)
                rec = training[label] = train_path(
                    f"train_heart {stage}", tcfg,
                    weights.to_device(tparams, dev),
                    heart_train_batch(tcfg, dev), TRAIN_STEPS[label],
                    counters, k1)
                launches_by_path[f"train_heart_{stage}"] = rec["launches"]
                check(min(rec["n_pos"]) >= 1,
                      f"{label}: a positive ROI on every step {rec['n_pos']}")
                del tparams
                torch.cuda.empty_cache()

        with phase("roofline"):
            floor_ms = roofline.measure_dispatch_floor(dev) * 1e3
            gen = roofline.chip_generation(dev)
            print(f"roofline: {card}: peaks {gen} {roofline.PEAKS[gen]}; "
                  f"dispatch floor {floor_ms:.4f} ms", flush=True)
            ft_dense = Detector(tcfg_ft.replace(pallas_unet=False),
                                ftdet.params)
            for path, d, dense in (("serve", det, det),
                                   ("serve_fused", fdet, det),
                                   ("serve_ft", ftdet, ft_dense)):
                roof[path], launches_by_path[f"roofline_{path}"] = \
                    roofline_path(path, d, dense, vols[0], counters, dev)
            ft_dense.close()
            del ft_dense
            roof["bench_keys"] = bench_keys(roof["serve"], floor_ms, gen)
            print(f"roofline bench.py keys (serve): "
                  f"{json.dumps(roof['bench_keys'])}", flush=True)
            tcfg = port_config.heart_config("beginning")
            roof["train_heart_beginning"] = roofline_step(
                "heart beginning", tcfg, CHECKPOINTS["heart"][0],
                heart_train_batch(tcfg, dev),
                training["heart beginning"]["median_s_per_step_after_first"],
                dev)
            roof["dispatch_floor_ms"] = floor_ms
            torch.cuda.empty_cache()

        with phase("train_loop_heart"):
            tmp = tempfile.mkdtemp(prefix="cfun_loop_heart_")
            try:
                loop_launches, loop_recs = train_loop_heart(tmp, counters,
                                                            k1, dev)
            finally:
                shutil.rmtree(tmp)
            launches_by_path.update(loop_launches)
            training.update({f"loop {k}": v for k, v in loop_recs.items()})
            torch.cuda.empty_cache()

        with phase("mesh_heart"):
            tmp = tempfile.mkdtemp(prefix="cfun_mesh_heart_")
            try:
                mesh_launches, mesh_recs = mesh_heart(tmp, dev)
            finally:
                shutil.rmtree(tmp)
            launches_by_path.update(mesh_launches)
            training.update({f"mesh {k}": v for k, v in mesh_recs.items()})
            torch.cuda.empty_cache()

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

        with phase("roofline"):
            lfloor_ms = roofline.measure_dispatch_floor(dev) * 1e3
            print(f"roofline: {card}: dispatch floor {lfloor_ms:.4f} ms",
                  flush=True)
            for path, d in (("serve_lits", ldet), ("serve_lits_fused", lfdet)):
                roof[path], launches_by_path[f"roofline_{path}"] = \
                    roofline_path(path, d, ldet, held[0][0], counters, dev)
            roof["lits_dispatch_floor_ms"] = lfloor_ms
            torch.cuda.empty_cache()

        with phase("cli_lits"):
            tmp = tempfile.mkdtemp(prefix="cfun_cli_lits_")
            try:
                cli_launches, cli_stats["lits"] = cli_lits_phase(
                    tmp, counters, {s: c // nl for s, c in
                                    lshapes["sorted_nms"].items()}, held)
            finally:
                shutil.rmtree(tmp)
            launches_by_path.update(cli_launches)

        with phase("train_lits"):
            tcfg = port_config.lits_config("beginning")
            # the tree is the same at every stage (cfun_tpu/config.py:8-9);
            # a fresh copy, since the step updates its leaves in place
            tparams, _ = weights.load_npz(lpath, tcfg)
            # from the trained checkpoint the RPN's updates move the
            # proposals (so the ROI sample) and the shared trunk, and the
            # classifier's loss rises over a few steps; the first
            # update's descent on the held objective is checked
            rec = training["lits beginning"] = train_path(
                "train_lits beginning", tcfg,
                weights.to_device(tparams, dev),
                lits_train_batch(tcfg, held[0][0], held[0][1], dev),
                TRAIN_STEPS["lits beginning"], counters, k1,
                falls_by_last=False)
            launches_by_path["train_lits_beginning"] = rec["launches"]
            del tparams
            torch.cuda.empty_cache()

        with phase("train_loop_lits"):
            tmp = tempfile.mkdtemp(prefix="cfun_loop_lits_")
            try:
                launches_by_path["train_loop_lits_cli"], \
                    training["loop lits cli"] = train_loop_lits(
                        tmp, counters, k1, dev)
            finally:
                shutil.rmtree(tmp)
            torch.cuda.empty_cache()

        with phase("mesh_lits"):
            tmp = tempfile.mkdtemp(prefix="cfun_mesh_lits_")
            try:
                mesh_launches, mesh_recs = mesh_lits(tmp, dev, held)
            finally:
                shutil.rmtree(tmp)
            launches_by_path.update(mesh_launches)
            training.update({f"mesh {k}": v for k, v in mesh_recs.items()})
            torch.cuda.empty_cache()

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
        # the whole request's graph replays against the profiled requests'
        # device busy (which also holds the wire's upload and the output's
        # copy down)
        for path, b in busy.items():
            req = roof.get(path, {}).get("request")
            if req:
                print(f"profile vs roofline {path}: device busy {b:.3f} ms a "
                      f"request; the packed program's kernel "
                      f"{req['kernel_ms']:.3f} ms ({req['kernel_ms'] / b:.3f}"
                      f" of busy), replay {req['replay_ms']:.3f} ms "
                      f"({req['replay_ms'] / b:.3f}), single "
                      f"{req['single_ms']:.3f} ms, dispatch "
                      f"{req['dispatch_ms']:.3f} ms", flush=True)
                req["profile_busy_ms"] = b

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
    for path in ("serve_fused", "serve_ft", "serve_lits_fused",
                 "roofline_serve_fused", "roofline_serve_ft",
                 "roofline_serve_lits_fused"):
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
        "per_shape": [s for sites in k1_paths.values() for s in sites] +
                     [rec["k1"] for rec in training.values() if "k1" in rec],
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
    serving["serving"]["training"] = training
    serving["serving"]["roofline"] = roof
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
