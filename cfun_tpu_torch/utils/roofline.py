"""Roofline / MFU accounting on the card (port of
``cfun_tpu/utils/roofline.py``).

MFU = flops / seconds / peak FLOP/s and bandwidth utilization = bytes /
seconds / peak bytes/s, with the peaks of the card's row in ``PEAKS``.
The JAX package takes FLOPs and bytes from XLA's cost analysis of a
compiled program; PyTorch compiles nothing, so :func:`cost_of` counts
them over one eager run (its docstring names the conventions).  Times
come from the host clock around a synchronized call and from CUDA events
around a replay of a CUDA graph (:func:`chain_graph`,
:func:`time_amortized`).

Every function that times anything takes its device; a CUDA card whose
peaks are not in ``PEAKS`` raises (:func:`chip_generation`), so no number
is ever reported against a guessed roof.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# peak dense-matmul FLOP/s (compute dtype bf16, tensor cores) and device
# memory bandwidth, B/s.  H100 SXM: NVIDIA's data sheet, at the full
# 700 W power limit.
PEAKS: Dict[str, Dict[str, float]] = {
    "h100_sxm": {"flops_bf16": 989e12, "hbm_bw": 3.35e12},
    "cpu": {"flops_bf16": float("nan"), "hbm_bw": float("nan")},
}

# CUDA device names (torch.cuda.get_device_name) -> PEAKS key
_CARDS = {"NVIDIA H100 80GB HBM3": "h100_sxm"}


def generation_of_name(name: str) -> str:
    """The ``PEAKS`` key of a CUDA card by its device name.  Raises
    ValueError, naming the card, for one whose peaks are not known."""
    gen = _CARDS.get(name.strip())
    if gen is None:
        raise ValueError(f"no peak FLOP/s or bandwidth known for the card "
                         f"{name!r}; known cards: {sorted(_CARDS)}")
    return gen


def chip_generation(device) -> str:
    """The ``PEAKS`` key of ``device``: 'cpu' for the CPU, else the
    card's by its name (:func:`generation_of_name`)."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise ValueError(f"no peaks for device type {device.type!r}")
    return generation_of_name(torch.cuda.get_device_name(device))


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every dispatched op's tensor inputs and outputs;
    views (which move nothing) are left out."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def cost_of(fn: Callable, *args) -> Dict[str, float]:
    """{'flops', 'bytes_accessed'} of one eager run of ``fn(*args)``;
    splats straight into :func:`segment_report`.

    Conventions (they differ from XLA's cost analysis in the JAX
    package):

    * FLOPs are PyTorch's ``FlopCounterMode``: the products (matmul, bmm,
      convolution, forward and backward), 2 a multiply-add, with every
      tap of a padded convolution counted (XLA counts only the in-bounds
      taps); elementwise ops count none (XLA counts them).
    * bytes are each dispatched op's tensor inputs and outputs, views
      excluded: every eager op reads and writes device memory, with no
      fusion.
    * a hand-written kernel launched through ctypes (``ops/sorted_nms.py``,
      ``ops/fused_conv.py``) is not dispatched, so it is not counted:
      count a segment that launches one on its dense form
      (``pallas_unet=False``), which computes the same convolutions.

    The run works on ``meta`` tensors too (shapes only, no compute);
    the counts depend only on the shapes and dtypes."""
    with FlopCounterMode(display=False) as flops, _ByteCounter() as nbytes:
        fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(nbytes.bytes)}


class ChainGraph:
    """``length`` calls of ``fn(*args)`` as one callable: on CUDA one
    ``torch.cuda.CUDAGraph`` captured from them, replayed by a call; on
    the CPU the eager calls.  ``outputs``: each call's outputs (on CUDA the
    graph's own tensors, which every replay writes again)."""

    def __init__(self, fn: Callable, args: Sequence, length: int, device,
                 warmup: int = 2, stream=None):
        self.device = torch.device(device)
        self.length = length
        self._fn, self._args = fn, tuple(args)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: List = []
        if self.device.type != "cuda":
            return
        # warm-up on the capture stream: cuDNN's plans, constants made at
        # the first call, workspaces kept by stream
        self.stream = stream or torch.cuda.Stream(self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for _ in range(warmup):
                fn(*args)
        self.stream.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self.stream):
            self.outputs = [fn(*args) for _ in range(length)]
        torch.cuda.synchronize(self.device)

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
        else:
            self.outputs = [self._fn(*self._args) for _ in range(self.length)]


def chain_graph(fn: Callable, args: Sequence, length: int, device,
                warmup: int = 2, stream=None) -> ChainGraph:
    """``length`` calls of ``fn(*args)`` as one graph on CUDA, captured on
    ``stream`` (a new side stream by default) after ``warmup`` eager calls
    on it, or as ``length`` eager calls on the CPU (:class:`ChainGraph`).
    A graph replays every kernel of every call, so nothing is hoisted and
    no perturbation is needed."""
    return ChainGraph(fn, args, length, device, warmup, stream)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_amortized(fn: Callable, args: Sequence, *, device, reps: int = 5,
                   chain: int = 8,
                   chained: Optional[ChainGraph] = None) -> Dict[str, float]:
    """Per-call wall AND amortized kernel time of ``fn(*args)`` on
    ``device``.

    ``single_s``: one eager call, host clock from before it to after a
    synchronize (the host's enqueue and the device's work).  ``chain_s``:
    one call of the chain of ``chain`` calls (``chained``, else
    :func:`chain_graph` made here): on CUDA a graph replay between CUDA
    events, on the CPU the host clock.  Then, as in the JAX package,

        kernel_s   = (chain_s - single_s) / (chain - 1), at most single_s
        dispatch_s = max(single_s - kernel_s, 0)

    On CUDA also ``replay_s = chain_s / chain``: the device's own time a
    call.  Medians over ``reps`` singles and ``max(2, reps - 1)`` chains.
    Returns {'single_s', 'chain_s', 'kernel_s', 'dispatch_s', 'chain'}
    (+ 'replay_s' on CUDA)."""
    device = torch.device(device)
    if chained is None:
        chained = chain_graph(fn, args, chain, device)
    chain = chained.length
    cuda = device.type == "cuda"
    fn(*args)  # warm
    chained()
    _sync(device)
    t1, tn = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        t1.append(time.perf_counter() - t0)
    for _ in range(max(2, reps - 1)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chained()
            end.record()
            end.synchronize()
            tn.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            chained()
            tn.append(time.perf_counter() - t0)
    single_s = _median(t1)
    chain_s = _median(tn)
    kernel_s = max(chain_s - single_s, 0.0) / max(chain - 1, 1)
    # a kernel can't be slower than its own single call (dispatch >= 0)
    kernel_s = min(kernel_s, single_s)
    out = {"single_s": single_s, "chain_s": chain_s, "kernel_s": kernel_s,
           "dispatch_s": max(single_s - kernel_s, 0.0), "chain": chain}
    if cuda:
        out["replay_s"] = chain_s / chain
    return out


def _median(xs) -> float:
    """True median (mean of the middle pair for even counts)."""
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def measure_dispatch_floor(device, reps: int = 7) -> float:
    """Median wall seconds of a one-element add and a synchronize on
    ``device``: the per-call floor of the host's launch and wait."""
    device = torch.device(device)
    x = torch.zeros(1, device=device)
    x + 1.0  # warm
    _sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        x + 1.0
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return _median(ts)


def segment_report(seconds: float, flops: float,
                   bytes_accessed: float = float("nan"),
                   gen: Optional[str] = None) -> Dict[str, float]:
    """Roofline numbers for one timed segment against ``PEAKS[gen]``
    (``gen`` by default the current CUDA card's)."""
    peaks = PEAKS[gen or chip_generation(torch.device("cuda"))]
    if seconds <= 0:
        # a chained measurement can resolve to 0 kernel time; keep the
        # same NaN guards and key schema as the normal path (a bare NaN
        # token would break a JSON line)
        out = {"seconds": 0.0,
               "gflop": round(flops / 1e9, 2) if flops == flops else None,
               "tflops_per_s": None, "mfu": None}
        if bytes_accessed == bytes_accessed:
            out["gbytes"] = round(bytes_accessed / 1e9, 3)
            out["hbm_bw_util"] = None
        return out
    tflops = flops / seconds / 1e12
    out = {
        "seconds": round(seconds, 5),
        "gflop": round(flops / 1e9, 2) if flops == flops else None,
        "tflops_per_s": round(tflops, 2) if tflops == tflops else None,
    }
    mfu = flops / seconds / peaks["flops_bf16"]
    out["mfu"] = round(mfu, 4) if not math.isnan(mfu) else None
    if bytes_accessed == bytes_accessed:  # not NaN
        out["gbytes"] = round(bytes_accessed / 1e9, 3)
        bw = bytes_accessed / seconds / peaks["hbm_bw"]
        out["hbm_bw_util"] = round(bw, 4) if not math.isnan(bw) else None
    return out


def packed_infer_program(det, vol, molded=None):
    """(fn, args): the device program ``Detector.detect`` runs on one
    volume, ``cfun.infer_forward`` + ``pack_fast_output`` on its molded
    wire, returning the packed int8 buffer.  ``det.mold(vol)`` runs once
    here (or ``molded``, a (wire, window) pair, is taken), and the window
    goes to the device here too: its upload records an event on a
    page-locked buffer, which a captured graph must not hold."""
    from cfun_tpu_torch.models import cfun

    if not det._packed:
        raise ValueError("packed_infer_program: the detector's config has "
                         "no packed output (fast_unmold, <= 16 classes)")
    wire, window = molded if molded is not None else det.mold(vol)[:2]
    win = det._device_window(window)
    params, anchors, cfg, bits = det.params, det.anchors, det.cfg, \
        det.pack_bits

    @torch.inference_mode()
    def program(image):
        out = cfun.infer_forward(params, image, anchors, win, cfg)
        return cfun.pack_fast_output(out, bits=bits)

    return program, (wire,)


def packed_infer_chain(det, vol, *, reps: int = 3, chain: int = 8,
                       molded=None) -> Dict[str, float]:
    """:func:`time_amortized` of a Detector's FULL packed infer program
    (:func:`packed_infer_program`) on its device: ``kernel_s`` and, on
    CUDA, ``replay_s`` are the whole served graph's device time a call."""
    fn, args = packed_infer_program(det, vol, molded)
    return time_amortized(fn, args, device=det.device, reps=reps,
                          chain=chain)
