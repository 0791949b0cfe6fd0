"""The detector: host mold -> device graph -> host unmold (port of
``cfun_tpu/inference/pipeline.py::Detector``, heart and LiTS).

Output dict, as in the JAX package (reference model.py:1341-1389):
  rois      [N, (y1, x1, z1, y2, x2, z2)] in original voxel coords
  class_ids [num_classes - 1]
  scores    [N]
  mask      [H, W, D] int16 label volume at the original resolution

Each request is timed in spans (``utils/profiling.py``) under an id the
detector issues: ``mold`` (counting the wire's bytes up), ``dispatch``
(the enqueue of the graph and of its outputs' copy; bytes down), ``wait``
(the host blocked on the outputs' event) and ``finish``, inside it
``unpack`` and ``paste``.  Only ``mold``, ``dispatch`` and ``finish``
enclose kernel launches or copies; a profiler's device time leaves out
their marks by those names.  ``last_timings``, ``last_sub_timings`` and
``last_wire_bytes`` are views of the last finished request's spans.

The host work is the port's native ops (``native.py``, C++ with OpenMP),
as the JAX detector serves: on the packed int8 path the mold resizes and
quantizes z-slabs into page-locked buffers and uploads each one
asynchronously while the next one resizes.  Heart quantizes against the
raw volume's statistics from a strided sample (the device re-z-scores);
LiTS (HU window, virtual centre-pad, nearest resize) with the fixed
affine x127 of its [0, 1] values, no stats pass.  The unmold pastes the
label crop natively (one detection), or maps the device's overlap-paste
label volume back to the raw geometry (LiTS, or more than one instance).
``native=False`` takes the NumPy mold and unmold instead (``data/mold.py``,
``data/resample.py``), what the JAX detector does without its library.
"""

from __future__ import annotations

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from cfun_tpu_torch import native as native_ops
from cfun_tpu_torch.config import Config
from cfun_tpu_torch.data.mold import (lits_window, mold_volume,
                                      normalize_intensity, pad_offsets,
                                      quantize_int8)
from cfun_tpu_torch.data.resample import (resize, unmold_mask_labels,
                                          unmold_overlap_labels)
from cfun_tpu_torch.models import cfun
from cfun_tpu_torch.ops.anchors import config_anchors
from cfun_tpu_torch.utils.profiling import Span, SpanRecorder
from cfun_tpu_torch.weights import to_device

CLIP_SIGMA = 5.0  # the int8 wire clips the z-scored volume at +-5 sigma
STATS_STRIDE = 523  # the pipelined mold's sample of the raw volume


class _Pending(NamedTuple):
    """A dispatched request: its outputs on the host (page-locked on CUDA,
    complete once ``event`` has), and the bytes they took."""
    host: List[torch.Tensor]
    event: Optional[torch.cuda.Event]
    down_bytes: int


class _Request:
    """One request's id and its closed spans, by name."""

    __slots__ = ("id", "spans")

    def __init__(self, request_id: int):
        self.id = request_id
        self.spans: Dict[str, Span] = {}


class Detector:
    """Single-volume detector (heart or LiTS) over a port parameter tree
    (``weights.load_npz`` / ``weights.params_from_numpy``).

    ``device`` defaults to CUDA; pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the CPU.  There is no fallback: a
    CUDA device that is not there raises, and so does a host library that
    cannot be built while ``native`` is on.

    All device work of a request is enqueued on the calling thread's
    current stream.  Page-locked slab buffers are reused from one request
    to the next: before a slab is molded into its buffer, the event
    recorded after that buffer's last upload is waited on.  A window other
    than the full one (LiTS: the raw volume's place in the pad) goes up
    the same way, from a page-locked buffer of its own.  Each request's
    output is copied into a page-locked buffer of its own (PyTorch's
    caching host allocator hands it out again only after that copy has
    run), followed by an event that the ``wait`` stage waits on.

    ``spans.log = SpanLog()`` turns the span log on: every stage's span
    is kept there, with its thread and enclosing span, and opens a
    ``record_function`` range of its name for a profiler.
    """

    def __init__(self, cfg: Config, params, device="cuda",
                 native: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Detector: no CUDA device (pass device='cpu' "
                               "to run on the CPU)")
        self.cfg = cfg
        self.native = native
        self.params = to_device(params, self.device)
        self.anchors = torch.from_numpy(config_anchors(cfg)).to(self.device)
        # every heart request's window, on the device once
        self._window = torch.from_numpy(self._full_window()).to(self.device)
        # another window's page-locked buffer and the event after its
        # last upload
        self._win_buf: Optional[torch.Tensor] = None
        self._win_event: Optional[torch.cuda.Event] = None
        # fast path: one packed int8 buffer (4- or 2-bit labels) crosses
        # to the host instead of three arrays
        self._packed = cfg.fast_unmold and cfg.num_classes <= 16
        if cfun.uses_overlap_paste(cfg):
            # the device's overlap paste ships one molded label volume
            self.labels_shape = tuple(cfg.image_shape)
        else:
            self.labels_shape = (cfg.detection_max_instances,
                                 *(2 * p for p in cfg.mask_pool_size))
        # 2-bit labels where every label fits (LiTS' 3 classes)
        self.pack_bits = 2 if cfg.num_classes <= 4 else 4
        # slab-pipelined native mold: int8 z-slabs, each uploaded while
        # the next one resizes.  Heart: quantized against sampled raw
        # stats (the device re-z-scores).  LiTS: the [0, 1] HU-windowed
        # values with a fixed affine, no stats pass.
        self._pipelined = (native and self._packed and cfg.device_normalize
                           and cfg.wire_image_dtype == "int8"
                           and cfg.pad_shape is None)
        self._pipelined_lits = (native and self._packed
                                and cfg.wire_image_dtype == "int8"
                                and cfg.pad_shape is not None
                                and cfg.intensity_norm == "hu_window")
        self._slab_bufs: List[torch.Tensor] = []
        self._slab_events: List[torch.cuda.Event] = []
        self._dispatch_thread: Optional[ThreadPoolExecutor] = None
        self.spans = SpanRecorder()
        self._request_ids = itertools.count(1)
        # views of the last finished request's spans (``_publish``): its
        # id; "mold", "device" (dispatch + wait), "unmold" (finish) and
        # "total" seconds; the 'unmold' bucket's parts, "fetch" (finish
        # until the unpack: a wait for the output not yet waited on),
        # "unpack", "paste"; the bytes that crossed to the device ("up")
        # and back ("down")
        self.last_request: Optional[int] = None
        self.last_timings: Dict[str, float] = {}
        self.last_sub_timings: Dict[str, float] = {}
        self.last_wire_bytes: Dict[str, int] = {}
        self._filled = 0  # bytes of the last native box paste (_finish)

    def _wire_dtype(self) -> torch.dtype:
        return torch.int8 if self.cfg.wire_image_dtype == "int8" \
            else torch.bfloat16

    def _num_slabs(self) -> int:
        return max(1, min(self.cfg.wire_slabs, self.cfg.image_shape[0])) \
            if (self._pipelined or self._pipelined_lits) else 1

    def _slab_ranges(self):
        """[(z_start, z_count)] partition of the molded depth: the one
        definition of the slabs that ``warmup`` and ``mold`` share."""
        d = self.cfg.image_shape[0]
        zs = -(-d // self._num_slabs())
        return [(z, min(zs, d - z)) for z in range(0, d, zs)]

    def _full_window(self) -> np.ndarray:
        d, h, w = self.cfg.image_shape
        return np.array([0, 0, 0, d, h, w], np.float32)

    def _slab_buffer(self, i: int) -> torch.Tensor:
        """Page-locked host buffer of slab ``i``, free to overwrite: the
        upload that last read it has run."""
        if not self._slab_bufs:
            _, h, w = self.cfg.image_shape
            self._slab_bufs = [
                torch.empty((zc, h, w), dtype=torch.int8, pin_memory=True)
                for _, zc in self._slab_ranges()]
            self._slab_events = [torch.cuda.Event(blocking=True)
                                 for _ in self._slab_bufs]
        self._slab_events[i].synchronize()  # returns at once if unrecorded
        return self._slab_bufs[i]

    def _window_buffer(self) -> torch.Tensor:
        """Page-locked host buffer of a request's window, free to
        overwrite: the upload that last read it has run."""
        if self._win_buf is None:
            self._win_buf = torch.empty(6, dtype=torch.float32,
                                        pin_memory=True)
            self._win_event = torch.cuda.Event(blocking=True)
        self._win_event.synchronize()  # returns at once if unrecorded
        return self._win_buf

    def _device_window(self, window: np.ndarray) -> torch.Tensor:
        """The window on the device: the full one uploaded once, another
        one copied from its page-locked buffer without waiting for the
        device (the copy is enqueued on the current stream)."""
        if np.array_equal(window, self._full_window()):
            return self._window
        if self.device.type == "cpu":
            return torch.tensor(np.asarray(window, np.float32))
        buf = self._window_buffer()
        buf.numpy()[:] = window
        win = torch.empty(6, dtype=torch.float32, device=self.device)
        win.copy_(buf, non_blocking=True)
        self._win_event.record(torch.cuda.current_stream(self.device))
        return win

    def warmup(self):
        """Build and set up what the first request would: the host
        library, the page-locked slab buffers, the CUDA kernels and cuDNN's
        plans (one device pass on a zero wire, on this thread and on the
        thread that ``detect_stream`` enqueues from)."""
        if self.native:
            native_ops.num_threads()
        if self.device.type == "cuda":
            if self._pipelined or self._pipelined_lits:
                for i in range(len(self._slab_ranges())):
                    self._slab_buffer(i)
            if self.cfg.pad_shape is not None:
                self._window_buffer()
        wire = torch.zeros((1, 1, *self.cfg.image_shape),
                           dtype=self._wire_dtype(), device=self.device)
        window = self._full_window()
        stream = self._current_stream()
        for pending in (self._dispatch(wire, window),
                        self._dispatcher().submit(
                            self._dispatch_on, stream, wire, window
                        ).result()):
            if pending.event is not None:
                pending.event.synchronize()

    def _current_stream(self) -> Optional[torch.cuda.Stream]:
        return (torch.cuda.current_stream(self.device)
                if self.device.type == "cuda" else None)

    def _dispatcher(self) -> ThreadPoolExecutor:
        """The thread that enqueues ``detect_stream``'s device work, kept
        for the detector's life (``close`` ends it): cuDNN's execution
        plans and the library handles are kept per thread, so a new thread
        would set them up again on its first request."""
        if self._dispatch_thread is None:
            self._dispatch_thread = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="detector-dispatch")
        return self._dispatch_thread

    def _dispatch_on(self, stream: Optional[torch.cuda.Stream], wire,
                     window) -> "_Pending":
        """``_dispatch`` on ``stream`` (for another thread than the one
        that molded ``wire``)."""
        if stream is None:
            return self._dispatch(wire, window)
        with torch.cuda.stream(stream):
            return self._dispatch(wire, window)

    def close(self):
        """End the dispatch thread (a later ``detect_stream`` starts a new
        one, which sets its plans up again)."""
        if self._dispatch_thread is not None:
            self._dispatch_thread.shutdown(wait=True)
            self._dispatch_thread = None

    def mold(self, image_hwd: np.ndarray):
        """Raw [H, W, D] volume -> (wire tensor [1, 1, D, H, W] on the
        device, window, original shape).  On CUDA the upload may still be
        in flight on the current stream when this returns."""
        cfg = self.cfg
        if image_hwd.ndim == 4:
            image_hwd = image_hwd[..., 0]
        window = (self._full_window() if cfg.pad_shape is None
                  else lits_window(image_hwd.shape, cfg))
        if self._pipelined or self._pipelined_lits:
            wire = self._mold_slabs(image_hwd)
        else:
            if (self.native and cfg.pad_shape is None
                    and cfg.wire_image_dtype == "int8"):
                # one native pass: resize, z-score, int8
                host = native_ops.mold_resize_q8(
                    image_hwd, cfg.image_shape, CLIP_SIGMA,
                    cfg.wire_int8_scale)
            else:
                if cfg.pad_shape is None:
                    molded = (native_ops.mold_resize(
                        image_hwd, cfg.image_shape, normalize=True)
                        if self.native else normalize_intensity(
                            mold_volume(image_hwd, cfg)[0], cfg))
                elif self.native and cfg.intensity_norm == "hu_window":
                    # LiTS: HU window + virtual pad + nearest, in [0, 1]
                    pd, ph, pw = cfg.pad_shape
                    molded = native_ops.lits_mold(
                        image_hwd, (ph, pw, pd), cfg.image_shape,
                        pad_offsets(image_hwd.shape, cfg.pad_shape),
                        cfg.hu_window)
                else:
                    molded = mold_volume(image_hwd, cfg)[0]
                host = (quantize_int8(molded, cfg.wire_int8_scale)
                        if cfg.wire_image_dtype == "int8"
                        else np.ascontiguousarray(molded))
            wire = torch.from_numpy(host).to(self._wire_dtype()).to(
                self.device)[None, None]
        return wire, window, image_hwd.shape[:3]

    def _mold_slabs(self, image_hwd: np.ndarray) -> torch.Tensor:
        """The pipelined mold: each z-slab molded and quantized natively
        and, on CUDA, uploaded from its page-locked buffer into its
        z-range of one device tensor.  Heart slabs are quantized against
        stats from a strided sample of the raw volume, LiTS slabs with the
        fixed affine."""
        cfg = self.cfg
        src = np.ascontiguousarray(image_hwd, np.float32)
        if self._pipelined_lits:
            pd, ph, pw = cfg.pad_shape
            offsets = pad_offsets(src.shape, cfg.pad_shape)

            def mold_slab(z, zc, out):
                native_ops.lits_mold_slab_q8(
                    src, (ph, pw, pd), cfg.image_shape, offsets, z, zc,
                    cfg.hu_window, cfg.wire_int8_scale, out=out)
        else:
            mean, std = native_ops.volume_stats(src, STATS_STRIDE)

            def mold_slab(z, zc, out):
                native_ops.mold_slab_q8(src, cfg.image_shape, z, zc, mean,
                                        std, CLIP_SIGMA, cfg.wire_int8_scale,
                                        out=out)
        wire = torch.empty((1, 1, *cfg.image_shape), dtype=torch.int8,
                           device=self.device)
        on_cpu = self.device.type == "cpu"
        stream = None if on_cpu else torch.cuda.current_stream(self.device)
        for i, (z, zc) in enumerate(self._slab_ranges()):
            buf = wire[0, 0, z:z + zc] if on_cpu else self._slab_buffer(i)
            mold_slab(z, zc, buf.numpy())
            if not on_cpu:
                wire[0, 0, z:z + zc].copy_(buf, non_blocking=True)
                self._slab_events[i].record(stream)
        return wire

    @torch.inference_mode()
    def infer(self, wire: torch.Tensor, window: np.ndarray,
              nms: cfun.NmsFn = cfun.sorted_nms):
        """The device graph on a molded wire tensor: the packed int8 buffer
        on the fast path, else the :class:`cfun.InferOut`."""
        win = self._device_window(window)
        out = cfun.infer_forward(self.params, wire, self.anchors, win,
                                 self.cfg, nms=nms)
        if self._packed:
            return cfun.pack_fast_output(out, bits=self.pack_bits)
        return out

    def _dispatch(self, wire: torch.Tensor, window) -> _Pending:
        """Enqueue the device graph and the copy of its outputs to the
        host; waits for neither."""
        out = self.infer(wire, window)
        if self._packed:
            outs = [out]
        else:
            outs = [out.detections, out.det_valid,
                    out.mask_labels if out.mask_labels is not None
                    else out.mask_probs]
        down = sum(t.numel() * t.element_size() for t in outs)
        if self.device.type == "cpu":
            return _Pending(outs, None, down)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in outs]
        for h, t in zip(host, outs):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event(blocking=True)
        event.record(torch.cuda.current_stream(self.device))
        return _Pending(host, event, down)

    def _mold(self, req: _Request, image_hwd: np.ndarray):
        """``mold`` as the request's ``mold`` span, which counts the
        wire's bytes ("up")."""
        with self.spans.span("mold", req.id) as span:
            wire, window, orig_shape = self.mold(image_hwd)
            span.counts["up"] = wire.numel() * wire.element_size()
        req.spans["mold"] = span
        return wire, window, orig_shape

    def _enqueue(self, req: _Request, stream: Optional[torch.cuda.Stream],
                 wire, window) -> _Pending:
        """``_dispatch_on`` as the request's ``dispatch`` span, which
        counts the outputs' bytes ("down")."""
        with self.spans.span("dispatch", req.id) as span:
            pending = self._dispatch_on(stream, wire, window)
            span.counts["down"] = pending.down_bytes
        req.spans["dispatch"] = span
        return pending

    def _wait(self, req: _Request, pending: _Pending) -> None:
        """Block until the outputs are on the host: the request's ``wait``
        span."""
        with self.spans.span("wait", req.id) as span:
            if pending.event is not None:
                pending.event.synchronize()
        req.spans["wait"] = span

    def _finish(self, pending: _Pending, orig_shape_hwd, window: np.ndarray,
                req: _Request) -> Dict[str, np.ndarray]:
        """Unpack and unmold the outputs on the host: the request's
        ``finish`` span, ``unpack`` and ``paste`` in it.  Its own wait for
        the outputs returns at once after ``_wait``."""
        span = self.spans.span
        with span("finish", req.id) as finish:
            if pending.event is not None:
                pending.event.synchronize()
            # .numpy() runs torch ops: outside the leaves, which run none
            host = [t.numpy() for t in pending.host]
            with span("unpack", req.id) as unpack:
                if self._packed:
                    detections, kept, masks = cfun.unpack_fast_output(
                        host[0], self.cfg.detection_max_instances,
                        self.labels_shape, bits=self.pack_bits)
                else:
                    detections, kept, masks = host
                    if masks.dtype != np.int8:  # the probability stack
                        masks = masks.astype(np.float32)
            # "filled": the bytes the native box paste wrote (0 if none)
            with span("paste", req.id) as paste:
                self._filled = 0
                result = self.unmold(detections, kept, masks,
                                     orig_shape_hwd, window)
                paste.counts["filled"] = self._filled
        req.spans.update(finish=finish, unpack=unpack, paste=paste)
        return result

    def _publish(self, req: _Request) -> None:
        """Point the ``last_*`` views at a finished request's spans."""
        s = req.spans
        self.last_request = req.id
        self.last_timings = {
            "mold": s["mold"].seconds,
            "device": s["dispatch"].seconds + s["wait"].seconds,
            "unmold": s["finish"].seconds,
            "total": (s["finish"].end_ns - s["mold"].start_ns) * 1e-9}
        self.last_sub_timings = {
            "fetch": (s["unpack"].start_ns - s["finish"].start_ns) * 1e-9,
            "unpack": s["unpack"].seconds, "paste": s["paste"].seconds}
        self.last_wire_bytes = {"up": s["mold"].counts["up"],
                                "down": s["dispatch"].counts["down"]}

    def detect(self, image_hwd: np.ndarray,
               timings: Optional[dict] = None) -> Dict[str, np.ndarray]:
        """image_hwd: [H, W, D] or [H, W, D, 1] raw volume."""
        req = _Request(next(self._request_ids))
        wire, window, orig_shape = self._mold(req, image_hwd)
        pending = self._enqueue(req, None, wire, window)
        self._wait(req, pending)
        result = self._finish(pending, orig_shape, window, req)
        self._publish(req)
        if timings is not None:
            timings.update(self.last_timings)
        return result

    def detect_stream(self, volumes):
        """Pipelined inference over an iterable of [H, W, D] volumes:
        yields one result dict a volume, in order.  Three stages overlap:
        the host mold of volume N+1 (this thread), the device work of
        volume N and the fetch + unmold of volume N (a worker thread,
        which waits on the output's event).  At most two volumes are in
        flight.  When a result is yielded, the ``last_*`` views describe
        its request.

        The device work is enqueued by the detector's dispatch thread, on
        this thread's current stream: PyTorch launches each kernel from
        Python, so the enqueue of a request takes host time of the order
        of its device time, and on this thread it would hold the next mold
        back.  Native mold and unmold calls and event waits release the
        GIL, so the stages run at once."""
        stream = self._current_stream()
        dispatcher = self._dispatcher()

        def finish(req, dispatched, orig_shape, window):
            pending = dispatched.result()
            self._wait(req, pending)
            return self._finish(pending, orig_shape, window, req), req

        pending = collections.deque()  # FIFO of finish futures

        def done():
            result, req = pending.popleft().result()
            self._publish(req)
            return result

        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="detector-finish"
                                ) as finisher:
            for vol in volumes:
                req = _Request(next(self._request_ids))
                wire, window, orig_shape = self._mold(req, vol)
                dispatched = dispatcher.submit(self._enqueue, req, stream,
                                               wire, window)
                pending.append(finisher.submit(finish, req, dispatched,
                                               orig_shape, window))
                if len(pending) > 1:
                    yield done()
            while pending:
                yield done()

    def _molded_labels_to_original(self, labels_molded: np.ndarray,
                                   orig_shape_hwd) -> np.ndarray:
        """Invert the (virtual-pad) nearest mold of a [D, H, W] int8
        molded label volume: each raw voxel -> its pad coordinate -> the
        nearest molded index (float64 maps, as the JAX detector computes
        them).  Returns int16 [H0, W0, D0], the host layout."""
        cfg = self.cfg
        h0, w0, d0 = orig_shape_hwd[0], orig_shape_hwd[1], orig_shape_hwd[2]
        dt, ht, wt = cfg.image_shape
        if cfg.pad_shape is not None:
            pd, ph, pw = cfg.pad_shape
            oh, ow, od = pad_offsets(orig_shape_hwd, cfg.pad_shape)
        else:
            pd, ph, pw = d0, h0, w0
            oh = ow = od = 0

        def inv(n_src, n_pad, n_out, off):
            s = np.clip((np.arange(n_src) + off + 0.5) * n_out / n_pad - 0.5,
                        0, n_out - 1)
            return np.floor(s + 0.5).astype(np.int64)

        mz = inv(d0, pd, dt, od)
        my = inv(h0, ph, ht, oh)
        mx = inv(w0, pw, wt, ow)
        if self.native:
            return native_ops.unmold_nearest_labels(labels_molded, mz, my,
                                                    mx)
        out = np.take(labels_molded, mz, axis=0)
        out = np.take(out, my, axis=1)
        out = np.take(out, mx, axis=2)
        return np.ascontiguousarray(out.transpose(1, 2, 0)).astype(np.int16)

    def unmold(self, detections: np.ndarray, kept: np.ndarray,
               mask_data: np.ndarray, orig_shape_hwd,
               window: np.ndarray) -> Dict[str, np.ndarray]:
        """Reference unmold (model.py:1812-1864): scale boxes from the
        molded window back to original voxels, drop zero-volume boxes,
        then the labels.  ``mask_data`` is told apart by rank: the [D, H,
        W] int8 molded label volume of the overlap paste (mapped back to
        the raw geometry), [N, 2m...] int8 labels (fast path: the first
        detection's crop pasted into its box) or the [N, m..., C]
        probability stack (exact path: LiTS averages every detection's
        stack over their overlaps, LiTS_2017/utils.py:383-408; heart
        pastes the first)."""
        cfg = self.cfg
        h0, w0, d0 = orig_shape_hwd[0], orig_shape_hwd[1], orig_shape_hwd[2]
        n = int(kept.sum())
        boxes = detections[:n, :6].astype(np.int64)
        scores = detections[:n, 7]

        win = np.asarray(window, np.float64)
        scales = np.array([d0 / (win[3] - win[0]),
                           h0 / (win[4] - win[1]),
                           w0 / (win[5] - win[2])])
        shifts = win[:3]
        boxes = ((boxes - np.concatenate([shifts, shifts]))
                 * np.concatenate([scales, scales])).astype(np.int64)

        volume = ((boxes[:, 3] - boxes[:, 0]) * (boxes[:, 4] - boxes[:, 1])
                  * (boxes[:, 5] - boxes[:, 2]))
        good = volume > 0
        boxes, scores = boxes[good], scores[good]

        if mask_data.ndim == 3:  # the overlap paste's molded labels
            full_hwd = self._molded_labels_to_original(mask_data,
                                                       orig_shape_hwd)
            boxes = np.clip(boxes, 0, np.array([d0, h0, w0, d0, h0, w0]))
            return {
                "rois": boxes[:, [1, 2, 0, 4, 5, 3]],
                "class_ids": np.arange(1, cfg.num_classes),
                "scores": scores,
                "mask": full_hwd,
            }

        masks = mask_data[:n][good]
        if boxes.shape[0] > 0:
            boxes = np.clip(boxes, 0, np.array([d0, h0, w0, d0, h0, w0]))
            if masks.ndim == 4:  # [N, d, h, w] int8 labels
                full = self._paste_labels(masks[0], boxes[0], (d0, h0, w0))
            elif cfg.name == "lits":
                full = unmold_overlap_labels(masks, boxes, (d0, h0, w0))
            elif self.native:
                full = native_ops.unmold_argmax(masks[0], boxes[0],
                                                (d0, h0, w0))
            else:
                full = unmold_mask_labels(masks[0], boxes[0], (d0, h0, w0))
        else:
            full = np.zeros((d0, h0, w0), np.int16)

        # (z, y, x) -> (y, x, z) box order; [D, H, W] -> [H, W, D] volume
        return {
            "rois": boxes[:, [1, 2, 0, 4, 5, 3]],
            "class_ids": np.arange(1, cfg.num_classes),
            "scores": scores,
            "mask": full.transpose(1, 2, 0),
        }

    def _paste_labels(self, labels: np.ndarray, box,
                      shape_dhw) -> np.ndarray:
        """Nearest paste of an int8 label crop into its clipped box of an
        int16 volume, zero elsewhere.  The native pass writes the whole
        volume, and ``_filled`` records its bytes (a box past the edge
        pastes nothing)."""
        if self.native:
            full = native_ops.unmold_labels_box(labels, box, shape_dhw)
            if all(b < n for b, n in zip(box[:3], shape_dhw)):
                self._filled = full.nbytes
            return full
        full = np.zeros(shape_dhw, np.int16)
        z1, y1, x1, z2, y2, x2 = box
        target = (max(z2 - z1, 1), max(y2 - y1, 1), max(x2 - x1, 1))
        full[z1:z1 + target[0], y1:y1 + target[1],
             x1:x1 + target[2]] = resize(labels, target, order=0)
        return full
