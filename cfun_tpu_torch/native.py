"""ctypes bindings of the port's host ops (``csrc/host_ops.cc``): the
native mold and unmold of heart and LiTS serving, and the train molds
(the epoch's rotation composed into the mold, straight to the train
wire, with their label companions).

The library is built with ``g++`` at first use (``_build.build_host``)
and loaded with ctypes' default ``RTLD_LOCAL``, so its symbols stay its
own in a process that loads another library of the same names.  ctypes
releases the GIL during each call, so a mold on one thread and an unmold
on another run at once.  There is no NumPy fallback here: a missing
compiler or a failed build raises.  ``Detector(..., native=False)`` is the
caller's explicit choice of the NumPy mold (``data/mold.py``).

Every wrapper checks the shapes, dtypes and contiguity of what it passes
by pointer; the arithmetic is the C++ code's (see its header).

The training feeder's calls run on a :class:`Team`: ``mold_resize``,
``lits_mold``, ``pad_nearest_labels``, the train molds
(``heart_train_mold(_q8)``, ``lits_train_mold(_q8)``) and their label
companions take ``team=``.  A team is one thread that makes those calls
one at a time, each C region on an OpenMP team of ``Team.threads``
threads, passed to the C function as its thread count (a ``num_threads``
clause); the wrapper's own NumPy work (the source's copy to float32 or
int32, the output's allocation) stays on the caller's thread.  The
feeder's team is one a process, sized by ``data/feeder.py::team_size``.
Calls without a team (serving's) run on the caller's thread on the
library's default team, ``omp_get_max_threads()``; nothing here sets the
process's OpenMP thread count.  Every output the feeder asks for is the
same at any team size: the one reduction on its path, the heart train
mold's z-score sums, adds per-row partials in row order
(``mold_resize``'s z-score, which the feeder leaves off, does not).
"""

from __future__ import annotations

import ctypes
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from cfun_tpu_torch import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _declare(lib: ctypes.CDLL) -> None:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i, f = ctypes.c_int, ctypes.c_float
    # the functions the feeder calls end in the team's thread count
    lib.mold_resize_f32.argtypes = [f32p, i, i, i, f32p, i, i, i, i, i]
    lib.mold_resize_f32.restype = None
    lib.mold_resize_q8.argtypes = [f32p, i, i, i, f32p, i8p, i, i, i, f, f]
    lib.mold_resize_q8.restype = None
    lib.unmold_argmax_f32.argtypes = [f32p] + [i] * 4 + [i16p] + [i] * 9
    lib.unmold_argmax_f32.restype = None
    lib.volume_stats_f32.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.volume_stats_f32.restype = None
    lib.mold_resize_slab_q8.argtypes = [f32p, i, i, i, i8p] + [i] * 5 + \
        [f] * 4
    lib.mold_resize_slab_q8.restype = None
    lib.unmold_labels_box_i16.argtypes = [i8p, i, i, i, i32p, i32p, i32p,
                                          i16p] + [i] * 9
    lib.unmold_labels_box_i16.restype = None
    lib.lits_mold_f32.argtypes = [f32p] + [i] * 9 + [f32p, i, i, i, f, f, i]
    lib.lits_mold_f32.restype = None
    lib.lits_mold_slab_q8.argtypes = [f32p] + [i] * 9 + [i8p] + [i] * 5 + \
        [f] * 3
    lib.lits_mold_slab_q8.restype = None
    lib.unmold_nearest_i16.argtypes = [i8p, i, i, i, i32p, i32p, i32p,
                                       i16p, i, i, i]
    lib.unmold_nearest_i16.restype = None
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.heart_train_mold_bf16.argtypes = [f32p, i, i, i, u16p, f32p, i, i,
                                          i, f, i]
    lib.heart_train_mold_bf16.restype = None
    lib.heart_train_mold_q8.argtypes = [f32p, i, i, i, i8p, f32p, i, i, i,
                                        f, f, f, i]
    lib.heart_train_mold_q8.restype = None
    lib.heart_train_labels_i32.argtypes = [i32p, i, i, i, i32p, i, i, i, f,
                                           i]
    lib.heart_train_labels_i32.restype = None
    lib.lits_train_mold_q8.argtypes = [f32p] + [i] * 9 + [i8p, i, i, i] + \
        [f] * 5 + [i]
    lib.lits_train_mold_q8.restype = None
    lib.lits_train_mold_bf16.argtypes = [f32p] + [i] * 9 + [u16p, i, i, i] \
        + [f] * 3 + [i]
    lib.lits_train_mold_bf16.restype = None
    lib.lits_train_labels_i32.argtypes = [i32p] + [i] * 9 + [i32p, i, i, i,
                                                             f, i]
    lib.lits_train_labels_i32.restype = None
    lib.pad_nearest_i32.argtypes = [i32p] + [i] * 9 + [i32p, i, i, i, i]
    lib.pad_nearest_i32.restype = None
    lib.cfun_native_num_threads.argtypes = []
    lib.cfun_native_num_threads.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build.build_host())
            _declare(lib)
            _lib = lib
        return _lib


def num_threads() -> int:
    """OpenMP thread count the native ops run with."""
    return int(library().cfun_native_num_threads())


class Team:
    """One thread that makes native calls one at a time, each of its C
    regions on an OpenMP team of ``threads`` threads.  The calls come from
    any thread and wait for their turn in the order they came; a single
    calling thread keeps one OpenMP thread pool alive, not one a caller."""

    def __init__(self, threads: int):
        if threads < 1:
            raise ValueError(f"a team needs a thread, got {threads}")
        self.threads = int(threads)
        self._thread = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="native-team")

    def run(self, fn, *args):
        """``fn(*args, threads)`` on the team's thread; its result."""
        return self._thread.submit(fn, *args, self.threads).result()


def _call(team: Optional[Team], fn, *args) -> None:
    """A C function that ends in a thread count: on ``team``, or here on
    the default team (0)."""
    if team is None:
        fn(*args, 0)
    else:
        team.run(fn, *args)


def _source(src_hwd: np.ndarray) -> Tuple[np.ndarray, int, int, int]:
    src = np.ascontiguousarray(src_hwd, np.float32)
    if src.ndim != 3 or min(src.shape) < 1:
        raise ValueError(f"source must be a non-empty [H, W, D] volume, "
                         f"got shape {src.shape}")
    return (src, *src.shape)


def _out_shape(out_shape_dhw) -> Tuple[int, int, int]:
    dt, ht, wt = (int(v) for v in out_shape_dhw)
    if min(dt, ht, wt) < 1:
        raise ValueError(f"output shape must be positive, got "
                         f"{out_shape_dhw}")
    return dt, ht, wt


def mold_resize(src_hwd: np.ndarray, out_shape_dhw,
                normalize: bool, team: Optional[Team] = None) -> np.ndarray:
    """[H, W, D] raw volume -> [Dt, Ht, Wt] float32 trilinear resize
    (half-pixel, no antialiasing), z-scored over the molded volume when
    ``normalize`` (whose sums do depend on the team's size)."""
    src, h0, w0, d0 = _source(src_hwd)
    dt, ht, wt = _out_shape(out_shape_dhw)
    dst = np.empty((dt, ht, wt), np.float32)
    _call(team, library().mold_resize_f32, src, h0, w0, d0, dst, dt, ht, wt,
          int(normalize))
    return dst


def mold_resize_q8(src_hwd: np.ndarray, out_shape_dhw, clip_sigma: float,
                   scale: float) -> np.ndarray:
    """[H, W, D] raw volume -> the int8 wire [Dt, Ht, Wt] in one pass:
    resize, z-score over the molded volume, clip to +-``clip_sigma``,
    times ``scale``, truncated to int8."""
    src, h0, w0, d0 = _source(src_hwd)
    dt, ht, wt = _out_shape(out_shape_dhw)
    tmp = np.empty((dt, ht, wt), np.float32)
    dst = np.empty((dt, ht, wt), np.int8)
    library().mold_resize_q8(src, h0, w0, d0, tmp, dst, dt, ht, wt,
                             float(clip_sigma), float(scale))
    return dst


def volume_stats(src: np.ndarray, stride: int = 523) -> Tuple[float, float]:
    """(mean, std) of a float32 volume from every ``stride``-th voxel
    (sums in double).  They set the int8 affine of the slab-pipelined mold;
    the device re-z-scores, so a sample's error is immaterial against the
    +-5 sigma clip.  ``stride=1`` reads every voxel."""
    src = np.ascontiguousarray(src, np.float32)
    if src.size == 0 or stride < 1:
        raise ValueError(f"volume_stats needs a non-empty volume and a "
                         f"stride >= 1, got size {src.size} stride {stride}")
    mean, std = ctypes.c_float(), ctypes.c_float()
    library().volume_stats_f32(src.reshape(-1), src.size, int(stride),
                               ctypes.byref(mean), ctypes.byref(std))
    return float(mean.value), float(std.value)


def mold_slab_q8(src_hwd: np.ndarray, out_shape_dhw, z_start: int,
                 z_count: int, mean: float, std: float, clip_sigma: float,
                 scale: float, out: Optional[np.ndarray] = None
                 ) -> np.ndarray:
    """Output z rows [z_start, z_start + z_count) of the int8 wire, with
    the given affine: resize, ``(v - mean) / std``, clip, scale, truncate.
    Written into ``out`` (int8 C-contiguous [z_count, Ht, Wt], e.g. a view
    of a page-locked buffer) when given; returns it.  ``src_hwd`` must be
    C-contiguous float32 already: callers mold several slabs from one
    source."""
    if src_hwd.dtype != np.float32 or not src_hwd.flags.c_contiguous:
        raise ValueError("mold_slab_q8 takes a C-contiguous float32 source")
    src, h0, w0, d0 = _source(src_hwd)
    dt, ht, wt = _out_shape(out_shape_dhw)
    z_start, z_count = int(z_start), int(z_count)
    if z_start < 0 or z_count < 1 or z_start + z_count > dt:
        raise ValueError(f"slab [{z_start}, {z_start + z_count}) is not "
                         f"inside depth {dt}")
    if out is None:
        out = np.empty((z_count, ht, wt), np.int8)
    elif (out.shape != (z_count, ht, wt) or out.dtype != np.int8
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be int8 C-contiguous "
                         f"{(z_count, ht, wt)}, got {out.dtype} {out.shape}")
    library().mold_resize_slab_q8(
        src, h0, w0, d0, out, dt, ht, wt, z_start, z_count, float(mean),
        float(1.0 / max(std, 1e-6)), float(clip_sigma), float(scale))
    return out


def _nearest(n_in: int, n_out: int) -> np.ndarray:
    """Nearest source index of each of ``n_out`` outputs (half-pixel,
    float64: ``data/resample.py::_axis_indices(order=0)``)."""
    if n_in == n_out:  # resize() short-circuits equal axes
        return np.arange(n_out, dtype=np.int32)
    s = np.clip((np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out
                - 0.5, 0, n_in - 1)
    return np.floor(s + 0.5).astype(np.int32)


def unmold_labels_box(lab_dhw: np.ndarray, box, out_shape_dhw,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
    """Nearest-resize an int8 [md, mh, mw] label crop into the integer
    ``box`` (z1, y1, x1, z2, y2, x2; clipped to the volume) of an int16
    [D0, H0, W0] volume that is zero elsewhere: ``resize(lab, target,
    order=0)`` pasted at the box, target ``max(z2 - z1, 1)`` a side.
    One parallel native pass writes every voxel, so the volume needs no
    zeroing first; written into ``out`` (int16 C-contiguous [D0, H0, W0],
    whatever it holds) when given; returns it.

    A box that starts at the volume's extent (``z1 >= D0``, ``y1 >= H0``
    or ``x1 >= W0``: a clipped box past the edge) pastes nothing, as the
    NumPy slice paste does: the zero volume comes back without a call,
    since the target of 1 would write past the end."""
    lab = np.ascontiguousarray(lab_dhw, np.int8)
    if lab.ndim != 3 or min(lab.shape) < 1:
        raise ValueError(f"labels must be a non-empty [d, h, w] crop, got "
                         f"{lab.shape}")
    md, mh, mw = lab.shape
    shape = tuple(int(v) for v in out_shape_dhw)
    d0, h0, w0 = shape
    z1, y1, x1, z2, y2, x2 = (int(v) for v in box)
    if min(z1, y1, x1) < 0 or z2 > d0 or y2 > h0 or x2 > w0:
        raise ValueError(f"box {list(box)} is not clipped to {shape}")
    if out is None:
        out = np.empty(shape, np.int16)
    elif (out.shape != shape or out.dtype != np.int16
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be int16 C-contiguous {shape}, got "
                         f"{out.dtype} {out.shape}")
    if z1 >= d0 or y1 >= h0 or x1 >= w0:
        out.fill(0)
        return out
    td, th, tw = max(z2 - z1, 1), max(y2 - y1, 1), max(x2 - x1, 1)
    library().unmold_labels_box_i16(
        lab, md, mh, mw, _nearest(md, td), _nearest(mh, th),
        _nearest(mw, tw), out, d0, h0, w0, z1, y1, x1, td, th, tw)
    return out


def unmold_argmax(crop_probs: np.ndarray, box, out_shape_dhw
                  ) -> np.ndarray:
    """[md, mh, mw, C] probabilities + integer box -> int16 [D0, H0, W0]
    labels: the probabilities resampled trilinearly at every voxel of the
    box (clipped to the volume), argmax over C; zero outside the box."""
    probs = np.ascontiguousarray(crop_probs, np.float32)
    if probs.ndim != 4 or min(probs.shape) < 1:
        raise ValueError(f"probabilities must be [d, h, w, C], got "
                         f"{probs.shape}")
    md, mh, mw, c = probs.shape
    od, oh, ow = (int(v) for v in out_shape_dhw)
    out = np.zeros((od, oh, ow), np.int16)
    z1, y1, x1, z2, y2, x2 = (int(v) for v in box)
    library().unmold_argmax_f32(probs, md, mh, mw, c, out, od, oh, ow,
                                z1, y1, x1, z2, y2, x2)
    return out


def _lits_geometry(pad_shape_hwd, out_shape_dhw, offsets_hwd):
    """Checked (pad (ph, pw, pd), output (dt, ht, wt), offsets (oh, ow,
    od)) of a LiTS mold: the pad must hold the offsets, which are
    ``max(0, (pad - src) // 2)`` for the centre-pad (a source larger than
    the pad is cropped by the nearest map, and its offset is 0)."""
    ph, pw, pd = (int(v) for v in pad_shape_hwd)
    oh, ow, od = (int(v) for v in offsets_hwd)
    dt, ht, wt = _out_shape(out_shape_dhw)
    if min(ph, pw, pd) < 1 or min(oh, ow, od) < 0 or \
            oh >= ph or ow >= pw or od >= pd:
        raise ValueError(f"pad {pad_shape_hwd} with offsets {offsets_hwd} "
                         f"is not a centre-pad target")
    return (ph, pw, pd), (dt, ht, wt), (oh, ow, od)


def lits_mold(src_hwd: np.ndarray, pad_shape_hwd, out_shape_dhw,
              offsets_hwd, hu_window, team: Optional[Team] = None
              ) -> np.ndarray:
    """The LiTS mold in one native pass: [H, W, D] raw volume ->
    [Dt, Ht, Wt] float32 in [0, 1]: the inverted HU window
    ``clip((x - mn) / (mx - mn), 0, 1)``, a virtual centre-pad to
    ``pad_shape_hwd`` at ``offsets_hwd`` (pad voxels 0) and a nearest
    resize.  No pad buffer is made."""
    src, h0, w0, d0 = _source(src_hwd)
    (ph, pw, pd), (dt, ht, wt), (oh, ow, od) = _lits_geometry(
        pad_shape_hwd, out_shape_dhw, offsets_hwd)
    mn, mx = (float(v) for v in hu_window)
    dst = np.empty((dt, ht, wt), np.float32)
    _call(team, library().lits_mold_f32, src, h0, w0, d0, ph, pw, pd, oh, ow,
          od, dst, dt, ht, wt, mn, mx)
    return dst


def lits_mold_slab_q8(src_hwd: np.ndarray, pad_shape_hwd, out_shape_dhw,
                      offsets_hwd, z_start: int, z_count: int, hu_window,
                      scale: float, out: Optional[np.ndarray] = None
                      ) -> np.ndarray:
    """Output z rows [z_start, z_start + z_count) of the LiTS int8 wire:
    the mold of :func:`lits_mold`, times ``scale``, truncated to int8 (a
    fixed affine: no stats pass).  Written into ``out`` (int8
    C-contiguous [z_count, Ht, Wt], e.g. a view of a page-locked buffer)
    when given; returns it.  ``src_hwd`` must be C-contiguous float32
    already: callers mold several slabs from one source."""
    if src_hwd.dtype != np.float32 or not src_hwd.flags.c_contiguous:
        raise ValueError("lits_mold_slab_q8 takes a C-contiguous float32 "
                         "source")
    src, h0, w0, d0 = _source(src_hwd)
    (ph, pw, pd), (dt, ht, wt), (oh, ow, od) = _lits_geometry(
        pad_shape_hwd, out_shape_dhw, offsets_hwd)
    z_start, z_count = int(z_start), int(z_count)
    if z_start < 0 or z_count < 1 or z_start + z_count > dt:
        raise ValueError(f"slab [{z_start}, {z_start + z_count}) is not "
                         f"inside depth {dt}")
    if out is None:
        out = np.empty((z_count, ht, wt), np.int8)
    elif (out.shape != (z_count, ht, wt) or out.dtype != np.int8
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be int8 C-contiguous "
                         f"{(z_count, ht, wt)}, got {out.dtype} {out.shape}")
    mn, mx = (float(v) for v in hu_window)
    library().lits_mold_slab_q8(src, h0, w0, d0, ph, pw, pd, oh, ow, od, out,
                                dt, ht, wt, z_start, z_count, mn, mx,
                                float(scale))
    return out


def unmold_nearest_labels(lab_dhw: np.ndarray, mz: np.ndarray,
                          my: np.ndarray, mx: np.ndarray) -> np.ndarray:
    """The molded int8 [Dm, Hm, Wm] label volume mapped back through
    per-axis nearest index maps: ``out[y, x, z] = lab[mz[z], my[y],
    mx[x]]`` as int16 [H0, W0, D0] (the host layout), in one pass.

    Every map entry must index the molded volume: a map that steps out of
    it would make the C code read past the buffer, so it is refused here
    with a ValueError before the call (and the C code refuses it too)."""
    lab = np.ascontiguousarray(lab_dhw, np.int8)
    if lab.ndim != 3 or min(lab.shape) < 1:
        raise ValueError(f"labels must be a non-empty [d, h, w] volume, got "
                         f"{lab.shape}")
    maps = [np.asarray(m) for m in (mz, my, mx)]
    for name, m, n in zip(("mz", "my", "mx"), maps, lab.shape):
        if m.ndim != 1 or m.size < 1:
            raise ValueError(f"{name} must be a non-empty 1-D index map")
        if int(m.min()) < 0 or int(m.max()) >= n:
            raise ValueError(f"{name} indexes [{int(m.min())}, "
                             f"{int(m.max())}], outside the molded axis of "
                             f"{n}")
    mz, my, mx = (np.ascontiguousarray(m, np.int32) for m in maps)
    dm, hm, wm = lab.shape
    out = np.empty((my.size, mx.size, mz.size), np.int16)
    library().unmold_nearest_i16(lab, dm, hm, wm, mz, my, mx, out,
                                 my.size, mx.size, mz.size)
    return out


# ---- training molds ----------------------------------------------------------
#
# The bf16 train wire comes out as the bfloat16 bits in uint16 (NumPy has
# no bfloat16): ``torch.from_numpy(u16).view(torch.bfloat16)`` is the
# image.


def _labels_source(mask_hwd: np.ndarray) -> Tuple[np.ndarray, int, int, int]:
    src = np.ascontiguousarray(mask_hwd, np.int32)
    if src.ndim != 3 or min(src.shape) < 1:
        raise ValueError(f"labels must be a non-empty [H, W, D] volume, got "
                         f"shape {src.shape}")
    return (src, *src.shape)


def pad_nearest_labels(mask_hwd: np.ndarray, pad_shape_hwd, out_shape_dhw,
                       offsets_hwd, team: Optional[Team] = None
                       ) -> np.ndarray:
    """[H, W, D] int labels -> int32 [Dt, Ht, Wt]: a virtual centre-pad to
    ``pad_shape_hwd`` at ``offsets_hwd`` (pad voxels 0) and a nearest
    resize.  With the pad equal to the source shape and zero offsets it is
    the plain nearest resize of the heart's label mold."""
    src, h0, w0, d0 = _labels_source(mask_hwd)
    (ph, pw, pd), (dt, ht, wt), (oh, ow, od) = _lits_geometry(
        pad_shape_hwd, out_shape_dhw, offsets_hwd)
    dst = np.empty((dt, ht, wt), np.int32)
    _call(team, library().pad_nearest_i32, src, h0, w0, d0, ph, pw, pd, oh,
          ow, od, dst, dt, ht, wt)
    return dst


def heart_train_mold(src_hwd: np.ndarray, out_shape_dhw,
                     angle_deg: float, team: Optional[Team] = None
                     ) -> np.ndarray:
    """The heart train mold in one native pass: trilinear resize, the
    nearest (H, W) rotation by ``angle_deg`` (zero fill before the
    z-score), z-score over the molded volume, bf16 -> uint16 bits
    [Dt, Ht, Wt].  The statistics sum in double (NumPy's z-score in
    float32), so ~1e-4 of the voxels can differ from the NumPy chain by
    one bf16 ulp; the index maps are exact.  The sums are per-row
    partials added in row order: the bits are the same at any team
    size."""
    src, h0, w0, d0 = _source(src_hwd)
    dt, ht, wt = _out_shape(out_shape_dhw)
    dst = np.empty((dt, ht, wt), np.uint16)
    tmp = np.empty((dt, ht, wt), np.float32)
    _call(team, library().heart_train_mold_bf16, src, h0, w0, d0, dst, tmp,
          dt, ht, wt, float(angle_deg))
    return dst


def heart_train_mold_q8(src_hwd: np.ndarray, out_shape_dhw,
                        angle_deg: float, clip_sigma: float,
                        scale: float, team: Optional[Team] = None
                        ) -> np.ndarray:
    """The int8 train wire of :func:`heart_train_mold`: ``astype(int8)``
    of ``clip(bf16(z), +-clip_sigma) * scale``, the bf16 image quantized.
    Returns int8 [Dt, Ht, Wt]."""
    src, h0, w0, d0 = _source(src_hwd)
    dt, ht, wt = _out_shape(out_shape_dhw)
    dst = np.empty((dt, ht, wt), np.int8)
    tmp = np.empty((dt, ht, wt), np.float32)
    _call(team, library().heart_train_mold_q8, src, h0, w0, d0, dst, tmp,
          dt, ht, wt, float(angle_deg), float(clip_sigma), float(scale))
    return dst


def heart_train_labels(mask_hwd: np.ndarray, out_shape_dhw,
                       angle_deg: float, team: Optional[Team] = None
                       ) -> np.ndarray:
    """Label companion of :func:`heart_train_mold`: the nearest resize and
    the same nearest rotation (zero fill) -> int32 [Dt, Ht, Wt]."""
    src, h0, w0, d0 = _labels_source(mask_hwd)
    dt, ht, wt = _out_shape(out_shape_dhw)
    dst = np.empty((dt, ht, wt), np.int32)
    _call(team, library().heart_train_labels_i32, src, h0, w0, d0, dst, dt,
          ht, wt, float(angle_deg))
    return dst


def lits_train_mold_q8(src_hwd: np.ndarray, pad_shape_hwd, out_shape_dhw,
                       offsets_hwd, angle_deg: float, hu_window,
                       clip_sigma: float, scale: float,
                       team: Optional[Team] = None) -> np.ndarray:
    """The LiTS train mold to the int8 wire in one gather: the nearest
    rotation of the raw slices composed into the virtual-pad nearest
    resize, then the HU window, bf16 rounding and the quantization, once
    a touched source voxel.  Equal to ``rotate_hw(raw)`` -> the LiTS mold
    -> bf16 -> clip -> ``* scale`` -> ``astype(int8)`` (reference
    LiTS_2017/model.py:1211-1233).  Returns int8 [Dt, Ht, Wt]."""
    src, h0, w0, d0 = _source(src_hwd)
    (ph, pw, pd), (dt, ht, wt), (oh, ow, od) = _lits_geometry(
        pad_shape_hwd, out_shape_dhw, offsets_hwd)
    mn, mx = (float(v) for v in hu_window)
    dst = np.empty((dt, ht, wt), np.int8)
    _call(team, library().lits_train_mold_q8, src, h0, w0, d0, ph, pw, pd,
          oh, ow, od, dst, dt, ht, wt, float(angle_deg), mn, mx,
          float(clip_sigma), float(scale))
    return dst


def lits_train_mold(src_hwd: np.ndarray, pad_shape_hwd, out_shape_dhw,
                    offsets_hwd, angle_deg: float, hu_window,
                    team: Optional[Team] = None) -> np.ndarray:
    """The bf16 form of :func:`lits_train_mold_q8` (``train_wire_int8``
    off): bfloat16 bits as uint16 [Dt, Ht, Wt]."""
    src, h0, w0, d0 = _source(src_hwd)
    (ph, pw, pd), (dt, ht, wt), (oh, ow, od) = _lits_geometry(
        pad_shape_hwd, out_shape_dhw, offsets_hwd)
    mn, mx = (float(v) for v in hu_window)
    dst = np.empty((dt, ht, wt), np.uint16)
    _call(team, library().lits_train_mold_bf16, src, h0, w0, d0, ph, pw, pd,
          oh, ow, od, dst, dt, ht, wt, float(angle_deg), mn, mx)
    return dst


def lits_train_labels(mask_hwd: np.ndarray, pad_shape_hwd, out_shape_dhw,
                      offsets_hwd, angle_deg: float,
                      team: Optional[Team] = None) -> np.ndarray:
    """Label companion of the LiTS train molds: the same composed
    rotation + pad + nearest plan over the labels -> int32 [Dt, Ht, Wt]."""
    src, h0, w0, d0 = _labels_source(mask_hwd)
    (ph, pw, pd), (dt, ht, wt), (oh, ow, od) = _lits_geometry(
        pad_shape_hwd, out_shape_dhw, offsets_hwd)
    dst = np.empty((dt, ht, wt), np.int32)
    _call(team, library().lits_train_labels_i32, src, h0, w0, d0, ph, pw, pd,
          oh, ow, od, dst, dt, ht, wt, float(angle_deg))
    return dst
