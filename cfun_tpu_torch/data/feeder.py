"""Host side of training (the port's copy of ``cfun_tpu/data/feeder.py``):
the whole-organ GT box of a molded label volume, and the threaded feeder
that molds, rotates and targets one training example at a time.

The feeder runs NumPy and the native host ops (``native.py``) on a pool of
worker threads with a bounded prefetch: the LiTS worker-side pattern
(LiTS_2017/model.py:1147-1248) in place of the heart variant's in-loop
``load_image_gt`` (model.py:1597-1599).  Workers never touch CUDA: an item
is CPU tensors, and the training loop uploads it.

Heart molding (utils.py:389-393 + model.py:1902-1904): trilinear resize
to (D, H, W) = (192, 320, 320), nearest for the mask, whole-volume
z-score.  LiTS molding (LiTS_2017/model.py:1154-1233): inverted HU window
to [0, 1], a virtual centre-pad to ``cfg.pad_shape``, nearest resize.

Augmentation: one rotation angle an epoch (a reference quirk kept for
parity, model.py:1555), slice-wise in the (H, W) plane, nearest
(imgaug Affine(order=0), model.py:1022).  The heart rotates the molded
volume; LiTS the raw one before its mold (the native train molds compose
the two gathers).

The native calls of every feeder in a process (the train molds, their
label companions, and ``mold_resize`` / ``lits_mold`` /
``pad_nearest_labels`` on the float32 and augment paths) run on one
``native.Team``: one thread that makes them one at a time, each on an
OpenMP team of :func:`team_size` threads (the cores this process may use,
over the ranks on its host, less one for the training loop's thread and
one for the workers' single-threaded NumPy work).
An epoch's items take the team in the order ``epoch`` yields them: the
first item is molded first and alone.  Their loads are not ordered: each
worker loads as soon as its item is submitted.  A worker loads its
volume, lays it out for the native ops (the labels' copy to int32),
waits for its turn, molds and labels on the team, and goes on with the
RPN targets and the label packing on its own thread.  Items are the same
bit for bit at any team size.

Items are bit-equal to the JAX package's at the same image id, angle and
seed, and the plan of an epoch (ids and target seeds) is the JAX
package's.  One deviation: a volume that fails to load is replaced by a
draw from ``default_rng((seed, epoch, 2, n))`` (n: the epoch's failures
so far) where the JAX package draws from the feeder's advancing stream, so
a resumed run substitutes as the uninterrupted one did.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Set

import numpy as np
import torch

from cfun_tpu_torch import native
from cfun_tpu_torch.config import Config
from cfun_tpu_torch.data.batch import AugTrainBatch, TrainBatch, pack_labels_w
from cfun_tpu_torch.data.mold import normalize_intensity, pad_offsets
from cfun_tpu_torch.data.resample import rotate_hw
from cfun_tpu_torch.parallel.mesh import ranks_on_host
from cfun_tpu_torch.train.targets import build_rpn_targets
from cfun_tpu_torch.utils.profiling import SpanRecorder


def team_size(cores: Optional[int] = None,
              ranks: Optional[int] = None) -> int:
    """Threads of the feeders' native team: the ``cores`` this process may
    run on (``os.sched_getaffinity``) over the ``ranks`` on its host
    (:func:`ranks_on_host`), less one for the training loop's thread and
    one for the workers' NumPy work (the label copy, the RPN targets, the
    packing), which runs beside the team; at least 1.  A team that leaves
    the workers no core has its threads preempted mid-region, and the
    loop's thread with them."""
    if cores is None:
        cores = len(os.sched_getaffinity(0))
    if ranks is None:
        ranks = ranks_on_host()
    return max(1, cores // max(1, ranks) - 2)


_team_lock = threading.Lock()
_team: Optional[native.Team] = None


def shared_team() -> native.Team:
    """The process's feeder team, sized by :func:`team_size` when the
    first feeder is made."""
    global _team
    with _team_lock:
        if _team is None:
            _team = native.Team(team_size())
        return _team


class _Turns:
    """The order in which an epoch's items take the team: the order they
    were submitted in.  Ticket ``k`` waits until every ticket before it is
    done (with the team, failed or dropped); ``open`` lets every waiter
    go."""

    def __init__(self):
        self._cv = threading.Condition()
        self._given = 0
        self._next = 0  # the first ticket not done
        self._early: Set[int] = set()  # done before the ones ahead of them
        self._open = False

    def ticket(self) -> "_Turn":
        with self._cv:
            self._given += 1
            return _Turn(self, self._given - 1)

    def wait(self, k: int) -> None:
        with self._cv:
            self._cv.wait_for(lambda: self._open or k == self._next)

    def done(self, k: int) -> None:
        with self._cv:
            self._early.add(k)
            while self._next in self._early:
                self._early.discard(self._next)
                self._next += 1
            self._cv.notify_all()

    def open(self) -> None:
        with self._cv:
            self._open = True
            self._cv.notify_all()


class _Turn:
    """One item's place in its epoch's :class:`_Turns`; ``done`` may be
    called more than once."""

    def __init__(self, turns: Optional[_Turns], k: int):
        self._turns, self._k = turns, k

    def wait(self) -> None:
        if self._turns is not None:
            self._turns.wait(self._k)

    def done(self) -> None:
        turns, self._turns = self._turns, None
        if turns is not None:
            turns.done(self._k)


def np_mask_to_extended_bbox(labels_dhw: np.ndarray, frac: float = 0.05
                             ) -> np.ndarray:
    """Whole-organ bbox of the nonzero labels of a [D, H, W] volume,
    extended by ``frac`` of its size per face, floored / ceiled and
    clamped to the volume (reference model.py:1057-1075).  Returns [6]
    float32 (z1, y1, x1, z2, y2, x2); zeros for an empty volume.

    Axis-wise ``any`` reductions give the same min / max as
    ``np.nonzero`` without its index arrays."""
    nz = labels_dhw > 0
    axes = [nz.any(axis=(1, 2)), nz.any(axis=(0, 2)), nz.any(axis=(0, 1))]
    if not bool(axes[0].any()):
        return np.zeros(6, np.float32)
    lo = np.array([int(a.argmax()) for a in axes], np.float64)
    hi = np.array([a.size - int(a[::-1].argmax()) for a in axes],
                  np.float64)
    size = hi - lo
    lo = np.floor(np.maximum(lo - frac * size, 0))
    hi = np.ceil(np.minimum(hi + frac * size, labels_dhw.shape))
    return np.concatenate([lo, hi]).astype(np.float32)


def mold_with_labels(image_hwd: np.ndarray, mask_hwd: np.ndarray,
                     cfg: Config, team: Optional[native.Team] = None):
    """A raw [H, W, D] volume and its labels -> ([D, H, W] float32 molded
    volume, [D, H, W] int32 labels) through the native ops
    (``cfun_tpu/data/feeder.py::mold_volume`` with a mask, its native
    branch), on ``team`` when given.  Heart: the trilinear resize, not yet
    normalized; the labels by nearest resize.  LiTS: the HU window, the
    virtual centre-pad and nearest resize; the labels by the same nearest
    map."""
    if cfg.pad_shape is None:
        molded = native.mold_resize(image_hwd, cfg.image_shape,
                                    normalize=False, team=team)
        labels = native.pad_nearest_labels(mask_hwd, mask_hwd.shape[:3],
                                           cfg.image_shape, (0, 0, 0),
                                           team=team)
        return molded, labels
    pd, ph, pw = cfg.pad_shape
    offs = pad_offsets(image_hwd.shape, cfg.pad_shape)
    molded = native.lits_mold(image_hwd, (ph, pw, pd), cfg.image_shape,
                              offs, cfg.hu_window, team=team)
    labels = native.pad_nearest_labels(mask_hwd, (ph, pw, pd),
                                       cfg.image_shape, offs, team=team)
    return molded, labels


def _image_tensor(vol: np.ndarray) -> torch.Tensor:
    """A [D, H, W] wire array as the [1, 1, D, H, W] image: uint16 is the
    bfloat16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(vol))
    if vol.dtype == np.uint16:
        t = t.view(torch.bfloat16)
    return t[None, None]


def _labels_tensor(labels: np.ndarray, cfg: Config) -> torch.Tensor:
    """Two 4-bit labels a byte along W when the classes fit and W is even
    (a quarter of int32's upload), else int8."""
    if cfg.num_classes <= 16 and cfg.image_shape[2] % 2 == 0:
        return torch.from_numpy(pack_labels_w(labels))
    return torch.from_numpy(labels.astype(np.int8))


class TrainFeeder:
    """Bounded-prefetch threaded feeder of ``TrainBatch`` items (or, with
    ``cfg.augment_on_device``, ``AugTrainBatch``), CPU tensors.

    ``shard_index`` / ``num_shards``: each of several processes builds
    the feeder with the same seed and its own index, and takes a strided
    slice of one global plan.  Each item is timed on its worker thread in
    ``spans`` (``utils/profiling.py``): an ``item`` span under the image
    id, with ``load``, ``team`` (the wait for the item's turn on the
    team, counting ``threads``, the team's size), ``mold``, ``labels`` and
    ``rpn`` in it; ``item_times`` holds each finished item's host seconds
    by part (those five, and ``total``, the item's), and ``pop_times``
    takes them.  ``team``: the process's :func:`shared_team`."""

    def __init__(self, dataset, cfg: Config, anchors: np.ndarray,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 8,
                 shard_index: int = 0, num_shards: int = 1,
                 spans: Optional[SpanRecorder] = None):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        if cfg.pad_shape is not None and cfg.intensity_norm != "hu_window":
            raise ValueError("the LiTS molds take the HU window "
                             f"(intensity_norm 'hu_window', not "
                             f"{cfg.intensity_norm!r})")
        self.dataset = dataset
        self.cfg = cfg
        self.anchors = anchors
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = num_shards
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self._lock = threading.Lock()
        # cfg.augment_on_device: the molds are angle-independent, so they
        # are kept across epochs (on the host; the training loop keeps the
        # device copies of cfg.device_mold_cache)
        self._mold_cache: Dict[int, object] = {}
        self.spans = spans or SpanRecorder()
        self.item_times: List[Dict[str, float]] = []
        self.team = shared_team()
        self._epochs: Set[_Turns] = set()  # orders of the epochs in flight

    def pop_times(self) -> List[Dict[str, float]]:
        with self._lock:
            out, self.item_times = self.item_times, []
        return out

    def _plan(self, steps: int, epoch_index: Optional[int] = None):
        """(ids, target seeds) of this shard's ``steps`` items: the global
        plan covers ``steps * num_shards`` items, fresh shuffles of the
        dataset one after another; each shard takes a strided slice.
        With ``epoch_index`` the plan is a function of (seed, epoch), so a
        run resumed at epoch N plans as the uninterrupted one did;
        without it, it comes from the feeder's advancing stream."""
        with self._lock:
            rng = (self._rng if epoch_index is None
                   else np.random.default_rng((self._seed, epoch_index)))
            need = steps * self.num_shards
            ids: List[int] = []
            while len(ids) < need:
                ids.extend(rng.permutation(self.dataset.num_images).tolist())
            ids = ids[:need]
            seeds = rng.integers(0, 2**31 - 1, size=need)
        return (ids[self.shard_index::self.num_shards],
                seeds[self.shard_index::self.num_shards])

    def _record(self, item, parts) -> None:
        """Keep a finished item's seconds: its ``item`` span's and each of
        ``parts``' (spans in it, summed by name)."""
        marks = {"load": 0.0, "team": 0.0, "mold": 0.0, "labels": 0.0,
                 "rpn": 0.0}
        for part in parts:
            marks[part.name] += part.seconds
        marks["total"] = item.seconds
        with self._lock:
            self.item_times.append(marks)

    def _load(self, image_id: int):
        """The raw [H, W, D] volume and labels of ``image_id``, laid out as
        the native ops take them (C-contiguous float32 and int32), here on
        the worker's thread rather than on the team."""
        image = self.dataset.load_image(image_id)  # [H, W, D(, 1)]
        mask = self.dataset.load_mask(image_id)    # [H, W, D]
        img = image[..., 0] if image.ndim == 4 else image
        return (np.ascontiguousarray(img, np.float32),
                np.ascontiguousarray(mask, np.int32))

    def _wait_turn(self, turn: _Turn, image_id: int):
        """Wait for ``turn`` on the team, timed as the ``team`` span."""
        with self.spans.span("team", image_id,
                             threads=self.team.threads) as waited:
            turn.wait()
        return waited

    def _unrotated_item(self, image_id: int, turn: _Turn):
        """The ``AugTrainBatch`` of ``cfg.augment_on_device``: the
        unrotated molded volume (z-scored on the host; the device rotates
        and re-z-scores, exact since the z-score is affine-invariant) and
        its labels on the wire, with ``fill`` the wire value of a raw 0
        voxel (what the rotation fills with).  Kept across epochs."""
        cfg = self.cfg
        if cfg.pad_shape is not None:
            raise ValueError(
                "augment_on_device supports the heart molding only "
                "(rotate after resize); LiTS rotates the raw volume before "
                "its pad + resize mold")
        with self._lock:
            cached = self._mold_cache.get(image_id)
        if cached is not None:
            return cached
        span = self.spans.span
        with span("item", image_id) as whole:
            with span("load", image_id) as load:
                img, mask = self._load(image_id)
            team = self._wait_turn(turn, image_id)
            with span("labels", image_id) as lab:
                labels = native.pad_nearest_labels(mask, mask.shape[:3],
                                                   cfg.image_shape,
                                                   (0, 0, 0), team=self.team)
            with span("mold", image_id) as mold:
                molded = native.mold_resize(img, cfg.image_shape,
                                            normalize=False, team=self.team)
                turn.done()
                m = float(molded.mean())
                s = float(molded.std()) or 1.0
                y = (molded.astype(np.float32) - m) / s
                fill = np.float32((0.0 - m) / s)
                if cfg.train_wire_int8:
                    image_out = torch.from_numpy(
                        (np.clip(y, -5.0, 5.0)
                         * cfg.wire_int8_scale).astype(np.int8))
                    fill = np.float32(np.clip(fill, -5.0, 5.0))
                elif cfg.compute_dtype == "bfloat16":
                    image_out = torch.from_numpy(y).to(torch.bfloat16)
                else:
                    image_out = torch.from_numpy(y)
            item = AugTrainBatch(image=image_out[None, None],
                                 labels=_labels_tensor(labels, cfg),
                                 angle=0.0, fill=float(fill))
            with self._lock:
                self._mold_cache[image_id] = item
        self._record(whole, (load, team, lab, mold))
        return item

    def make_item(self, image_id: int, angle: float, seed: int,
                  turn: Optional[_Turn] = None):
        """The example ``image_id`` at rotation ``angle`` (degrees), its
        RPN targets subsampled with ``default_rng(seed)``: a
        ``TrainBatch`` of CPU tensors (image [1, 1, D, H, W] in the wire
        type: bf16, int8 with ``cfg.train_wire_int8``, or float32), or
        with ``cfg.augment_on_device`` the cached ``AugTrainBatch`` at
        ``angle`` (``seed`` unused: the device draws its subsample).
        ``turn``: the item's place in its epoch's order on the team (none:
        it takes the team as soon as the team is free)."""
        turn = turn or _Turn(None, 0)
        try:
            return self._item(image_id, angle, seed, turn)
        finally:
            turn.done()

    def _item(self, image_id: int, angle: float, seed: int, turn: _Turn):
        cfg = self.cfg
        if cfg.augment_on_device:
            return self._unrotated_item(image_id, turn)._replace(
                angle=float(np.float32(angle)))
        span = self.spans.span
        with span("item", image_id) as whole:
            with span("load", image_id) as load:
                img, mask = self._load(image_id)
            team = self._wait_turn(turn, image_id)
            with span("mold", image_id) as mold:
                image_out, molded, labels = self._mold(img, mask, angle)
            with span("labels", image_id) as lab:
                if labels is None:
                    labels = self._train_labels(img, mask, angle)
            turn.done()
            with span("rpn", image_id) as rpn:
                gt_box = np_mask_to_extended_bbox(labels)
                rpn_match, rpn_deltas = build_rpn_targets(
                    self.anchors, gt_box, cfg, np.random.default_rng(seed))
            if image_out is None:  # float32 compute
                image_out = molded.astype(np.float32)
                if cfg.train_wire_int8:
                    # the int8 train wire: clip +-5 (z-scored) or the HU
                    # window's [0, 1], quantize; the step dequantizes
                    image_out = (np.clip(image_out, -5.0, 5.0)
                                 * cfg.wire_int8_scale).astype(np.int8)
            d, h, w = cfg.image_shape
            norm = np.array([d, h, w, d, h, w], np.float32)
            item = TrainBatch(
                image=_image_tensor(image_out),
                rpn_match=torch.from_numpy(rpn_match),
                rpn_deltas=torch.from_numpy(rpn_deltas),
                gt_box_norm=torch.from_numpy(
                    (gt_box / norm).astype(np.float32)),
                labels=_labels_tensor(labels, cfg))
        self._record(whole, (load, team, mold, lab, rpn))
        return item

    def _mold(self, img: np.ndarray, mask: np.ndarray, angle: float):
        """(the wire image of the bf16 molds or None, the float32 molded
        volume or None, the molded labels where the mold made them or
        None) of a raw volume at ``angle``."""
        cfg, team = self.cfg, self.team
        if cfg.pad_shape is None:
            if cfg.compute_dtype == "bfloat16":
                # heart: mold, then rotate the molded volume (load_image_gt)
                if cfg.train_wire_int8:
                    return native.heart_train_mold_q8(
                        img, cfg.image_shape, angle, 5.0,
                        cfg.wire_int8_scale, team=team), None, None
                return native.heart_train_mold(img, cfg.image_shape, angle,
                                               team=team), None, None
            molded, labels = mold_with_labels(img, mask, cfg, team)
            if angle != 0.0:
                molded = rotate_hw(molded.transpose(1, 2, 0), angle,
                                   order=0).transpose(2, 0, 1)
                labels = rotate_hw(labels.transpose(1, 2, 0), angle,
                                   order=0).transpose(2, 0, 1)
            return None, normalize_intensity(molded, cfg), labels
        if cfg.compute_dtype == "bfloat16":
            # LiTS: the raw rotation composed into the pad + resize
            # gather, straight to the wire (LiTS_2017/model.py:1211-1233)
            pd, ph, pw = cfg.pad_shape
            offs = pad_offsets(img.shape, cfg.pad_shape)
            if cfg.train_wire_int8:
                return native.lits_train_mold_q8(
                    img, (ph, pw, pd), cfg.image_shape, offs, angle,
                    cfg.hu_window, 5.0, cfg.wire_int8_scale,
                    team=team), None, None
            return native.lits_train_mold(
                img, (ph, pw, pd), cfg.image_shape, offs, angle,
                cfg.hu_window, team=team), None, None
        # LiTS in float32: rotate the raw volume, then mold it
        if angle != 0.0:
            img = rotate_hw(img, angle, order=0)
            mask = rotate_hw(mask, angle, order=0)
        molded, labels = mold_with_labels(img, mask, cfg, team)
        return None, molded, labels

    def _train_labels(self, img: np.ndarray, mask: np.ndarray,
                      angle: float) -> np.ndarray:
        """The labels of the bf16 molds: the same maps as the image's."""
        cfg = self.cfg
        if cfg.pad_shape is None:
            return native.heart_train_labels(mask, cfg.image_shape, angle,
                                             team=self.team)
        pd, ph, pw = cfg.pad_shape
        offs = pad_offsets(img.shape, cfg.pad_shape)
        return native.lits_train_labels(mask, (ph, pw, pd), cfg.image_shape,
                                        offs, angle, team=self.team)

    def epoch(self, angle: float, steps: int,
              epoch_index: Optional[int] = None) -> Iterator:
        """Yield ``steps`` items of this shard's plan (see ``_plan``),
        ``prefetch`` of them in flight on the workers, each taking the team
        in the order it is yielded in.  A volume that fails is replaced by another from
        ``default_rng((seed, epoch, 2, n))`` (n: the failures so far this
        epoch; the advancing stream without ``epoch_index``), and the
        count of items holds."""
        ids, seeds = self._plan(steps, epoch_index)
        order = _Turns()  # the items' order on the team
        with self._lock:
            self._epochs.add(order)

        def submit(image_id: int, seed: int):
            return (image_id, self._pool.submit(
                self.make_item, image_id, angle, seed, order.ticket()))

        futures: deque = deque()
        it = iter(zip(ids, seeds))
        emitted = failures = 0
        try:
            for _ in range(min(self.prefetch, steps)):
                i, s = next(it)
                futures.append(submit(i, int(s)))
            while futures and emitted < steps:
                image_id, fut = futures.popleft()
                try:
                    item = fut.result()
                except Exception as e:  # noqa: BLE001 -- a volume's fault
                    print(f"[feeder] volume {image_id} failed ({e!r}); "
                          "substituting", flush=True)
                    rng = (self._rng if epoch_index is None else
                           np.random.default_rng(
                               (self._seed, epoch_index, 2, failures)))
                    failures += 1
                    sub = int(rng.integers(self.dataset.num_images))
                    sseed = int(rng.integers(0, 2**31 - 1))
                    futures.append(submit(sub, sseed))
                    continue
                yield item
                emitted += 1
                nxt = next(it, None)
                if nxt is not None:
                    futures.append(submit(nxt[0], int(nxt[1])))
        finally:
            for _i, f in futures:
                f.cancel()
            # a cancelled item never takes its turn: the order ends here
            order.open()
            with self._lock:
                self._epochs.discard(order)

    def close(self) -> None:
        with self._lock:
            for order in self._epochs:
                order.open()
        self._pool.shutdown(wait=False, cancel_futures=True)
