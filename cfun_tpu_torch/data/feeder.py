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

Items are bit-equal to the JAX package's at the same image id, angle and
seed, and the plan of an epoch (ids and target seeds) is the JAX
package's.  One deviation: a volume that fails to load is replaced by a
draw from ``default_rng((seed, epoch, 2, n))`` (n: the epoch's failures
so far) where the JAX package draws from the feeder's advancing stream, so
a resumed run substitutes as the uninterrupted one did.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from cfun_tpu_torch import native
from cfun_tpu_torch.config import Config
from cfun_tpu_torch.data.mold import normalize_intensity, pad_offsets
from cfun_tpu_torch.data.resample import rotate_hw


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
                     cfg: Config):
    """A raw [H, W, D] volume and its labels -> ([D, H, W] float32 molded
    volume, [D, H, W] int32 labels) through the native ops
    (``cfun_tpu/data/feeder.py::mold_volume`` with a mask, its native
    branch).  Heart: the trilinear resize, not yet normalized; the labels
    by nearest resize.  LiTS: the HU window, the virtual centre-pad and
    nearest resize; the labels by the same nearest map."""
    if cfg.pad_shape is None:
        molded = native.mold_resize(image_hwd, cfg.image_shape,
                                    normalize=False)
        labels = native.pad_nearest_labels(mask_hwd, mask_hwd.shape[:3],
                                           cfg.image_shape, (0, 0, 0))
        return molded, labels
    pd, ph, pw = cfg.pad_shape
    offs = pad_offsets(image_hwd.shape, cfg.pad_shape)
    molded = native.lits_mold(image_hwd, (ph, pw, pd), cfg.image_shape,
                              offs, cfg.hu_window)
    labels = native.pad_nearest_labels(mask_hwd, (ph, pw, pd),
                                       cfg.image_shape, offs)
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
    from cfun_tpu_torch.train.step import pack_labels_w

    if cfg.num_classes <= 16 and cfg.image_shape[2] % 2 == 0:
        return torch.from_numpy(pack_labels_w(labels))
    return torch.from_numpy(labels.astype(np.int8))


class TrainFeeder:
    """Bounded-prefetch threaded feeder of ``TrainBatch`` items (or, with
    ``cfg.augment_on_device``, ``AugTrainBatch``), CPU tensors.

    ``shard_index`` / ``num_shards``: each of several processes builds
    the feeder with the same seed and its own index, and takes a strided
    slice of one global plan.  ``item_times`` holds each finished item's
    host seconds by part (load, mold, labels, rpn, total);
    ``pop_times`` takes them."""

    def __init__(self, dataset, cfg: Config, anchors: np.ndarray,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 8,
                 shard_index: int = 0, num_shards: int = 1):
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
        self.item_times: List[Dict[str, float]] = []

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

    def _record(self, t0: float, marks: Dict[str, float]) -> None:
        marks["total"] = time.perf_counter() - t0
        with self._lock:
            self.item_times.append(marks)

    def _unrotated_item(self, image_id: int):
        """The ``AugTrainBatch`` of ``cfg.augment_on_device``: the
        unrotated molded volume (z-scored on the host; the device rotates
        and re-z-scores, exact since the z-score is affine-invariant) and
        its labels on the wire, with ``fill`` the wire value of a raw 0
        voxel (what the rotation fills with).  Kept across epochs."""
        from cfun_tpu_torch.ops.augment import AugTrainBatch

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
        t0 = time.perf_counter()
        image = self.dataset.load_image(image_id)
        mask = self.dataset.load_mask(image_id)
        img = image[..., 0] if image.ndim == 4 else image
        t1 = time.perf_counter()
        molded = native.mold_resize(img, cfg.image_shape, normalize=False)
        t2 = time.perf_counter()
        labels = native.pad_nearest_labels(mask, mask.shape[:3],
                                           cfg.image_shape, (0, 0, 0))
        t3 = time.perf_counter()
        m = float(molded.mean())
        s = float(molded.std()) or 1.0
        y = (molded.astype(np.float32) - m) / s
        fill = np.float32((0.0 - m) / s)
        if cfg.train_wire_int8:
            image_out = torch.from_numpy(
                (np.clip(y, -5.0, 5.0) * cfg.wire_int8_scale).astype(np.int8))
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
        self._record(t0, {"load": t1 - t0, "mold": t2 - t1 + (
            time.perf_counter() - t3), "labels": t3 - t2, "rpn": 0.0})
        return item

    def make_item(self, image_id: int, angle: float, seed: int):
        """The example ``image_id`` at rotation ``angle`` (degrees), its
        RPN targets subsampled with ``default_rng(seed)``: a
        ``TrainBatch`` of CPU tensors (image [1, 1, D, H, W] in the wire
        type: bf16, int8 with ``cfg.train_wire_int8``, or float32), or
        with ``cfg.augment_on_device`` the cached ``AugTrainBatch`` at
        ``angle`` (``seed`` unused: the device draws its subsample)."""
        from cfun_tpu_torch.train.step import TrainBatch
        from cfun_tpu_torch.train.targets import build_rpn_targets

        cfg = self.cfg
        if cfg.augment_on_device:
            return self._unrotated_item(image_id)._replace(
                angle=float(np.float32(angle)))
        t0 = time.perf_counter()
        image = self.dataset.load_image(image_id)  # [H, W, D(, 1)]
        mask = self.dataset.load_mask(image_id)    # [H, W, D]
        img = image[..., 0] if image.ndim == 4 else image
        t1 = time.perf_counter()
        bf16 = cfg.compute_dtype == "bfloat16"
        image_out = labels = None
        t_labels = 0.0
        if cfg.pad_shape is None:
            # heart: mold, then rotate the molded volume (load_image_gt)
            if bf16:
                if cfg.train_wire_int8:
                    image_out = native.heart_train_mold_q8(
                        img, cfg.image_shape, angle, 5.0,
                        cfg.wire_int8_scale)
                else:
                    image_out = native.heart_train_mold(img, cfg.image_shape,
                                                        angle)
                t2 = time.perf_counter()
                labels = native.heart_train_labels(mask, cfg.image_shape,
                                                   angle)
                t_labels = time.perf_counter() - t2
            else:
                molded, labels = mold_with_labels(img, mask, cfg)
                if angle != 0.0:
                    molded = rotate_hw(molded.transpose(1, 2, 0), angle,
                                       order=0).transpose(2, 0, 1)
                    labels = rotate_hw(labels.transpose(1, 2, 0), angle,
                                       order=0).transpose(2, 0, 1)
                molded = normalize_intensity(molded, cfg)
        elif bf16:
            # LiTS: the raw rotation composed into the pad + resize
            # gather, straight to the wire (LiTS_2017/model.py:1211-1233)
            pd, ph, pw = cfg.pad_shape
            offs = pad_offsets(img.shape, cfg.pad_shape)
            if cfg.train_wire_int8:
                image_out = native.lits_train_mold_q8(
                    img, (ph, pw, pd), cfg.image_shape, offs, angle,
                    cfg.hu_window, 5.0, cfg.wire_int8_scale)
            else:
                image_out = native.lits_train_mold(
                    img, (ph, pw, pd), cfg.image_shape, offs, angle,
                    cfg.hu_window)
            t2 = time.perf_counter()
            labels = native.lits_train_labels(mask, (ph, pw, pd),
                                              cfg.image_shape, offs, angle)
            t_labels = time.perf_counter() - t2
        else:
            # LiTS in float32: rotate the raw volume, then mold it
            if angle != 0.0:
                img = rotate_hw(img, angle, order=0)
                mask = rotate_hw(mask, angle, order=0)
            molded, labels = mold_with_labels(img, mask, cfg)
        t3 = time.perf_counter()

        gt_box = np_mask_to_extended_bbox(labels)
        rpn_match, rpn_deltas = build_rpn_targets(
            self.anchors, gt_box, cfg, np.random.default_rng(seed))
        t4 = time.perf_counter()
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
            gt_box_norm=torch.from_numpy((gt_box / norm).astype(np.float32)),
            labels=_labels_tensor(labels, cfg))
        self._record(t0, {"load": t1 - t0, "mold": t3 - t1 - t_labels,
                          "labels": t_labels, "rpn": t4 - t3})
        return item

    def epoch(self, angle: float, steps: int,
              epoch_index: Optional[int] = None) -> Iterator:
        """Yield ``steps`` items of this shard's plan (see ``_plan``),
        ``prefetch`` of them in flight on the workers.  A volume that
        fails is replaced by another from ``default_rng((seed, epoch, 2,
        n))`` (n: the failures so far this epoch; the advancing stream
        without ``epoch_index``), and the count of items holds."""
        ids, seeds = self._plan(steps, epoch_index)
        futures: deque = deque()
        it = iter(zip(ids, seeds))
        emitted = failures = 0
        try:
            for _ in range(min(self.prefetch, steps)):
                i, s = next(it)
                futures.append(
                    (i, self._pool.submit(self.make_item, i, angle, int(s))))
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
                    futures.append(
                        (sub, self._pool.submit(self.make_item, sub, angle,
                                                sseed)))
                    continue
                yield item
                emitted += 1
                nxt = next(it, None)
                if nxt is not None:
                    futures.append(
                        (nxt[0], self._pool.submit(self.make_item, nxt[0],
                                                   angle, int(nxt[1]))))
        finally:
            for _i, f in futures:
                f.cancel()

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
