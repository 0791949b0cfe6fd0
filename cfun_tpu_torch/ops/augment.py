"""Training augmentation on the device (the port of
``cfun_tpu/ops/augment.py``): rotation, GT box and RPN targets.

With ``Config.augment_on_device`` the feeder ships the unrotated molded
volume, which does not depend on the angle and is kept across epochs
(``TrainFeeder``; with ``device_mold_cache`` in device memory), and the
step rotates it, re-z-scores it and builds the targets here.

The host path's semantics, kept:

* rotation: ``data/resample.py::rotate_hw`` order 0, inverse-mapped
  nearest with round-half-to-even and constant fill (the reference's
  slice-wise imgaug Affine, model.py:1019-1052).  The heart rotates the
  molded volume before its z-score; the z-score is affine-invariant, so
  rotating the wired (z-scored) volume with ``fill`` = the wire value of a
  raw 0 voxel and re-z-scoring equals ``zscore(rotate(raw_molded))``.
* GT box: ``data/feeder.py::np_mask_to_extended_bbox``.
* RPN targets: ``train/targets.py::build_rpn_targets`` (reference
  model.py:1090-1181), the subsample from two uniform draws over the
  anchors (``AugmentDraws``, taken before the step) in place of the
  host's NumPy generator: another random subset of the same law.

Only the heart molding (rotate after resize) is supported: LiTS rotates
the raw volume before its pad + resize, and rotation does not commute
with resampling.  The rotation grid is float32 (the host's float64), so
voxels at rounding ties can differ from the host's; the top-k of the
subsample is exact (the JAX package may take ``approx_max_k``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from cfun_tpu_torch.config import Config
from cfun_tpu_torch.models.cfun import _top_desc
from cfun_tpu_torch.ops.boxes import device_constant


class AugTrainBatch(NamedTuple):
    """An unrotated molded example; the step augments it on the device."""
    image: torch.Tensor  # [1, 1, D, H, W] wire type (bf16 / f32 / int8)
    labels: torch.Tensor  # [D, H, W] int8 or [D, H, W/2] 4-bit packed
    angle: float  # degrees (one an epoch), a float32 value
    fill: float  # the wire value of a raw 0 voxel, a float32 value


class AugmentDraws(NamedTuple):
    """The RPN subsample's uniforms over the anchors: positives' and
    negatives' (the JAX package's ``uniform(k_pos)``, ``uniform(k_neg)``
    of ``rpn_targets_device``)."""
    u_pos: torch.Tensor  # [A] float32
    u_neg: torch.Tensor  # [A] float32


def draw_augment(num_anchors: int, generator: torch.Generator,
                 device) -> AugmentDraws:
    """Two uniform draws over the anchors from ``generator`` (on its own
    device), placed on ``device``."""
    u = [torch.rand(num_anchors, generator=generator,
                    device=generator.device).to(device) for _ in range(2)]
    return AugmentDraws(*u)


def rotate_hw_device(vol: torch.Tensor, angle_deg: float,
                     fill=0.0) -> torch.Tensor:
    """Rotate every [H, W] slice of ``vol`` [D, H, W] about the slice
    centre by ``angle_deg``, nearest with constant ``fill`` outside: the
    device form of ``resample.rotate_hw(order=0)``.  The grid is float32,
    its sine and cosine the float32 ones of the angle; no host copy."""
    _, h, w = vol.shape
    theta = torch.deg2rad(torch.tensor(float(angle_deg), dtype=torch.float32))
    cos_t, sin_t = float(torch.cos(theta)), float(torch.sin(theta))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=vol.device),
        torch.arange(w, dtype=torch.float32, device=vol.device),
        indexing="ij")
    ys = cos_t * (yy - cy) - sin_t * (xx - cx) + cy
    xs = sin_t * (yy - cy) + cos_t * (xx - cx) + cx
    inside = (ys >= -0.5) & (ys <= h - 0.5) & (xs >= -0.5) & (xs <= w - 0.5)
    # torch.round rounds half to even, as np.round
    yi = torch.round(ys).to(torch.int64).clamp(0, h - 1)
    xi = torch.round(xs).to(torch.int64).clamp(0, w - 1)
    return torch.where(inside[None], vol[:, yi, xi], fill)


def extended_bbox(labels: torch.Tensor, frac: float = 0.05) -> torch.Tensor:
    """Whole-organ bbox of the nonzero ``labels`` [D, H, W], extended by
    ``frac`` per face: [6] float32 (z1, y1, x1, z2, y2, x2), zeros when
    empty -- the device form of ``feeder.np_mask_to_extended_bbox``, with
    no host sync."""
    nz = labels > 0
    axes = [nz.any(dim=2).any(dim=1), nz.any(dim=2).any(dim=0),
            nz.any(dim=1).any(dim=0)]
    lo, hi = [], []
    for a in axes:
        n = a.shape[0]
        idx = torch.arange(n, device=a.device)
        first = torch.where(a, idx, n).min().to(torch.float32)
        end = torch.where(a, idx + 1, 0).max().to(torch.float32)
        size = end - first
        lo.append(torch.floor(torch.clamp(first - frac * size, min=0.0)))
        hi.append(torch.ceil(torch.clamp(end + frac * size, max=float(n))))
    box = torch.stack(lo + hi)
    return torch.where(axes[0].any(), box, torch.zeros_like(box))


def _random_keep(u: torch.Tensor, mask: torch.Tensor, k: int,
                 limit=None) -> torch.Tensor:
    """Bool [A] selecting up to ``k`` uniformly random True positions of
    ``mask`` (the ``k`` largest of ``u`` among them); with ``limit`` (a
    0-d tensor) only the first ``min(k, limit)`` by rank."""
    score = torch.where(mask, u, torch.full_like(u, -1.0))
    top, idx = _top_desc(score, k)
    ok = top >= 0.0
    if limit is not None:
        ok = ok & (torch.arange(k, device=u.device) < limit)
    keep = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    return keep.index_put((idx,), ok)


def rpn_targets_device(anchors: torch.Tensor, gt_box: torch.Tensor,
                       cfg: Config, draws: AugmentDraws
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device form of ``targets.build_rpn_targets``: match the anchors
    [A, 6] (voxel coordinates) to the organ box ``gt_box`` [6], subsample
    to the training quota with ``draws``, dense per-anchor deltas.

    Returns (match [A] int8 in {-1, 0, 1}, deltas [A, 6] float32 over
    RPN_BBOX_STD_DEV, zero off the positives).  An empty box (the
    rotation took every foreground voxel out of the slice) makes the
    whole item neutral: no forced positive with log(0) deltas."""
    a = anchors.to(torch.float32)
    g = gt_box.to(torch.float32)
    lo = torch.maximum(a[:, :3], g[:3])
    hi = torch.minimum(a[:, 3:], g[3:])
    inter = torch.prod(torch.clamp(hi - lo, min=0.0), dim=1)
    vol_a = torch.prod(a[:, 3:] - a[:, :3], dim=1)
    vol_g = torch.prod(g[3:] - g[:3])
    iou = inter / (vol_a + vol_g - inter + 1e-6)
    valid = vol_g > 0.0

    num = a.shape[0]
    # torch.argmax takes the first of equal maxima, as jnp.argmax
    first_max = torch.arange(num, device=a.device) == torch.argmax(iou)
    pos = ((iou >= 0.7) | first_max) & valid
    neg = (iou < 0.3) & ~pos & valid

    quota = cfg.rpn_train_anchors_per_image
    # positives capped at half the quota (the host demotes the excess at
    # random, model.py:1128-1134), negatives fill the rest
    keep_pos = _random_keep(draws.u_pos, pos, min(quota // 2, num))
    n_pos = keep_pos.sum()
    keep_neg = _random_keep(draws.u_neg, neg, min(quota, num),
                            limit=quota - n_pos)
    # the two sets are disjoint (neg excludes pos)
    match = keep_pos.to(torch.int8) - keep_neg.to(torch.int8)

    size_a = a[:, 3:] - a[:, :3]
    center_a = a[:, :3] + 0.5 * size_a
    # an empty box is masked out above; the clamp keeps log(0) out of the
    # masked lanes
    size_g = torch.clamp(g[3:] - g[:3], min=1e-3)
    center_g = g[:3] + 0.5 * size_g
    deltas = torch.cat([(center_g - center_a) / size_a,
                        torch.log(size_g / size_a)], dim=1)
    deltas = deltas / device_constant(cfg.rpn_bbox_std, torch.float32,
                                      a.device)
    deltas = torch.where(keep_pos[:, None], deltas, torch.zeros_like(deltas))
    return match, deltas


def device_augment(batch: AugTrainBatch, anchors: torch.Tensor, cfg: Config,
                   draws: AugmentDraws):
    """Rotate, re-z-score, GT box and RPN targets on the batch's device;
    returns a ``TrainBatch`` for ``train_forward``."""
    from cfun_tpu_torch.train.step import TrainBatch, unpack_labels_w

    labels = batch.labels
    if labels.shape[-1] == cfg.image_shape[2] // 2:
        labels = unpack_labels_w(labels)
    else:
        labels = labels.to(torch.int32)
    image = batch.image
    if image.dtype == torch.int8:
        image = image.to(torch.float32) * (1.0 / cfg.wire_int8_scale)
    else:
        image = image.to(torch.float32)

    vol = rotate_hw_device(image[0, 0], batch.angle, batch.fill)
    # the host rotates, then z-scores (feeder make_item); the wire is an
    # affine image of the molded volume with raw 0 at `fill`, so the
    # re-z-score here equals zscore(rotate(molded))
    mean = vol.mean()
    std = vol.std(correction=0)
    vol = (vol - mean) / torch.where(std > 0, std, torch.ones_like(std))

    labels_rot = rotate_hw_device(labels, batch.angle, 0)
    gt_box = extended_bbox(labels_rot)
    match, deltas = rpn_targets_device(anchors, gt_box, cfg, draws)
    d, h, w = cfg.image_shape
    norm = device_constant((d, h, w, d, h, w), torch.float32, gt_box.device)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    return TrainBatch(image=vol[None, None].to(dtype), rpn_match=match,
                      rpn_deltas=deltas, gt_box_norm=gt_box / norm,
                      labels=labels_rot)
