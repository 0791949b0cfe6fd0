"""The CFUN inference graph (port of ``cfun_tpu/models/cfun.py``).

trunk -> propose (top-k + NMS) -> pyramid RoIAlign -> classifier ->
refine_detections (NMS again) -> RoIAlign crop of the raw image -> U-Net
mask head (dense, or fused with ``Config.pallas_unet``) -> on-device 2x
trilinear upsample (none at 'finetune', whose mask is already 2x) +
argmax, or the overlap-tile paste of every detection into the molded
volume (LiTS, and any config with more than one instance) -> one packed
int8 buffer.  Every dynamic shape is fixed-capacity
with a validity mask, as in the JAX graph.

Both NMS sites take an ``nms`` callable with the contract of
``ops/sorted_nms.py::sorted_nms`` (score-sorted boxes, valid, threshold,
k); the default is that wrapper, which launches the CUDA kernel on CUDA
tensors.  Top-k is exact (a stable descending sort: the lower index wins a
tie, as in ``lax.top_k``), whatever ``Config.approx_topk`` says.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cfun_tpu_torch import nn
from cfun_tpu_torch.config import Config
from cfun_tpu_torch.models.fpn import apply_fpn
from cfun_tpu_torch.models.heads import apply_classifier, apply_mask_head
from cfun_tpu_torch.models.p3d import apply_p3d
from cfun_tpu_torch.models.rpn import apply_rpn
from cfun_tpu_torch.ops.boxes import (apply_box_deltas, clip_boxes,
                                      denormalize_boxes, device_constant,
                                      normalize_boxes)
from cfun_tpu_torch.ops.nms import nms_gather
from cfun_tpu_torch.ops.sample3d import roi_align
from cfun_tpu_torch.ops.sorted_nms import sorted_nms

NmsFn = Callable[[torch.Tensor, torch.Tensor, float, int],
                 Tuple[torch.Tensor, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: Config) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def _top_desc(scores: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k, lower index first on ties (``lax.top_k``'s order)."""
    values, order = torch.sort(scores, descending=True, stable=True)
    return values[:k], order[:k]


class TrunkOut(NamedTuple):
    p2: torch.Tensor  # [B, C, D/8, H/8, W/8]
    p3: torch.Tensor  # [B, C, D/16, H/16, W/16]
    rpn_logits: torch.Tensor  # [B, A, 2]
    rpn_deltas: torch.Tensor  # [B, A, 6]


def apply_trunk(params: nn.Params, image: torch.Tensor, cfg: Config,
                remat: bool = False) -> TrunkOut:
    """image: [B, 1, D, H, W] molded volume.  ``remat``: checkpoint each
    backbone block (``models/p3d.py::apply_p3d``)."""
    dt = compute_dtype(cfg)
    c2, c3 = apply_p3d(params["backbone"], image, dtype=dt, remat=remat)
    p2, p3 = apply_fpn(params["fpn"], c2, c3, dtype=dt)
    l2, d2 = apply_rpn(params["rpn"], p2, cfg.anchor_stride, dtype=dt)
    l3, d3 = apply_rpn(params["rpn"], p3, cfg.anchor_stride, dtype=dt)
    return TrunkOut(p2, p3, torch.cat([l2, l3], dim=1),
                    torch.cat([d2, d3], dim=1))


def propose(rpn_logits: torch.Tensor, rpn_deltas: torch.Tensor,
            anchors: torch.Tensor, cfg: Config, proposal_count: int,
            nms: NmsFn = sorted_nms) -> Tuple[torch.Tensor, torch.Tensor]:
    """Proposal layer for one image (reference model.py:199-258).

    rpn_logits/deltas: [A, 2] / [A, 6]; anchors: [A, 6] voxel coords.
    Returns (proposals [P, 6] normalized + zero-padded, valid [P] bool).
    The NMS takes the boxes detached (its kernel has no backward, as
    ``pallas_call`` has no JVP), so the proposals carry no gradient back to
    the NMS; the train step detaches them too.
    """
    scores = torch.softmax(rpn_logits, dim=-1)[:, 1]
    deltas = rpn_deltas * device_constant(cfg.rpn_bbox_std, torch.float32,
                                          rpn_deltas.device)
    pre = min(cfg.pre_nms_limit, anchors.shape[0])
    _, order = _top_desc(scores, pre)
    boxes = apply_box_deltas(anchors[order], deltas[order])
    d, h, w = cfg.image_shape
    boxes = clip_boxes(boxes, device_constant((0, 0, 0, d, h, w),
                                              boxes.dtype, boxes.device))

    valid = torch.ones(pre, dtype=torch.bool, device=boxes.device)
    idx, keep = nms(boxes.detach(), valid, cfg.rpn_nms_threshold,
                    proposal_count)
    proposals = nms_gather(boxes, idx, keep)
    return normalize_boxes(proposals, cfg.image_shape), keep


def pyramid_roi_align(boxes: torch.Tensor, p2: torch.Tensor,
                      p3: torch.Tensor, pool_size) -> torch.Tensor:
    """FPN-level-assigned RoIAlign (reference model.py:292-370).

    boxes: [K, 6] normalized; p2/p3: [C, D, H, W].  Each box is pooled from
    both levels and the result picked by ``level = clamp(round(4 +
    log2(dhw)/3), 2, 3)``.  Returns [K, C, *pool_size].
    """
    size = torch.clamp(boxes[:, 3:] - boxes[:, :3], min=1e-9)
    vol = size[:, 0] * size[:, 1] * size[:, 2]
    level = torch.clamp(torch.round(4.0 + torch.log2(vol) / 3.0), 2, 3)
    pooled2 = roi_align(p2, boxes, tuple(pool_size))
    pooled3 = roi_align(p3, boxes, tuple(pool_size))
    sel = (level == 2)[:, None, None, None, None]
    return torch.where(sel, pooled2, pooled3)


def refine_detections(rois: torch.Tensor, roi_valid: torch.Tensor,
                      probs: torch.Tensor, deltas: torch.Tensor,
                      window: torch.Tensor, cfg: Config,
                      nms: NmsFn = sorted_nms
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Detection layer (reference model.py:584-676), fixed capacity.

    rois: [K, 6] normalized; probs: [K, 2]; deltas: [K, 2, 6]; window: [6]
    voxel coords of the un-padded image.  Returns (detections [Dmax, 8] =
    (box, class_id, score) in voxel coords, keep [Dmax] bool); padded
    slots are zero.
    """
    class_ids = torch.argmax(probs, dim=-1)
    scores = torch.gather(probs, 1, class_ids[:, None])[:, 0]
    sel_deltas = deltas[torch.arange(deltas.shape[0],
                                     device=deltas.device), class_ids]
    # the reference scales with RPN_BBOX_STD_DEV here (model.py:610)
    refined = apply_box_deltas(rois, sel_deltas * device_constant(
        cfg.rpn_bbox_std, torch.float32, rois.device))
    refined = denormalize_boxes(refined, cfg.image_shape)
    refined = clip_boxes(refined, window)
    refined = torch.round(refined)

    keep = roi_valid & (class_ids > 0) & \
        (scores >= cfg.detection_min_confidence)
    # the classifier is binary, so one NMS pass covers the only FG class;
    # sort first so the NMS sees score-descending input
    _, order = _top_desc(scores, scores.shape[0])
    idx_s, kept = nms(refined[order], keep[order],
                      cfg.detection_nms_threshold,
                      cfg.detection_max_instances)
    idx = order[idx_s.long()]
    det_boxes = nms_gather(refined, idx, kept)
    zero = torch.zeros((), dtype=torch.float32, device=rois.device)
    det = torch.cat(
        [det_boxes,
         torch.where(kept, class_ids[idx].float(), zero)[:, None],
         torch.where(kept, scores[idx], zero)[:, None]], dim=1)
    return det, kept


def uses_overlap_paste(cfg: Config) -> bool:
    """Fast-path unmold variant: the device overlap-tile paste emits one
    molded label volume.  Always for LiTS (the reference's overlap
    averaging, LiTS_2017/utils.py:383-408); for other configs whenever
    more than one instance can be detected (the multi-instance heart
    adopts the LiTS averaging, as in the JAX package)."""
    return cfg.fast_unmold and (cfg.name == "lits"
                                or cfg.detection_max_instances > 1)


def _paste_weights(lo: torch.Tensor, hi: torch.Tensor, m: int, n: int,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One axis of the overlap paste for K boxes [lo, hi) along an axis of
    ``n`` voxels, from a mask of ``m`` voxels: (the [K, n, m] trilinear
    weights of ``jax.image.scale_and_translate`` (half-pixel, antialias
    off), zero outside the box; the [K, n] inside-the-box mask).

    The source coordinate ``(i + 0.5) / s - lo / s - 0.5`` with ``s =
    max(hi - lo, 1) / m`` is clamped to [0, m - 1]: the two taps that
    remain equal ``scale_and_translate``'s renormalised edge weights.  A
    sample beyond half a voxel outside the mask weighs 0, as there."""
    i = torch.arange(n, dtype=torch.float32, device=lo.device)[None]
    lo, hi = lo[:, None], hi[:, None]
    inv = 1.0 / (torch.clamp(hi - lo, min=1.0) / m)
    src = (i + 0.5) * inv - lo * inv - 0.5
    inside = ((i >= lo) & (i < hi)).float()
    keep = inside * ((src >= -0.5) & (src <= m - 0.5)).float()
    src = torch.clamp(src, 0.0, m - 1.0)
    i0 = torch.floor(src)
    frac = src - i0
    i0 = i0.long()
    i1 = torch.clamp(i0 + 1, max=m - 1)
    w = torch.zeros((*src.shape, m), dtype=torch.float32, device=lo.device)
    w.scatter_add_(2, i0[..., None], ((1.0 - frac) * keep)[..., None])
    w.scatter_add_(2, i1[..., None], (frac * keep)[..., None])
    return w, inside


def overlap_paste_probs(mask_probs: torch.Tensor, detections: torch.Tensor,
                        valid: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The device overlap-tile paste's averaged probabilities (port of the
    body of ``cfun_tpu/models/cfun.py::overlap_paste_labels``,
    LiTS_2017/utils.py:383-408): every valid detection's probability
    stack is resized trilinearly into its box of the molded volume, and
    each voxel's sum is divided by its hit count (+1e-6), then clipped to
    [0, 1].  Voxels outside every box are 0.

    mask_probs: [K, C, md, mh, mw] (any float dtype, pasted in f32);
    detections: [K, 8] molded voxel boxes; valid: [K] bool.  Returns
    [C, D, H, W] float32.

    Fixed shapes and no host sync: the boxes stay on the device, where
    each axis's interpolation is a [K, n, m] weight matrix, zero outside
    the box (``_paste_weights``).  The K slots are taken in turn, as the
    JAX ``fori_loop`` takes them, each resampled separably (x, then y, then
    z as a batched matrix product added into the one [C, D, H, W]
    accumulator), so the memory is one accumulator, not K volumes.
    Invalid slots add zero."""
    d, h, w = cfg.image_shape
    k, c, md, mh, mw = mask_probs.shape
    boxes = detections[:, :6].float()
    v = valid.float()
    wz, in_z = _paste_weights(boxes[:, 0], boxes[:, 3], md, d)
    wy, in_y = _paste_weights(boxes[:, 1], boxes[:, 4], mh, h)
    wx, in_x = _paste_weights(boxes[:, 2], boxes[:, 5], mw, w)
    wz = wz * v[:, None, None]
    acc = torch.zeros((c, d, h * w), dtype=torch.float32,
                      device=mask_probs.device)
    for i in range(k):
        p = mask_probs[i].float().reshape(c * md * mh, mw)
        x = torch.matmul(p, wx[i].t()).view(c, md, mh, w)
        y = torch.matmul(wy[i], x).view(c, md, h * w)
        acc.baddbmm_(wz[i].expand(c, d, md), y)
    # hits: the boxes' inside masks are separable, their sum over slots
    # one [D, K] x [K, H*W] product (small integers, exact in f32)
    cnt = torch.matmul((in_z * v[:, None]).t(),
                       (in_y[:, :, None] * in_x[:, None, :]).view(k, h * w))
    acc.div_(cnt.add_(1e-6))
    return acc.clamp_(0.0, 1.0).view(c, d, h, w)


def overlap_paste_labels(mask_probs: torch.Tensor, detections: torch.Tensor,
                         valid: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The overlap paste's labels: [D, H, W] int8, the argmax over C of
    :func:`overlap_paste_probs` (the first class on ties; 0 outside every
    box).  The host maps them back to the raw geometry."""
    return torch.argmax(overlap_paste_probs(mask_probs, detections, valid,
                                            cfg), dim=0).to(torch.int8)


class InferOut(NamedTuple):
    detections: torch.Tensor  # [Dmax, 8] voxel coords, f32
    det_valid: torch.Tensor   # [Dmax] bool
    # exact path: [Dmax, mD, mH, mW, C] float16 softmax; fast path: None
    mask_probs: Optional[torch.Tensor]
    # fast path: int8 argmax labels, either [Dmax, 2mD, 2mH, 2mW] (one
    # detection's crop, upsampled 2x on the device but at 'finetune') or,
    # where ``uses_overlap_paste`` (LiTS, more than one instance), the
    # [D, H, W] molded label volume of the overlap paste.  Exact: None
    mask_labels: Optional[torch.Tensor]


def infer_forward(params: nn.Params, image: torch.Tensor,
                  anchors: torch.Tensor, window: torch.Tensor, cfg: Config,
                  nms: NmsFn = sorted_nms) -> InferOut:
    """Single-volume inference graph.

    image: [1, 1, D, H, W] (int8 on the int8 wire); anchors: [A, 6];
    window: [6] voxel coords of the valid region.
    """
    dt = compute_dtype(cfg)
    if cfg.wire_image_dtype == "int8":
        image = image.to(dt) * (1.0 / cfg.wire_int8_scale)
    if cfg.device_normalize:
        # re-z-score on device in f32 (affine-invariant, so it equals the
        # z-score of the molded volume up to the int8 rounding)
        x = image.float()
        mean = torch.mean(x)
        var = torch.clamp(torch.mean(torch.square(x)) - torch.square(mean),
                          min=1e-12)
        image = ((x - mean) * torch.rsqrt(var)).to(dt)
    trunk = apply_trunk(params, image, cfg)
    proposals, valid = propose(trunk.rpn_logits[0], trunk.rpn_deltas[0],
                               anchors, cfg, cfg.post_nms_rois_inference,
                               nms=nms)

    pooled = pyramid_roi_align(proposals, trunk.p2[0], trunk.p3[0],
                               cfg.pool_size)
    logits, deltas = apply_classifier(params["classifier"], pooled, dtype=dt)
    probs = torch.softmax(logits, dim=-1)
    detections, kept = refine_detections(proposals, valid, probs, deltas,
                                         window, cfg, nms=nms)

    det_boxes_norm = normalize_boxes(detections[:, :6], cfg.image_shape)
    crops = roi_align(image[0].float(), det_boxes_norm,
                      tuple(cfg.mask_pool_size))
    mask_logits = apply_mask_head(params["mask"], crops, stage=cfg.stage,
                                  dtype=dt, fused=cfg.pallas_unet)
    mask_probs = torch.softmax(mask_logits, dim=1)
    if uses_overlap_paste(cfg):
        # the multi-instance overlap-tile paste, on the device, in molded
        # coordinates: one [D, H, W] label volume leaves it
        labels = overlap_paste_labels(mask_probs, detections, kept, cfg)
        return InferOut(detections, kept, None, labels)
    if cfg.fast_unmold:
        # 2x trilinear upsample (half-pixel, edge-clamped: the map of
        # jax.image.resize) + argmax on the device, so only int8 labels
        # leave it.  At finetune the mask is already 2x: no upsample.
        if cfg.stage != "finetune":
            mask_probs = F.interpolate(mask_probs, scale_factor=2,
                                       mode="trilinear", align_corners=False)
        labels = torch.argmax(mask_probs, dim=1).to(torch.int8)
        return InferOut(detections, kept, None, labels)
    return InferOut(detections, kept,
                    mask_probs.permute(0, 2, 3, 4, 1).to(torch.float16),
                    None)


def pack_fast_output(out: InferOut, bits: int = 4) -> torch.Tensor:
    """Pack the fast-path outputs into one int8 buffer, byte for byte the
    layout of the JAX ``pack_fast_output``: detections as f32 bytes, the
    validity mask, then the label volume at 4 bits (two labels a byte:
    first half low nibble, second half high) or 2 bits (four a byte)."""
    det = out.detections.float().contiguous().view(torch.int8).reshape(-1)
    val = out.det_valid.to(torch.int8)
    flat = out.mask_labels.reshape(-1)
    if bits == 2:
        q = flat.shape[0] // 4
        packed = (flat[:q] | (flat[q:2 * q] << 2) | (flat[2 * q:3 * q] << 4)
                  | (flat[3 * q:] << 6))
    else:
        half = flat.shape[0] // 2
        packed = flat[:half] | (flat[half:] << 4)
    return torch.cat([det, val, packed])


def unpack_fast_output(buf: np.ndarray, num_det: int, labels_shape,
                       bits: int = 4):
    """Host-side inverse of :func:`pack_fast_output` (NumPy): returns
    (detections [N, 8] f32, kept [N] bool, labels int8 of
    ``labels_shape``)."""
    det = buf[:num_det * 32].view(np.float32).reshape(num_det, 8)
    kept = buf[num_det * 32:num_det * 33] != 0
    rest = buf[num_det * 33:].view(np.uint8)
    if bits == 2:
        lab = np.empty(rest.size * 4, np.int8)
        n = rest.size
        lab[:n] = rest & 0x03
        lab[n:2 * n] = (rest >> 2) & 0x03
        lab[2 * n:3 * n] = (rest >> 4) & 0x03
        lab[3 * n:] = rest >> 6
    else:
        lab = np.empty(rest.size * 2, np.int8)
        lab[:rest.size] = rest & 0x0F
        lab[rest.size:] = rest >> 4
    return det, kept, lab.reshape(labels_shape)
