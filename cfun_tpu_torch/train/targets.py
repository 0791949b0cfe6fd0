"""Target assignment (port of ``cfun_tpu/train/targets.py``): the RPN
anchor targets (host, NumPy: a copy of the JAX package's function, bit for
bit the same for the same ``np.random.Generator``) and the
detection-target layer (device, fixed capacity).

The detection-target layer samples ROIs with two uniform draws over the
proposals (``TargetDraws``), taken before the step's compute from a
``torch.Generator`` (``draw_targets``) or passed in: the JAX package
draws them from ``jax.random`` keys, whose stream PyTorch cannot
reproduce, so a comparison feeds both the same uniforms.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from cfun_tpu_torch.config import Config
from cfun_tpu_torch.ops.boxes import (box_refinement, device_constant,
                                      pairwise_iou)
from cfun_tpu_torch.ops.nms import top_desc
from cfun_tpu_torch.ops.sample3d import one_hot_crop


# ---------------------------------------------------------------------------
# RPN targets (host-side NumPy)
# ---------------------------------------------------------------------------

def build_rpn_targets(anchors: np.ndarray, gt_box: np.ndarray, cfg: Config,
                      rng: np.random.Generator):
    """Match anchors to the single organ GT box (reference
    model.py:1090-1181).

    anchors: [A, 6] voxel coords; gt_box: [6] voxel coords.
    Returns (rpn_match [A] int8 in {-1, 0, 1}, rpn_deltas [A, 6] float32
    normalized by RPN_BBOX_STD_DEV, dense per anchor: the reference packs
    the positives' rows, model.py:1146-1179).
    """
    a = anchors.astype(np.float64)
    g = gt_box.astype(np.float64)
    lo = np.maximum(a[:, :3], g[:3])
    hi = np.minimum(a[:, 3:], g[3:])
    inter = np.prod(np.maximum(hi - lo, 0.0), axis=1)
    vol_a = np.prod(a[:, 3:] - a[:, :3], axis=1)
    vol_g = np.prod(g[3:] - g[:3])
    iou = inter / (vol_a + vol_g - inter + 1e-6)

    match = np.zeros(anchors.shape[0], np.int8)
    match[iou < 0.3] = -1
    match[np.argmax(iou)] = 1  # never leave the GT box unmatched
    match[iou >= 0.7] = 1

    # subsample: positives <= half, then negatives to fill the quota
    # (model.py:1128-1143)
    quota = cfg.rpn_train_anchors_per_image
    pos_ids = np.flatnonzero(match == 1)
    extra = len(pos_ids) - quota // 2
    if extra > 0:
        match[rng.choice(pos_ids, extra, replace=False)] = 0
    neg_ids = np.flatnonzero(match == -1)
    extra = len(neg_ids) - (quota - int(np.sum(match == 1)))
    if extra > 0:
        match[rng.choice(neg_ids, extra, replace=False)] = 0

    # dense per-anchor deltas for the positive set
    size_a = a[:, 3:] - a[:, :3]
    center_a = a[:, :3] + 0.5 * size_a
    size_g = g[3:] - g[:3]
    center_g = g[:3] + 0.5 * size_g
    deltas = np.concatenate(
        [(center_g - center_a) / size_a,
         np.log(size_g / size_a) * np.ones_like(size_a)], axis=1)
    deltas /= np.asarray(cfg.rpn_bbox_std)
    deltas[match != 1] = 0.0
    return match, deltas.astype(np.float32)


# ---------------------------------------------------------------------------
# Detection targets (device)
# ---------------------------------------------------------------------------

class DetectionTargets(NamedTuple):
    rois: torch.Tensor        # [R, 6] normalized; positives first
    roi_valid: torch.Tensor   # [R] bool
    class_ids: torch.Tensor   # [R] int32 (1 = organ FG, 0 = BG/pad)
    deltas: torch.Tensor      # [R, 6] / bbox_std (positives only)
    pos_rois: torch.Tensor    # [P, 6] normalized positive subset
    pos_valid: torch.Tensor   # [P] bool
    # [P, C, mD, mH, mW] one-hot GT crops (channels first); None where
    # the caller asked for none (no mask branch)
    masks: Optional[torch.Tensor]


class TargetDraws(NamedTuple):
    """The ROI sampler's uniforms: one [N] vector over the proposals for
    the positives, one for the negatives (``k_pos`` / ``k_neg`` of the JAX
    package, ``targets.py:121``)."""
    u_pos: torch.Tensor
    u_neg: torch.Tensor


def draw_targets(n: int, generator: torch.Generator,
                 device) -> TargetDraws:
    """The sampler's two uniform [n] float32 vectors from ``generator``
    (drawn on the generator's device), on ``device``."""
    gdev = generator.device
    return TargetDraws(*(torch.rand(n, generator=generator,
                                    device=gdev).to(device)
                         for _ in range(2)))


def _masked_random_topk(uniform: torch.Tensor, candidate: torch.Tensor,
                        k: int):
    """Sample up to k True positions of ``candidate`` uniformly: the k
    largest of ``uniform`` among them (ties to the lower index, as
    ``lax.top_k``).  Returns (idx [k], ok [k]); k may exceed the
    candidate count, and the tail is then invalid."""
    keff = min(k, candidate.shape[0])
    score = torch.where(candidate, uniform,
                        torch.full_like(uniform, -1.0))
    top, idx = top_desc(score, keff)
    ok = top >= 0.0
    if keff < k:
        idx = torch.cat([idx, idx.new_zeros(k - keff)])
        ok = torch.cat([ok, ok.new_zeros(k - keff)])
    return idx, ok


def detection_targets(proposals: torch.Tensor, proposal_valid: torch.Tensor,
                      gt_box_norm: torch.Tensor, labels: torch.Tensor,
                      cfg: Config, draws: TargetDraws,
                      with_masks: bool = True) -> DetectionTargets:
    """Subsample proposals into training ROIs (reference model.py:414-563).

    proposals: [N, 6] normalized (zero-padded); gt_box_norm: [6]; labels:
    [D, H, W] int label volume for the GT mask crops; ``draws``: the
    sampler's uniforms over the N proposals.  ``with_masks=False`` skips
    the crops (a step without the mask branch never reads them).

    The reference matches against NUM_CLASSES-1 identical copies of the
    whole-organ box (model.py:1076) and gives every positive the first
    class, so the single box is used and positives are class 1.  The
    outputs carry no gradient.
    """
    p_cap = cfg.num_positive_rois
    r_cap = cfg.train_rois_per_image
    n_cap = r_cap - p_cap
    device = proposals.device

    iou = pairwise_iou(proposals, gt_box_norm[None, :])[:, 0]
    is_pos = proposal_valid & (iou >= cfg.detection_target_iou)
    is_neg = proposal_valid & (iou < cfg.detection_target_iou)

    pos_idx, pos_ok = _masked_random_topk(draws.u_pos, is_pos, p_cap)
    n_pos = torch.sum(pos_ok).to(torch.int32)

    # negative quota: int(pos / ratio - pos), zero when no positives
    # (model.py:501-513); the division in float32, truncated
    ratio = device_constant((cfg.roi_positive_ratio,), torch.float32,
                            device)[0]
    quota = torch.where(n_pos > 0,
                        (n_pos.float() / ratio).to(torch.int32) - n_pos,
                        torch.zeros_like(n_pos))
    neg_idx, neg_avail = _masked_random_topk(draws.u_neg, is_neg, n_cap)
    neg_ok = neg_avail & (torch.arange(n_cap, device=device) < quota)

    zero = torch.zeros((), dtype=proposals.dtype, device=device)
    pos_rois = torch.where(pos_ok[:, None], proposals[pos_idx], zero)
    neg_rois = torch.where(neg_ok[:, None], proposals[neg_idx], zero)
    rois = torch.cat([pos_rois, neg_rois], dim=0)
    roi_valid = torch.cat([pos_ok, neg_ok])
    class_ids = torch.cat([pos_ok.to(torch.int32),
                           torch.zeros(n_cap, dtype=torch.int32,
                                       device=device)])

    deltas = box_refinement(pos_rois, gt_box_norm[None, :].expand(p_cap, 6))
    deltas = deltas / device_constant(cfg.bbox_std, torch.float32, device)
    deltas = torch.where(pos_ok[:, None], deltas, zero)
    deltas = torch.cat([deltas, torch.zeros((n_cap, 6), dtype=torch.float32,
                                            device=device)])

    masks = None
    if with_masks:
        masks = one_hot_crop(labels, pos_rois, cfg.mask_shape,
                             cfg.num_classes)
        masks = torch.where(pos_ok[:, None, None, None, None], masks,
                            torch.zeros((), device=device))

    return DetectionTargets(rois=rois.detach(), roi_valid=roi_valid,
                            class_ids=class_ids, deltas=deltas.detach(),
                            pos_rois=pos_rois.detach(), pos_valid=pos_ok,
                            masks=None if masks is None else masks.detach())
