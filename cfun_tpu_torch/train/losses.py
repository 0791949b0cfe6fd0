"""The six CFUN losses as masked, fixed-shape functions on tensors (port of
``cfun_tpu/train/losses.py``), channel-first.

Reference semantics (model.py:804-1000):
  rpn_class   CE over non-neutral anchors
  rpn_bbox    smooth-L1 over positive anchors
  mrcnn_class CE over ROIs with targets binarized to FG/BG (model.py:989)
  mrcnn_bbox  smooth-L1 on positive ROIs, class-specific (binary head)
  mask        voxelwise CE of the one-hot target against per-class logits
  mask_edge   3D Sobel gradient MSE over positive ROIs x FG classes
              (finetune stage only, model.py:995-998)

As in the JAX package, the heart edge loss uses the gx/gy/gz magnitude
(the reference repeats gx, model.py:969-972), and the LiTS form
(``per_class=True``) the per-class MSE of the raw components.  Every
masked mean divides by max(count, 1), so an empty selection gives 0, the
reference's zero-loss fallbacks (model.py:871-877).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cfun_tpu_torch.config import Config


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * ax * ax, ax - 0.5)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(values.dtype)
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _ce_from_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Per-row cross entropy, integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def rpn_class_loss(rpn_match: torch.Tensor, logits: torch.Tensor
                   ) -> torch.Tensor:
    """rpn_match: [A] in {-1, 0, 1}; logits: [A, 2]."""
    labels = (rpn_match == 1).long()
    return _masked_mean(_ce_from_logits(logits, labels), rpn_match != 0)


def rpn_bbox_loss(rpn_match: torch.Tensor, target_deltas: torch.Tensor,
                  pred_deltas: torch.Tensor) -> torch.Tensor:
    """Dense per-anchor targets [A, 6]; mean over the positive anchors'
    delta elements."""
    per = _smooth_l1(pred_deltas - target_deltas)
    mask = (rpn_match == 1)[:, None].expand(-1, 6)
    return _masked_mean(per, mask)


def mrcnn_class_loss(class_ids: torch.Tensor, roi_valid: torch.Tensor,
                     logits: torch.Tensor) -> torch.Tensor:
    """class_ids: [R] (FG > 0); logits: [R, 2].  Binarized targets."""
    labels = (class_ids > 0).long()
    return _masked_mean(_ce_from_logits(logits, labels), roi_valid)


def mrcnn_bbox_loss(target_deltas: torch.Tensor, class_ids: torch.Tensor,
                    roi_valid: torch.Tensor, pred: torch.Tensor
                    ) -> torch.Tensor:
    """pred: [R, 2, 6]; positives use the FG row (binary head)."""
    per = _smooth_l1(pred[:, 1, :] - target_deltas)
    mask = (roi_valid & (class_ids > 0))[:, None].expand(-1, 6)
    return _masked_mean(per, mask)


def mask_loss(target_onehot: torch.Tensor, pos_valid: torch.Tensor,
              logits: torch.Tensor, cfg: Config) -> torch.Tensor:
    """target_onehot, logits: [P, C, mD, mH, mW].

    Voxelwise CE against the one-hot target (model.py:909-935); LiTS
    weighs the classes (1, 1, 100) with torch's weighted-mean semantics,
    ``sum(w * ce) / sum(w)`` (LiTS_2017/model.py:926-927).  Written as
    logsumexp minus the one-hot dot, as the JAX package writes it."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=1)
    picked = torch.sum(logits * target_onehot, dim=1)
    ce = lse - picked  # [P, mD, mH, mW]
    valid = pos_valid[:, None, None, None].to(ce.dtype)
    if cfg.mask_class_weights is not None:
        wvec = torch.tensor(cfg.mask_class_weights, dtype=ce.dtype,
                            device=ce.device)
        w = torch.sum(target_onehot * wvec[None, :, None, None, None],
                      dim=1) * valid
    else:
        w = valid.expand(ce.shape)
    return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0)


def _sobel_kernels() -> np.ndarray:
    """[3, 1, 3, 3, 3] conv weight: three orthogonal 3D Sobel derivatives,
    the reference stencils (model.py:947-952) and the JAX package's
    (``losses.py::_sobel_kernels``) in the port's OIDHW layout."""
    kx = np.array([[[1, 2, 1], [0, 0, 0], [-1, -2, -1]],
                   [[2, 4, 2], [0, 0, 0], [-2, -4, -2]],
                   [[1, 2, 1], [0, 0, 0], [-1, -2, -1]]], np.float32)
    ky = kx.transpose(1, 0, 2)
    kz = kx.transpose(0, 2, 1)
    return np.stack([kx, ky, kz])[:, None]


_SOBEL = _sobel_kernels()


def _edge_maps(x: torch.Tensor) -> torch.Tensor:
    """x: [N, D, H, W] -> gradient components [N, 3, D-2, H-2, W-2] (VALID
    conv, as the reference's unpadded F.conv3d, model.py:967-968)."""
    w = torch.from_numpy(_SOBEL).to(x.device)
    return F.conv3d(x[:, None].float(), w)


def _roi_edge_se(t: torch.Tensor, q: torch.Tensor,
                 per_class: bool) -> torch.Tensor:
    """One ROI's edge error over its FG classes: t, q [C, m...] (target
    one-hot, probabilities); the classes ride the conv's batch dim."""
    g_true = _edge_maps(t[1:])
    g_pred = _edge_maps(q[1:])
    if per_class:
        return torch.sum(torch.mean((g_pred - g_true) ** 2,
                                    dim=(1, 2, 3, 4)))
    eps = 1e-12  # keeps sqrt' finite on flat regions
    m_true = torch.sqrt(torch.sum(g_true ** 2, dim=1) + eps)
    m_pred = torch.sqrt(torch.sum(g_pred ** 2, dim=1) + eps)
    # sum over classes, mean over voxels (model.py:963-975)
    return torch.sum(torch.mean((m_pred - m_true) ** 2, dim=(1, 2, 3)))


def mask_edge_loss(target_onehot: torch.Tensor, pos_valid: torch.Tensor,
                   mask_probs: torch.Tensor, cfg: Config,
                   per_class: bool = False) -> torch.Tensor:
    """Edge-agreement loss over the FG classes of positive ROIs.

    target_onehot / mask_probs: [P, C, m...].  Heart form: MSE between
    gradient magnitudes, summed over the FG classes, averaged over ROIs
    (model.py:938-981).  LiTS form (``per_class=True``): MSE between the
    raw gradient components per class (LiTS_2017/model.py:961-974).

    One ROI at a time, each checkpointed, as the JAX package's ``lax.map``
    of a ``jax.checkpoint`` body: the backward pass recomputes one ROI's
    gradient maps instead of holding every ROI's."""
    se = torch.stack([
        checkpoint(_roi_edge_se, target_onehot[i], mask_probs[i], per_class,
                   use_reentrant=False)
        for i in range(target_onehot.shape[0])])
    pos = pos_valid.to(se.dtype)
    return torch.sum(se * pos) / torch.clamp(torch.sum(pos), min=1.0)


def weighted_total(losses: Dict[str, torch.Tensor],
                   cfg: Config) -> torch.Tensor:
    w = cfg.loss_weight_dict
    return sum(w[k] * v for k, v in losses.items())
