"""Evaluation metrics: per-class mask IoU / Dice over label volumes (the
port's copy of ``cfun_tpu/utils/metrics.py``).

Reference computes IoU from stacked binary masks (utils.py:580-596); working
on integer label volumes directly is equivalent and avoids materializing
[H, W, D, C] float stacks.
"""

from __future__ import annotations

import numpy as np


def per_class_mask_iou(gt_labels: np.ndarray, pred_labels: np.ndarray,
                       num_classes: int) -> np.ndarray:
    """IoU per foreground class (1..num_classes-1).  eps guard matches the
    reference (utils.py:594)."""
    ious = np.zeros(num_classes - 1, np.float64)
    for c in range(1, num_classes):
        gt = gt_labels == c
        pr = pred_labels == c
        inter = np.logical_and(gt, pr).sum(dtype=np.float64)
        union = gt.sum(dtype=np.float64) + pr.sum(dtype=np.float64) - inter
        ious[c - 1] = inter / (union + 1e-6)
    return ious


def per_class_dice(gt_labels: np.ndarray, pred_labels: np.ndarray,
                   num_classes: int) -> np.ndarray:
    """Dice per foreground class (the paper's headline metric)."""
    dice = np.zeros(num_classes - 1, np.float64)
    for c in range(1, num_classes):
        gt = gt_labels == c
        pr = pred_labels == c
        inter = np.logical_and(gt, pr).sum(dtype=np.float64)
        denom = gt.sum(dtype=np.float64) + pr.sum(dtype=np.float64)
        dice[c - 1] = 2.0 * inter / (denom + 1e-6)
    return dice


def whole_mask_iou(gt_labels: np.ndarray, pred_labels: np.ndarray) -> float:
    """Single-class IoU treating all foreground as one (utils.py:599-617)."""
    gt = gt_labels > 0
    pr = pred_labels > 0
    inter = np.logical_and(gt, pr).sum(dtype=np.float64)
    union = gt.sum(dtype=np.float64) + pr.sum(dtype=np.float64) - inter
    return float(inter / (union + 1e-6))
