"""The training example as ``data/feeder.py`` builds it and
``train/step.py`` / ``ops/augment.py`` take it, and the labels' 4-bit wire
(``cfun_tpu/train/step.py::TrainBatch``, ``ops/augment.py::AugTrainBatch``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TrainBatch(NamedTuple):
    """One molded training example (batch dim 1 on the image)."""
    # [1, 1, D, H, W]: the z-scored volume in the compute dtype, or int8
    # (the train wire, ``Config.train_wire_int8``)
    image: torch.Tensor
    rpn_match: torch.Tensor    # [A] int8 in {-1, 0, 1}
    rpn_deltas: torch.Tensor   # [A, 6] float32 (dense per-anchor targets)
    gt_box_norm: torch.Tensor  # [6] normalized whole-organ box
    # [D, H, W] int class labels, or [D, H, W/2] uint8 with two 4-bit
    # labels per byte along W (pack_labels_w)
    labels: torch.Tensor

    def to(self, device) -> "TrainBatch":
        return TrainBatch(*(t.to(device) for t in self))


class AugTrainBatch(NamedTuple):
    """An unrotated molded example; the step augments it on the device."""
    image: torch.Tensor  # [1, 1, D, H, W] wire type (bf16 / f32 / int8)
    labels: torch.Tensor  # [D, H, W] int8 or [D, H, W/2] 4-bit packed
    angle: float  # degrees (one an epoch), a float32 value
    fill: float  # the wire value of a raw 0 voxel, a float32 value


def pack_labels_w(labels: np.ndarray) -> np.ndarray:
    """Host-side: [.., W] int labels (< 16) -> [.., W/2] uint8, low nibble
    = left half of W, high nibble = right half."""
    half = labels.shape[-1] // 2
    l8 = labels.astype(np.uint8)
    return l8[..., :half] | (l8[..., half:] << 4)


def unpack_labels_w(packed: torch.Tensor) -> torch.Tensor:
    """Device-side inverse of :func:`pack_labels_w` -> int32 [.., W]."""
    u = packed.to(torch.uint8)
    return torch.cat([u & 0xF, u >> 4], dim=-1).to(torch.int32)
