"""3D Region Proposal Network head (port of ``cfun_tpu/models/rpn.py``).

Shared 3^3 conv -> 1^3 class conv (2 per anchor) + 1^3 box conv (6 per
anchor).  Outputs are flattened z-major, slot ((z*H + y)*W + x)*A + a,
which is the order of ``ops/anchors.py``.  With a process group the input
is this rank's H shard: the shared conv is a halo conv along H
(``models/p3d.py::trunk_conv``), and the class and box maps are gathered
along H before the flatten, whose slot order needs the whole H.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cfun_tpu_torch import nn
from cfun_tpu_torch.models.p3d import trunk_conv
from cfun_tpu_torch.parallel.halo import gather_along


def _flatten(y: torch.Tensor, per_anchor: int) -> torch.Tensor:
    """[B, A*k, D, H, W] -> [B, D*H*W*A, k] in z-major slot order."""
    b = y.shape[0]
    return y.permute(0, 2, 3, 4, 1).reshape(b, -1, per_anchor)


def apply_rpn(params: nn.Params, feat: torch.Tensor, anchor_stride: int = 1,
              dtype=torch.float32,
              group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat: [B, C, D, H, W] -> (logits [B, N, 2], deltas [B, N, 6]) f32,
    for the whole H also when ``feat`` is an H shard (module docstring)."""
    conv = trunk_conv(dtype, group)
    if group is not None and anchor_stride != 1:
        raise ValueError("the RPN split along H takes anchor_stride 1, got "
                         f"{anchor_stride}")
    x = nn.relu(conv(params["shared"], feat, stride=anchor_stride))
    cls, bbox = conv(params["cls"], x), conv(params["bbox"], x)
    if group is not None:
        cls, bbox = gather_along(cls, group, 3), gather_along(bbox, group, 3)
    return _flatten(cls, 2).float(), _flatten(bbox, 6).float()
