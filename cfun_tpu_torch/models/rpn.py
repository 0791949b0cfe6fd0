"""3D Region Proposal Network head (port of ``cfun_tpu/models/rpn.py``).

Shared 3^3 conv -> 1^3 class conv (2 per anchor) + 1^3 box conv (6 per
anchor).  Outputs are flattened z-major, slot ((z*H + y)*W + x)*A + a,
which is the order of ``ops/anchors.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cfun_tpu_torch import nn


def _flatten(y: torch.Tensor, per_anchor: int) -> torch.Tensor:
    """[B, A*k, D, H, W] -> [B, D*H*W*A, k] in z-major slot order."""
    b = y.shape[0]
    return y.permute(0, 2, 3, 4, 1).reshape(b, -1, per_anchor)


def apply_rpn(params: nn.Params, feat: torch.Tensor, anchor_stride: int = 1,
              dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat: [B, C, D, H, W] -> (logits [B, N, 2], deltas [B, N, 6]) f32."""
    x = nn.relu(nn.conv3d(params["shared"], feat, stride=anchor_stride,
                          dtype=dtype))
    logits = _flatten(nn.conv3d(params["cls"], x, dtype=dtype), 2)
    deltas = _flatten(nn.conv3d(params["bbox"], x, dtype=dtype), 6)
    return logits.float(), deltas.float()
