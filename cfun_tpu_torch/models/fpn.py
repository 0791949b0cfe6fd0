"""Two-level feature pyramid over the P3D backbone (port of
``cfun_tpu/models/fpn.py``).

P3 = 3^3 conv(1^3 conv(C3)); P2 = 3^3 conv(1^3 conv(C2) + nearest-up(P3 1^3)).
"""

from __future__ import annotations

from typing import Tuple

import torch

from cfun_tpu_torch import nn


def apply_fpn(params: nn.Params, c2: torch.Tensor, c3: torch.Tensor,
              dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    p3 = nn.conv3d(params["p3_conv1"], c3, dtype=dtype)
    p2 = nn.conv3d(params["p2_conv1"], c2, dtype=dtype) + \
        nn.upsample_nearest(p3)
    p3 = nn.conv3d(params["p3_conv2"], p3, dtype=dtype)
    p2 = nn.conv3d(params["p2_conv2"], p2, dtype=dtype)
    return p2, p3
