"""Two-level feature pyramid over the P3D backbone (port of
``cfun_tpu/models/fpn.py``).

P3 = 3^3 conv(1^3 conv(C3)); P2 = 3^3 conv(1^3 conv(C2) + nearest-up(P3 1^3)).
With a process group the inputs are this rank's H shards, the 3^3 convs
halo convs along H (``models/p3d.py::trunk_conv``); the upsample is local.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cfun_tpu_torch import nn
from cfun_tpu_torch.models.p3d import trunk_conv


def apply_fpn(params: nn.Params, c2: torch.Tensor, c3: torch.Tensor,
              dtype=torch.float32,
              group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    conv = trunk_conv(dtype, group)
    p3 = conv(params["p3_conv1"], c3)
    p2 = conv(params["p2_conv1"], c2) + nn.upsample_nearest(p3)
    p3 = conv(params["p3_conv2"], p3)
    p2 = conv(params["p2_conv2"], p2)
    return p2, p3
