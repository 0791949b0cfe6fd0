"""Pseudo-3D ResNet backbone, two stages (port of ``cfun_tpu/models/p3d.py``).

Stem: conv (3,7,7)/s2 + BN + ReLU + maxpool/s2 (1/4 resolution); then two
bottleneck stacks C2 (1/8) and C3 (1/16).  Each bottleneck splits the 3^3
conv into a spatial (1,3,3) and a temporal (3,1,1) conv, in one of three
patterns cycled by block index: ST-A serial, ST-B parallel, ST-C serial
with skip.  The first block of a stack widens x4 with a stride-2 1^3
downsample on the residual path.  BatchNorm is frozen.

With a process group (``group=``) the input is this rank's H shard of the
molded volume and every conv whose kernel spans H is a halo conv along H
(:func:`trunk_conv`); the pool, the frozen BN and the ReLUs are local, so
each output is this rank's H shard of the dense one.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from cfun_tpu_torch import nn

BACKBONE_DEPTHS = {"P3D19": (2, 3), "P3D35": (4, 5)}
EXPANSION = 4


def trunk_conv(dtype, group=None):
    """The trunk's ``conv(params, x, stride=1)``: ``nn.conv3d`` in
    ``dtype``, or with a process group the conv over this rank's shard
    split along H: a conv whose kernel spans H is a halo conv along H
    (``parallel/halo.py::halo_conv3d``), one with a kernel of 1 along H
    (the 1^3 convs, strided too, and the (3, 1, 1) ones) reads no
    neighbour and runs as ``nn.conv3d``."""
    if group is None:
        return functools.partial(nn.conv3d, dtype=dtype)
    from cfun_tpu_torch.parallel.halo import halo_conv3d

    def conv(p, x, stride=1):
        if p["w"].shape[3] == 1:
            return nn.conv3d(p, x, stride=stride, dtype=dtype)
        return halo_conv3d(p, x, group, stride=stride, dtype=dtype, dim=3)

    return conv


def _apply_bottleneck(p: nn.Params, x: torch.Tensor, *, st: str,
                      expand: bool, stride: int, dtype,
                      group=None) -> torch.Tensor:
    conv = trunk_conv(dtype, group)
    out = nn.relu(nn.frozen_bn(p["bn1"], conv(p["conv1"], x, stride=stride)))

    def s_branch(v):
        return nn.relu(nn.frozen_bn(p["bn_s"], conv(p["conv_s"], v)))

    def t_branch(v):
        return nn.relu(nn.frozen_bn(p["bn_t"], conv(p["conv_t"], v)))

    if st == "A":
        out = t_branch(s_branch(out))
    elif st == "B":
        out = t_branch(out) + s_branch(out)
    else:  # "C"
        s = s_branch(out)
        out = s + t_branch(s)

    out = nn.frozen_bn(p["bn4"], conv(p["conv4"], out))
    if expand:
        residual = nn.frozen_bn(p["down_bn"],
                                conv(p["down_conv"], x, stride=2))
    else:
        residual = x
    return nn.relu(out + residual)


def apply_p3d(params: nn.Params, x: torch.Tensor, dtype=torch.float32,
              remat: bool = False,
              group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, C, D, H, W] molded volume -> (c2 at 1/8, c3 at 1/16).

    ``remat=True`` checkpoints each bottleneck block
    (``torch.utils.checkpoint``): the backward pass recomputes one block's
    activations at a time instead of holding the whole stack's (a split
    block's halo exchanges run again in the recomputation, in the same
    order on every rank).  ``group``: ``x`` is this rank's H shard (module
    docstring)."""
    out = trunk_conv(dtype, group)(params["stem_conv"], x, stride=2)
    out = nn.relu(nn.frozen_bn(params["stem_bn"], out))
    out = nn.max_pool(out, 2, 2)

    feats = []
    for stage in (2, 3):
        for b, bp in enumerate(params[f"c{stage}"]):
            block = functools.partial(_apply_bottleneck, st="ABC"[b % 3],
                                      expand=(b == 0),
                                      stride=2 if b == 0 else 1, dtype=dtype,
                                      group=group)
            if remat:
                out = checkpoint(block, bp, out, use_reentrant=False)
            else:
                out = block(bp, out)
        feats.append(out)
    return feats[0], feats[1]
