"""Halo-exchange convolutions for volumes split across the ranks of a
process group (port of ``cfun_tpu/parallel/halo.py``).

Each rank holds a shard of a channel-first volume ``[N, C, D, H, W]``
split along one spatial axis: D (axis 2) for the mask U-Net's crops, H
(axis 3) for the trunk's molded volume.  A 3D convolution needs ``k // 2``
planes of its neighbours' data at a shard's edges: :func:`exchange_halo`
brings them in (zeros at the outer edges, the zero padding a dense conv
sees) and :func:`halo_conv3d` then runs the conv unpadded along that
axis.  Instance norms sum their statistics over the group
(:func:`instance_norm_sharded`), so the sharded U-Net
(:func:`shard_map_unet`, ``models/unet3d.py::apply_unet(group=...)``)
computes the dense one.  The trunk split along H (:func:`shard_h`,
``models/p3d.py::trunk_conv``, ``models/cfun.py::apply_trunk(group=...)``)
is what GSPMD makes of the JAX package's H sharding of the molded volume
(``cfun_tpu/parallel/mesh.py::batch_sharding``); its outputs are gathered
whole (:func:`gather_along`).

Gradients.  The JAX package writes these inside ``jax.shard_map``, where
``lax.ppermute`` and ``lax.psum`` carry their own transposes.  Here each
collective is a ``torch.autograd.Function`` under one rule: every rank
backpropagates its share of one objective, and the shares of all ranks
sum to it.  Then the transpose of a halo exchange sends each halo's
cotangent back to the rank it came from, and the transpose of an
all-reduce that feeds per-rank compute is an all-reduce of the
cotangents.  A loss computed from all-reduced values is the same on every
rank of the group; the caller counts it ``1 / size`` on each
(``parallel/mesh.py``).

Both collectives are written with ``all_gather`` and ``all_reduce``,
which gloo and NCCL both take on CUDA tensors (gloo has no CUDA
``send`` / ``recv``): one code path serves CPU ranks, ranks sharing one
card under gloo, and one card per rank under NCCL.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cfun_tpu_torch import nn
from cfun_tpu_torch.train.losses import _edge_maps

# the four stride-2 context levels of the U-Net: a shard's planes must
# stay even at each (cfun_tpu/parallel/halo.py:94-102)
UNET_D_MULTIPLE = 16
# the trunk's four stride-2 steps along H (the stem, the max pool, C2's and
# C3's first blocks): likewise
TRUNK_H_MULTIPLE = 16


def _size(group) -> int:
    return dist.get_world_size(group)


def _gather(t: torch.Tensor, group) -> list:
    out = [torch.empty_like(t) for _ in range(_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``; the backward sums the cotangents likewise."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, differentiable: the
    result is the same on every rank, and its cotangents are summed back
    (the psum of the JAX package's shard_map bodies)."""
    if _size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def _edges(x: torch.Tensor, halo: int, dim: int) -> torch.Tensor:
    """The first and the last ``halo`` planes of ``x`` along ``dim``."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, halo), x.narrow(dim, n - halo, halo)],
                     dim=dim)


class _ExchangeHalo(torch.autograd.Function):
    """[.., L, ..] -> [.., L + 2 halo, ..]: the previous rank's last
    ``halo`` planes, the shard, the next rank's first ``halo`` planes."""

    @staticmethod
    def forward(ctx, x, group, halo, dim):
        ctx.group, ctx.halo, ctx.dim = group, halo, dim
        rank, n = dist.get_rank(group), _size(group)
        got = _gather(_edges(x, halo, dim), group)
        zero = torch.zeros_like(x.narrow(dim, 0, halo))
        lo = got[rank - 1].narrow(dim, halo, halo) if rank > 0 else zero
        hi = got[rank + 1].narrow(dim, 0, halo) if rank < n - 1 else zero
        return torch.cat([lo, x, hi], dim=dim)

    @staticmethod
    def backward(ctx, g):
        group, halo, dim = ctx.group, ctx.halo, ctx.dim
        rank, n = dist.get_rank(group), _size(group)
        length = g.shape[dim] - 2 * halo
        # each halo's cotangent goes back to the rank its planes came from
        got = _gather(_edges(g, halo, dim), group)
        dx = g.narrow(dim, halo, length).clone()
        if rank > 0:  # my first planes were the previous rank's upper halo
            dx.narrow(dim, 0, halo).add_(got[rank - 1].narrow(dim, halo,
                                                              halo))
        if rank < n - 1:  # my last planes were the next rank's lower halo
            dx.narrow(dim, length - halo, halo).add_(
                got[rank + 1].narrow(dim, 0, halo))
        return dx, None, None, None


def exchange_halo(x: torch.Tensor, group, halo: int,
                  dim: int = 2) -> torch.Tensor:
    """Concatenate ``halo`` planes from both neighbours in ``group`` along
    ``dim`` (2 = D of [N, C, D, H, W]): the shard's own planes, with the
    previous rank's last ``halo`` before and the next rank's first
    ``halo`` after; zeros at the outer edges.  Returns [.., L + 2 halo,
    ..].  Differentiable (module docstring)."""
    if halo == 0 or _size(group) == 1:
        pad = [0, 0] * (x.dim() - 1 - dim) + [halo, halo]
        return F.pad(x, pad)
    if x.shape[dim] < halo:
        raise ValueError(f"exchange_halo: a shard of {x.shape[dim]} planes "
                         f"cannot give a halo of {halo}")
    return _ExchangeHalo.apply(x, group, halo, dim)


def instance_norm_sharded(x: torch.Tensor, group,
                          eps: float = 1e-5) -> torch.Tensor:
    """Instance norm of a [N, C, L, H, W] shard whose volume is split along
    D over ``group``: the statistics are summed over the group, so the
    result equals ``nn.instance_norm`` of the whole volume.  Two passes
    (the mean, then the squared deviations) in float32, the normalization
    applied in ``x``'s dtype, as ``nn.instance_norm``."""
    dims = (2, 3, 4)
    count = x.shape[2] * x.shape[3] * x.shape[4] * _size(group)
    s = torch.sum(x, dim=dims, keepdim=True, dtype=torch.float32)
    mean = all_reduce_sum(s, group) / count
    diff = x - mean.to(x.dtype)
    ss = torch.sum(torch.square(diff), dim=dims, keepdim=True,
                   dtype=torch.float32)
    var = all_reduce_sum(ss, group) / count
    return diff * torch.rsqrt(var + eps).to(x.dtype)


def halo_conv3d(params: nn.Params, x: torch.Tensor, group, stride: int = 1,
                dtype=torch.float32, dim: int = 2) -> torch.Tensor:
    """3D conv over a [N, C, D, H, W] shard split along ``dim`` (2 = D,
    3 = H) over ``group``: equal to the shard of ``nn.conv3d(params, whole
    volume, stride)`` for odd kernels and a local length along ``dim``
    divisible by the stride.  The other two axes are padded as
    ``nn.conv3d`` pads them."""
    w = params["w"]
    pads = [(k - 1) // 2 for k in w.shape[2:]]
    x = exchange_halo(x.to(dtype), group, pads[dim - 2], dim=dim)
    pads[dim - 2] = 0
    b = params.get("b")
    return F.conv3d(x, w.to(dtype), None if b is None else b.to(dtype),
                    stride=stride, padding=tuple(pads))


class _GatherAlong(torch.autograd.Function):
    """[.., L, ..] -> [.., size * L, ..]: every rank's shard in rank order.
    The backward sums every rank's cotangent (each rank's share of one
    objective) and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.length = group, dim, x.shape[dim]
        return torch.cat(_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        start = dist.get_rank(ctx.group) * ctx.length
        return g.narrow(ctx.dim, start, ctx.length), None, None


def gather_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The shards ``x`` of every rank of ``group`` concatenated along
    ``dim`` in rank order (the inverse of :func:`shard_of`): the whole
    tensor, the same on every rank.  Differentiable: the cotangents of
    all ranks are summed (an all-reduce, as the collectives here take
    only ``all_gather`` and ``all_reduce``) and each rank keeps its own
    slice's."""
    if _size(group) == 1:
        return x
    return _GatherAlong.apply(x, group, dim)


def shard_h(image: torch.Tensor, group) -> torch.Tensor:
    """This rank's H shard of the whole [N, C, D, H, W] ``image`` for the
    trunk split over ``group``.  Raises ValueError unless the local H is a
    multiple of TRUNK_H_MULTIPLE, which keeps every stride-2 step of the
    trunk shard-aligned (an even length at each)."""
    n, h = _size(group), image.shape[3]
    if h % n or (h // n) % TRUNK_H_MULTIPLE:
        raise ValueError(
            f"the trunk's H split: H={h} over {n} 'space' shards gives "
            f"local H={h / n:g}; need local H % {TRUNK_H_MULTIPLE} == 0 so "
            "the stem, the max pool, C2 and C3 (each of stride 2) stay "
            "shard-aligned")
    return shard_of(image, group, dim=3)


def shard_of(x: torch.Tensor, group, dim: int = 2) -> torch.Tensor:
    """This rank's equal slice of ``x`` along ``dim`` over ``group``."""
    n, rank = _size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"axis {dim} of length {x.shape[dim]} does not "
                         f"split over {n} ranks")
    local = x.shape[dim] // n
    return x.narrow(dim, rank * local, local)


def shard_map_unet(mesh, params: nn.Params, crops: torch.Tensor, *,
                   stage: str, dropout_rate: float = 0.0,
                   dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                   dtype=torch.float32) -> torch.Tensor:
    """The mask U-Net with its crops' D split over the mesh's space ranks.

    ``crops``: the whole [P, 1, D, H, W] crops, the same on every space
    rank of the row; each rank takes its D shard and runs ``apply_unet``
    with the space group (halo convs, summed instance-norm statistics).
    The dropout keep masks are per channel, so the same masks serve every
    shard.  Returns this rank's shard of the logits, [P, classes, D' /
    space, H', W'] (D' = 2 D at 'finetune')."""
    from cfun_tpu_torch.models.unet3d import apply_unet

    n_shards = mesh.space
    d = crops.shape[2]
    local_d = d // n_shards
    if d % n_shards or local_d % UNET_D_MULTIPLE:
        raise ValueError(
            f"shard_map_unet: D={d} over {n_shards} 'space' shards gives "
            f"local D={local_d}; need local D % 16 == 0 so all four "
            "stride-2 context levels stay shard-aligned")
    return apply_unet(params, shard_of(crops, mesh.space_group), stage=stage,
                      dropout_rate=dropout_rate, dropout_masks=dropout_masks,
                      dtype=dtype, group=mesh.space_group)


def _roi_edge_se_sharded(t: torch.Tensor, logits: torch.Tensor, group,
                         dmask: torch.Tensor, nvox: float,
                         per_class: bool) -> torch.Tensor:
    """One ROI's share of the edge error on this shard: t [C, L, h, w]
    one-hot, logits [C, L, h, w]; the phantom centres (``dmask`` 0) are
    left out."""
    q = torch.softmax(logits.float(), dim=0)
    # [C - 1, L + 2, h, w] with the halos -> [C - 1, 3, L, h - 2, w - 2]
    g_true = _edge_maps(exchange_halo(t[1:], group, 1, dim=1))
    g_pred = _edge_maps(exchange_halo(q[1:], group, 1, dim=1))
    dm = dmask[None, None, :, None, None]
    if per_class:
        return torch.sum((g_pred - g_true) ** 2 * dm) / (nvox * 3.0)
    eps = 1e-12
    m_true = torch.sqrt(torch.sum(g_true ** 2, dim=1) + eps)
    m_pred = torch.sqrt(torch.sum(g_pred ** 2, dim=1) + eps)
    return torch.sum((m_pred - m_true) ** 2 * dm[:, 0]) / nvox


def sharded_mask_losses(mesh, masks: torch.Tensor, pos_valid: torch.Tensor,
                        mask_logits: torch.Tensor, cfg, *,
                        edge_on: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask CE and Sobel-edge losses with the crops' D split over the
    mesh's space ranks (the companion of :func:`shard_map_unet`,
    ``cfg.shard_unet_spatial``).

    ``masks``: the whole one-hot targets [P, C, mD, mH, mW], the same on
    every space rank (each takes its D shard); ``mask_logits``: this
    rank's shard from :func:`shard_map_unet`.  The per-voxel work stays
    local; the CE's numerator and denominator and each ROI's edge error
    are summed over the space group.  Returns (mask_loss, edge_loss), the
    same on every space rank and equal to ``losses.mask_loss`` /
    ``losses.mask_edge_loss`` of the whole crops (edge_loss 0 without
    ``edge_on``); differentiable under the module's rule."""
    group = mesh.space_group
    p, md = masks.shape[0], masks.shape[2]
    if md % mesh.space:
        raise ValueError(f"sharded_mask_losses: D={md} not divisible by "
                         f"{mesh.space} 'space' shards")
    t = shard_of(masks, group)
    local_d = t.shape[2]
    ql = mask_logits.float()
    ce = torch.logsumexp(ql, dim=1) - torch.sum(ql * t, dim=1)
    valid = pos_valid[:, None, None, None].to(ce.dtype)
    if cfg.mask_class_weights is not None:
        wvec = torch.tensor(cfg.mask_class_weights, dtype=ce.dtype,
                            device=ce.device)
        w = torch.sum(t * wvec[None, :, None, None, None], dim=1) * valid
    else:
        w = valid.expand(ce.shape)
    num = all_reduce_sum(torch.sum(ce * w), group)
    den = all_reduce_sum(torch.sum(w).detach(), group)
    mask_l = num / torch.clamp(den, min=1.0)
    if not edge_on:
        return mask_l, torch.zeros((), dtype=torch.float32, device=ce.device)

    # the dense edge maps are a VALID conv: global centres 1 .. D - 2.
    # Each shard computes its local_d centres from 1-plane halos; the two
    # phantom centres (global 0 and D - 1, fed zero halos) are masked out
    start = dist.get_rank(group) * local_d
    gidx = torch.arange(start, start + local_d, device=ce.device)
    dmask = ((gidx >= 1) & (gidx <= md - 2)).to(torch.float32)
    nvox = float((md - 2) * (t.shape[3] - 2) * (t.shape[4] - 2))
    per_class = cfg.name == "lits"
    se = torch.stack([
        checkpoint(_roi_edge_se_sharded, t[i], mask_logits[i], group, dmask,
                   nvox, per_class, use_reentrant=False)
        for i in range(p)])
    se = all_reduce_sum(se, group)
    pos = pos_valid.to(se.dtype)
    edge_l = torch.sum(se * pos) / torch.clamp(torch.sum(pos), min=1.0)
    return mask_l, edge_l
