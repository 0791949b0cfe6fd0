"""Modified 3D U-Net mask branch (port of ``cfun_tpu/models/unet3d.py``:
``apply_unet`` and ``apply_unet_fused``).

A 5-level context pathway (stride-2 3^3 convs, residual blocks,
InstanceNorm + LeakyReLU) and a 4-level localization pathway (nearest
upsample + conv) with skip concatenations and deep supervision (ds2/ds3
1^3 convs upsampled and summed into the output).  Training adds channel
dropout at five sites (after the first level's second conv and between
each deeper level's two convs); its keep masks come in as arguments
(``dropout_mask_shapes``), drawn before the graph runs.  Kept quirks of
the reference graph: ``c{N}_conv`` is applied
twice with the same weights inside each context level, ``context_1`` taps
the pre-norm activation, and every conv is bias-free.  At stage
'finetune' an extra 2x upscale head (``out_upscale``, a 5^3 conv with a
residual) doubles the output resolution.

The decoder up-convs and the finetune head each have two forms that
compute the same map: 'explicit' (nearest upsample, then the conv) and
'phase' (one conv with 8x the output channels, then depth-to-space;
``nn.upsample2_conv`` / ``nn.upsample2_conv_residual``).  Inference takes
the phase forms (``heads.apply_mask_head``), the up-convs only where
their input has at least ``PHASE_MIN_VOXELS`` voxels: below that the 8x
wider conv is mostly padding.

With a process group (``apply_unet(group=...)``) the input is one rank's
shard of the crops split along D, and the same graph runs with halo
convs and instance norms whose statistics are summed over the group
(``parallel/halo.py``): the shard of the dense graph's output.  That
graph takes the explicit up-convs and head, and the 1-channel entry conv
as a halo conv (the JAX package's ``axis_name`` branch,
``cfun_tpu/models/unet3d.py:213-277``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from cfun_tpu_torch import nn
from cfun_tpu_torch.ops.fused_conv import (fused_conv3d, identity_affine,
                                           in_affine_from_sums)


PHASE_MIN_VOXELS = 2048  # cfun_tpu/models/unet3d.py:258-272
_IMPLS = ("explicit", "phase")


def _check_impl(name: str, impl: str) -> None:
    if impl not in _IMPLS:
        raise ValueError(f"{name} must be one of {_IMPLS}, got {impl!r}")


def dropout_mask_shapes(batch: int, base: int) -> List[Tuple[int, ...]]:
    """The shapes [B, C, 1, 1, 1] of the five dropout sites' keep masks of
    :func:`apply_unet` at U-Net base width ``base``, in the order the
    graph applies them."""
    return [(batch, c, 1, 1, 1)
            for c in (base, 2 * base, 4 * base, 8 * base, 16 * base)]


def apply_unet(params: nn.Params, x: torch.Tensor, *, stage: str,
               dropout_rate: float = 0.0,
               dropout_masks: Optional[Sequence[torch.Tensor]] = None,
               dtype=torch.float32, head_impl: str = "explicit",
               up_impl: str = "explicit", group=None) -> torch.Tensor:
    """x: [B, c_in, D, H, W] crop -> class logits [B, n_classes, D', H',
    W'] in ``dtype``, where D' = D (2D at stage 'finetune').

    ``dropout_masks``: the five sites' bool keep masks
    (:func:`dropout_mask_shapes`); with ``dropout_rate`` > 0 they apply
    (``nn.channel_dropout``), without them the graph is deterministic.
    ``up_impl``: the decoder up-convs' form, 'phase' where the input has
    at least ``PHASE_MIN_VOXELS`` voxels, else 'explicit'.  ``head_impl``:
    the finetune head's form.  ``group``: ``x`` is this rank's D shard
    of crops split over the ranks of that process group (module
    docstring); the keep masks, per channel, are the same on every
    shard, and both forms are 'explicit'."""
    _check_impl("head_impl", head_impl)
    _check_impl("up_impl", up_impl)
    masks = iter(()) if dropout_masks is None or dropout_rate == 0.0 \
        else iter(dropout_masks)

    def drop(v):
        keep = next(masks, None)
        return v if keep is None else nn.channel_dropout(v, dropout_rate,
                                                         keep)

    if group is None:
        def conv(p, v, stride=1):
            return nn.conv3d(p, v, stride=stride, dtype=dtype)

        inorm = nn.instance_norm
    else:
        from cfun_tpu_torch.parallel.halo import (halo_conv3d,
                                                  instance_norm_sharded)

        def conv(p, v, stride=1):
            return halo_conv3d(p, v, group, stride=stride, dtype=dtype)

        def inorm(v):
            return instance_norm_sharded(v, group)

        head_impl = up_impl = "explicit"
    lrelu = nn.leaky_relu

    def norm_lrelu_conv(p, v):
        return conv(p, lrelu(inorm(v)))

    def conv_norm_lrelu(p, v):
        return lrelu(inorm(conv(p, v)))

    def norm_lrelu_upscale_conv_norm_lrelu(p, v):
        nsp = v.shape[2] * v.shape[3] * v.shape[4]
        v = lrelu(inorm(v))
        if up_impl == "phase" and nsp >= PHASE_MIN_VOXELS:
            return lrelu(inorm(nn.upsample2_conv(p, v, dtype=dtype)))
        return lrelu(inorm(conv(p, nn.upsample_nearest(v.to(dtype)))))

    # ---- level 1 context
    if group is None:
        out = nn.conv3d_1ch(params["c1_1"], x, dtype=dtype)
    else:
        out = conv(params["c1_1"], x)
    residual = out
    out = drop(conv(params["c1_2"], lrelu(out)))
    out = conv(params["c1_lrelu_conv"], lrelu(out))
    out = out + residual
    context_1 = lrelu(out)  # pre-norm tap (mask_branch.py:134)
    out = lrelu(inorm(out))

    # ---- levels 2-5 context (shared-weight double conv per level)
    contexts = []
    for lvl in (2, 3, 4, 5):
        out = conv(params[f"c{lvl}_down"], out, stride=2)
        residual = out
        out = drop(norm_lrelu_conv(params[f"c{lvl}_conv"], out))
        out = norm_lrelu_conv(params[f"c{lvl}_conv"], out)
        out = out + residual
        if lvl < 5:
            out = lrelu(inorm(out))
            contexts.append(out)
    context_2, context_3, context_4 = contexts

    # ---- level 0 localization
    out = norm_lrelu_upscale_conv_norm_lrelu(params["l0_up_conv"], out)
    out = conv(params["l0_conv"], out)
    out = lrelu(inorm(out))

    # ---- decoder
    out = torch.cat([out, context_4], dim=1)
    out = conv_norm_lrelu(params["l1_conv"], out)
    out = conv(params["l1_reduce"], out)
    out = norm_lrelu_upscale_conv_norm_lrelu(params["l1_up_conv"], out)

    out = torch.cat([out, context_3], dim=1)
    out = conv_norm_lrelu(params["l2_conv"], out)
    ds2 = out
    out = conv(params["l2_reduce"], out)
    out = norm_lrelu_upscale_conv_norm_lrelu(params["l2_up_conv"], out)

    out = torch.cat([out, context_2], dim=1)
    out = conv_norm_lrelu(params["l3_conv"], out)
    ds3 = out
    out = conv(params["l3_reduce"], out)
    out = norm_lrelu_upscale_conv_norm_lrelu(params["l3_up_conv"], out)

    out = torch.cat([out, context_1], dim=1)
    out = conv_norm_lrelu(params["l4_conv"], out)
    out_pred = conv(params["l4_out"], out)

    # ---- deep supervision
    ds2_up = nn.upsample_nearest(conv(params["ds2"], ds2))
    ds3_c = conv(params["ds3"], ds3)
    out = out_pred + nn.upsample_nearest(ds2_up + ds3_c)
    if stage == "finetune":
        if head_impl == "phase":
            out = nn.upsample2_conv_residual(params["out_upscale"], out,
                                             dtype=dtype)
        else:
            # upsample2_conv_residual_explicit, with this graph's conv
            up = nn.upsample_nearest(out.to(dtype))
            out = up + conv(params["out_upscale"], up)
    return out


def apply_unet_fused(params: nn.Params, x: torch.Tensor, *, stage: str,
                     dtype=torch.bfloat16,
                     min_fused_voxels: int = 4096) -> torch.Tensor:
    """The same graph as :func:`apply_unet` with every stride-1 3^3 conv of
    at least ``min_fused_voxels`` voxels (and more than one input channel)
    lowered to ``ops.fused_conv.fused_conv3d`` (``Config.pallas_unet``;
    port of ``cfun_tpu/models/unet3d.py::apply_unet_fused``).

    The InstanceNorm + LeakyReLU before such a conv ride into it as a
    per-(batch, channel) affine (nearest upsampling commutes with both, so
    the up-convs upsample the raw tensor), and the conv emits its output
    moments, so the InstanceNorm after it needs no reduction pass.  Smaller
    convs take the same composition through ``F.conv3d``; stride-2 downs,
    1^3 convs and the finetune upscale head (its phase form) stay plain.
    bf16 rounds at other places than in :func:`apply_unet`.
    """
    b = x.shape[0]

    def nsp(t):
        return t.shape[2] * t.shape[3] * t.shape[4]

    def can_fuse(t):
        return t.shape[1] > 1 and nsp(t) >= min_fused_voxels

    def bc(v):
        return v[:, :, None, None, None]

    def in_affine(t):
        """(scale, shift) of IN(t), two-pass statistics (used where the
        producing op was not a fused conv)."""
        mean = torch.mean(t, dim=(2, 3, 4), dtype=torch.float32)
        var = torch.mean(torch.square(t.float() - bc(mean)), dim=(2, 3, 4))
        scale = torch.rsqrt(var + 1e-5)
        return scale, -mean * scale

    def conv(p, v, stride=1):
        return nn.conv3d(p, v, stride=stride, dtype=dtype)

    def fconv(p, v, affine=None, pre_lrelu=True):
        """Fused conv; the plain composition below min_fused_voxels."""
        if affine is None:
            affine = identity_affine(b, v.shape[1], device=v.device)
        if can_fuse(v):
            return fused_conv3d(v.contiguous(), p["w"], affine[0],
                                affine[1], pre_lrelu=pre_lrelu,
                                out_dtype=dtype)
        sc, sh = affine
        act = v.float() * bc(sc) + bc(sh)
        if pre_lrelu:
            act = nn.leaky_relu(act)
        y = conv(p, act.to(dtype))
        s = torch.stack([torch.sum(y, dim=(2, 3, 4), dtype=torch.float32),
                         torch.sum(torch.square(y.float()), dim=(2, 3, 4))],
                        dim=1)
        return y, s

    def apply_affine_lrelu(v, sums):
        sc, sh = in_affine_from_sums(sums, nsp(v))
        return nn.leaky_relu(v.float() * bc(sc) + bc(sh)).to(v.dtype)

    # ---- level 1 context
    out = nn.conv3d_1ch(params["c1_1"], x, dtype=dtype)
    residual = out
    out, _ = fconv(params["c1_2"], out)               # lrelu folded in
    out, _ = fconv(params["c1_lrelu_conv"], out)
    out = out + residual
    context_1 = nn.leaky_relu(out)
    aff = in_affine(out)

    # ---- levels 2-5 context
    contexts = []
    for lvl in (2, 3, 4, 5):
        if lvl == 2:
            down_in = nn.leaky_relu(out.float() * bc(aff[0]) +
                                    bc(aff[1])).to(dtype)
        else:
            down_in = nn.leaky_relu(nn.instance_norm(out))
        out = conv(params[f"c{lvl}_down"], down_in, stride=2)
        residual = out
        o1, s1 = fconv(params[f"c{lvl}_conv"], out, affine=in_affine(out))
        o2, _ = fconv(params[f"c{lvl}_conv"], o1,
                      affine=in_affine_from_sums(s1, nsp(o1)))
        out = o2 + residual
        if lvl < 5:
            contexts.append(nn.leaky_relu(nn.instance_norm(out)))
    context_2, context_3, context_4 = contexts

    def up_conv(p, v, affine):
        # the affine is v's; upsample the raw tensor and fold it in
        return fconv(p, nn.upsample_nearest(v), affine=affine)

    # ---- level 0 localization
    out, s = up_conv(params["l0_up_conv"], out, in_affine(out))
    out = apply_affine_lrelu(out, s)
    out = conv(params["l0_conv"], out)
    out = nn.leaky_relu(nn.instance_norm(out))

    # ---- decoder
    def decode(cat, conv_p, reduce_p, upconv_p):
        o, s = fconv(conv_p, cat, pre_lrelu=False)
        o = apply_affine_lrelu(o, s)
        ds = o
        o = conv(reduce_p, o)
        o, s = up_conv(upconv_p, o, in_affine(o))
        return apply_affine_lrelu(o, s), ds

    out = torch.cat([out, context_4], dim=1)
    out, _ = decode(out, params["l1_conv"], params["l1_reduce"],
                    params["l1_up_conv"])
    out = torch.cat([out, context_3], dim=1)
    out, ds2 = decode(out, params["l2_conv"], params["l2_reduce"],
                      params["l2_up_conv"])
    out = torch.cat([out, context_2], dim=1)
    out, ds3 = decode(out, params["l3_conv"], params["l3_reduce"],
                      params["l3_up_conv"])

    out = torch.cat([out, context_1], dim=1)
    o, s = fconv(params["l4_conv"], out, pre_lrelu=False)
    out = apply_affine_lrelu(o, s)
    out_pred = conv(params["l4_out"], out)

    # ---- deep supervision
    ds2_up = nn.upsample_nearest(conv(params["ds2"], ds2))
    ds3_c = conv(params["ds3"], ds3)
    out = out_pred + nn.upsample_nearest(ds2_up + ds3_c)

    if stage == "finetune":
        out = nn.upsample2_conv_residual(params["out_upscale"], out,
                                         dtype=dtype)
    return out
