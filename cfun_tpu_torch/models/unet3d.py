"""Modified 3D U-Net mask branch, inference form (port of
``cfun_tpu/models/unet3d.py::apply_unet``).

A 5-level context pathway (stride-2 3^3 convs, residual blocks,
InstanceNorm + LeakyReLU) and a 4-level localization pathway (nearest
upsample + conv) with skip concatenations and deep supervision (ds2/ds3
1^3 convs upsampled and summed into the output).  Inference has no
dropout.  Kept quirks of the reference graph: ``c{N}_conv`` is applied
twice with the same weights inside each context level, ``context_1`` taps
the pre-norm activation, and every conv is bias-free.

Only the 'beginning' and 'together' stages (96^3 masks) are ported; the
'finetune' 2x upscale head (``out_upscale``) belongs to a later slice.
"""

from __future__ import annotations

import torch

from cfun_tpu_torch import nn


def apply_unet(params: nn.Params, x: torch.Tensor, *, stage: str,
               dtype=torch.float32) -> torch.Tensor:
    """x: [B, c_in, D, H, W] crop -> class logits [B, n_classes, D, H, W]
    in ``dtype``."""
    if stage == "finetune":
        raise NotImplementedError(
            "the finetune upscale head is not ported yet (stage "
            "'finetune'); the port serves 'beginning' and 'together'")

    def conv(p, v, stride=1):
        return nn.conv3d(p, v, stride=stride, dtype=dtype)

    inorm = nn.instance_norm
    lrelu = nn.leaky_relu

    def norm_lrelu_conv(p, v):
        return conv(p, lrelu(inorm(v)))

    def conv_norm_lrelu(p, v):
        return lrelu(inorm(conv(p, v)))

    def norm_lrelu_upscale_conv_norm_lrelu(p, v):
        v = lrelu(inorm(v))
        return lrelu(inorm(nn.upsample2_conv(p, v, dtype=dtype)))

    # ---- level 1 context
    out = nn.conv3d_1ch(params["c1_1"], x, dtype=dtype)
    residual = out
    out = conv(params["c1_2"], lrelu(out))
    out = conv(params["c1_lrelu_conv"], lrelu(out))
    out = out + residual
    context_1 = lrelu(out)  # pre-norm tap (mask_branch.py:134)
    out = lrelu(inorm(out))

    # ---- levels 2-5 context (shared-weight double conv per level)
    contexts = []
    for lvl in (2, 3, 4, 5):
        out = conv(params[f"c{lvl}_down"], out, stride=2)
        residual = out
        out = norm_lrelu_conv(params[f"c{lvl}_conv"], out)
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
    return out_pred + nn.upsample_nearest(ds2_up + ds3_c)
