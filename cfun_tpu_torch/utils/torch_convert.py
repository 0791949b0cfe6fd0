"""Reference (PyTorch) ``state_dict`` -> the port's parameter tree.

The port's copy of ``cfun_tpu/utils/torch_convert.py``.  It maps the
reference ``MaskRCNN`` module tree (model.py:1259-1304: fpn.C1-C3 = P3D
stages, fpn.P*_conv* = FPN lateral/refine convs, rpn.*, classifier.*,
mask.modified_u_net.* = mask_branch.py Modified3DUNet) onto the port's
tree paths (``weights.layout``).

The reference's layouts are the port's: Conv3d weights ``[C_out, C_in, kD,
kH, kW]`` and Linear weights ``[out, in]``, so every leaf is taken as it
is, as float32.  The tree is checked against ``weights.layout(cfg)``: a
parameter the state_dict lacks raises, and so does a shape that is not
``cfg``'s.  Entries of the state_dict the port does not read (BN
``num_batches_tracked``, anything outside the mapped modules) are ignored.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from cfun_tpu_torch import weights
from cfun_tpu_torch.models.p3d import BACKBONE_DEPTHS

StateDict = Mapping[str, object]  # name -> tensor or array

_BN = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
       ("var", "running_var"))
_BOTTLENECK = (("conv1", "conv1", "conv"), ("bn1", "bn1", "bn"),
               ("conv_s", "conv2", "conv"), ("bn_s", "bn2", "bn"),
               ("conv_t", "conv3", "conv"), ("bn_t", "bn3", "bn"),
               ("conv4", "conv4", "conv"), ("bn4", "bn4", "bn"))
_FPN = (("p3_conv1", "P3_conv1"), ("p3_conv2", "P3_conv2"),
        ("p2_conv1", "P2_conv1"), ("p2_conv2", "P2_conv2"))
_RPN = (("shared", "conv_shared"), ("cls", "conv_class"),
        ("bbox", "conv_bbox"))
# Modified3DUNet (reference mask_branch.py:11-220); every conv bias-free,
# InstanceNorm3d affine-free
_UNET = (
    ("c1_1", "conv3d_c1_1"),
    ("c1_2", "conv3d_c1_2"),
    ("c1_lrelu_conv", "lrelu_conv_c1.1"),
    ("c2_down", "conv3d_c2"), ("c2_conv", "norm_lrelu_conv_c2.2"),
    ("c3_down", "conv3d_c3"), ("c3_conv", "norm_lrelu_conv_c3.2"),
    ("c4_down", "conv3d_c4"), ("c4_conv", "norm_lrelu_conv_c4.2"),
    ("c5_down", "conv3d_c5"), ("c5_conv", "norm_lrelu_conv_c5.2"),
    ("l0_up_conv", "norm_lrelu_upscale_conv_norm_lrelu_l0.3"),
    ("l0_conv", "conv3d_l0"),
    ("l1_conv", "conv_norm_lrelu_l1.0"),
    ("l1_reduce", "conv3d_l1"),
    ("l1_up_conv", "norm_lrelu_upscale_conv_norm_lrelu_l1.3"),
    ("l2_conv", "conv_norm_lrelu_l2.0"),
    ("l2_reduce", "conv3d_l2"),
    ("l2_up_conv", "norm_lrelu_upscale_conv_norm_lrelu_l2.3"),
    ("l3_conv", "conv_norm_lrelu_l3.0"),
    ("l3_reduce", "conv3d_l3"),
    ("l3_up_conv", "norm_lrelu_upscale_conv_norm_lrelu_l3.3"),
    ("l4_conv", "conv_norm_lrelu_l4.0"),
    ("l4_out", "conv3d_l4"),
    ("ds2", "ds2_1x1_conv3d"),
    ("ds3", "ds3_1x1_conv3d"),
    ("out_upscale", "out_upscale_conv.1"),
)


def _leaf(sd: StateDict, name: str) -> torch.Tensor:
    v = sd[name]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return torch.from_numpy(np.array(v, np.float32))


def maskrcnn_from_torch(sd: StateDict, cfg) -> dict:
    """Full reference ``MaskRCNN.state_dict()`` -> the port's parameter
    tree for ``cfg`` (float32 CPU tensors), checked against
    ``weights.layout(cfg)``."""
    flat: Dict[str, torch.Tensor] = {}

    def conv(ours: str, theirs: str, bias: bool = True) -> None:
        flat[f"{ours}/w"] = _leaf(sd, f"{theirs}.weight")
        if bias:
            flat[f"{ours}/b"] = _leaf(sd, f"{theirs}.bias")

    def bn(ours: str, theirs: str) -> None:
        for o, t in _BN:
            flat[f"{ours}/{o}"] = _leaf(sd, f"{theirs}.{t}")

    conv("backbone/stem_conv", "fpn.C1.0")
    bn("backbone/stem_bn", "fpn.C1.1")
    for stage, depth in zip((2, 3), BACKBONE_DEPTHS[cfg.backbone]):
        for b in range(depth):
            ours, theirs = f"backbone/c{stage}/{b}", f"fpn.C{stage}.{b}"
            for o, t, kind in _BOTTLENECK:
                (conv if kind == "conv" else bn)(f"{ours}/{o}",
                                                 f"{theirs}.{t}")
            if f"{theirs}.downsample.0.weight" in sd:
                conv(f"{ours}/down_conv", f"{theirs}.downsample.0")
                bn(f"{ours}/down_bn", f"{theirs}.downsample.1")
    for o, t in _FPN:
        conv(f"fpn/{o}", f"fpn.{t}")
    for o, t in _RPN:
        conv(f"rpn/{o}", f"rpn.{t}")
    conv("classifier/conv1", "classifier.conv1")
    bn("classifier/bn1", "classifier.bn1")
    conv("classifier/conv2", "classifier.conv2")
    bn("classifier/bn2", "classifier.bn2")
    # the Linear layers: weight [out, in] and bias, as a conv's leaves
    conv("classifier/cls", "classifier.linear_class")
    conv("classifier/bbox", "classifier.linear_bbox")
    for o, t in _UNET:
        conv(f"mask/unet/{o}", f"mask.modified_u_net.{t}", bias=False)
    return weights.checked_tree(flat, cfg)
