"""Dense FLOPs of one served request, counted over the plain reference.

The count is PyTorch's ``FlopCounterMode`` over the reference graph run
on ``meta`` tensors (shapes only, no compute): the products (matmul,
bmm, einsum, convolution), 2 a multiply-add, every tap of a padded
convolution counted, elementwise work not counted.  These are the
conventions of the program's ``cost_of`` (a frozen copy of its count):
counted over the reference, the work of a request reads the same
whatever implements it.  The NMS, top-k and the argmaxes are not
products and count nothing.

A request's graph: the trunk on the molded volume; pyramid RoIAlign of
every proposal from both FPN levels; the classifier over the proposals;
RoIAlign of every detection slot's crop of the image; the U-Net over
those crops; for the overlap paste (LiTS), each slot's three resampling
products and the hit count's product.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import model
from portbench.reference.weights import layout, nest

META = torch.device("meta")


def count(fn: Callable, *args) -> float:
    """FLOPs of one run of ``fn(*args)``."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def meta_params(cfg) -> dict:
    return nest({k: torch.empty(s, device=META)
                 for k, s in layout(cfg).items()})


def _roi_align_meta(vol_shape, k, out_shape):
    c, d, h, w = vol_shape
    vol = torch.empty(vol_shape, device=META)
    ws = [torch.empty((k, m, n), device=META)
          for m, n in zip(out_shape, (d, h, w))]
    out = torch.einsum("kzD,CDHW->kCzHW", ws[0], vol)
    out = torch.einsum("kyH,kCzHW->kCzyW", ws[1], out)
    return torch.einsum("kxW,kCzyW->kCzyx", ws[2], out)


def _paste_meta(cfg, k, c, mask_shape):
    d, h, w = cfg.image_shape
    md, mh, mw = mask_shape
    for _ in range(k):
        x = torch.empty((c * md * mh, mw), device=META) @ torch.empty(
            (mw, w), device=META)
        y = torch.empty((h, mh), device=META) @ x.view(c, md, mh, w)
        torch.empty((c, d, md), device=META) @ y.reshape(c, md, h * w)
    torch.empty((d, k), device=META) @ torch.empty((k, h * w), device=META)


def request_parts(cfg) -> Dict[str, float]:
    """FLOPs of one request by part of the graph."""
    params = meta_params(cfg)
    d, h, w = cfg.image_shape
    image = torch.empty((1, cfg.image_channels, d, h, w), device=META)
    parts = {"trunk": count(model.trunk, params, image, "float32")}
    p2s, p3s = cfg.backbone_feature_shapes
    f, k = cfg.fpn_channels, cfg.post_nms_rois_inference
    parts["roi_align"] = sum(count(_roi_align_meta, (f, *s), k,
                                   tuple(cfg.pool_size)) for s in (p2s, p3s))
    pooled = torch.empty((k, f, *cfg.pool_size), device=META)
    parts["classifier"] = count(model.classifier, params["classifier"],
                                pooled, "float32")
    n = cfg.detection_max_instances
    parts["crops"] = count(_roi_align_meta, (cfg.image_channels, d, h, w),
                           n, tuple(cfg.mask_pool_size))
    crops = torch.empty((n, cfg.image_channels, *cfg.mask_pool_size),
                        device=META)
    parts["unet"] = count(model.unet, params["mask"]["unet"], crops,
                          cfg.stage, "float32")
    if cfg.name == "lits" or n > 1:
        up = 2 if cfg.stage == "finetune" else 1
        parts["paste"] = count(_paste_meta, cfg, n, cfg.num_classes,
                               tuple(up * s for s in cfg.mask_pool_size))
    return parts


def request_flops(cfg) -> float:
    return sum(request_parts(cfg).values())
