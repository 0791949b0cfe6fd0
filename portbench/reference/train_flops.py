"""Dense FLOPs of one training step, counted over the plain training
reference (``reference/train.py``) on ``meta`` tensors: its forward, the
six losses and autograd's backward, with the conventions of
``reference/flops.py`` (PyTorch's ``FlopCounterMode``: the products, 2 a
multiply-add, every tap of a padded convolution; elementwise work, the
NMS, the top-k and the sampler not counted).  The backward counts what
autograd computes: no gradient of the image, so not the first
convolution's input gradient.

A step's graph: the trunk on the molded volume; pyramid RoIAlign of the
``train_rois_per_image`` ROIs from both FPN levels; the classifier on
them; RoIAlign of the positives' crops of the image; the U-Net on those
crops; the losses; the backward of all but the image's crops.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import model, train
from portbench.reference.weights import layout, nest

META = torch.device("meta")


def _pool(vol, k, out_shape):
    """RoIAlign's three contractions of ``vol`` [C, D, H, W] for ``k``
    boxes, with the weights as shapes only."""
    c, d, h, w = vol.shape
    ws = [torch.empty((k, m, n), device=META)
          for m, n in zip(out_shape, (d, h, w))]
    out = torch.einsum("kzD,CDHW->kCzHW", ws[0], vol)
    out = torch.einsum("kyH,kCzHW->kCzyW", ws[1], out)
    return torch.einsum("kxW,kCzyW->kCzyx", ws[2], out)


def _step(cfg):
    params = nest({k: torch.empty(s, device=META, requires_grad=not
                                  k.endswith(("/mean", "/var")))
                   for k, s in layout(cfg).items()})
    d, h, w = cfg.image_shape
    image = torch.empty((1, cfg.image_channels, d, h, w), device=META)
    p2, p3, logits, deltas = model.trunk(params, image, "float32")
    r = cfg.train_rois_per_image
    pool = tuple(cfg.pool_size)
    pooled = _pool(p2[0], r, pool) + _pool(p3[0], r, pool)
    cls_logits, box_deltas = model.classifier(params["classifier"], pooled,
                                              "float32")
    p = train.positive_capacity(cfg)
    crops = _pool(image[0], p, tuple(cfg.mask_pool_size))
    keep = [torch.ones(s, dtype=torch.bool, device=META)
            for s in ((p, c, 1, 1, 1) for c in
                      (cfg.unet_base_channels * 2 ** i for i in range(5)))]
    mask_logits = train.unet(params["mask"]["unet"], crops, cfg.stage,
                             "float32", keep, cfg.unet_dropout_rate)
    total = (logits.sum() + deltas.sum() + cls_logits.sum()
             + box_deltas.sum() + torch.logsumexp(mask_logits, 1).sum())
    total.backward()


def step_flops(cfg) -> float:
    """FLOPs of one training step of ``cfg`` (a ``RefConfig``)."""
    with FlopCounterMode(display=False) as counter:
        _step(cfg)
    return float(counter.get_total_flops())
