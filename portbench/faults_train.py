"""Faults planted in the program's training step, to show that the train
cell's ``correct`` catches them: each breaks the step where it computes.

    with planted("k1_iou_05"):
        train_model(...)

patches a function of the program for the duration of the block (the
whole run: the optimizer is built at its start) and restores it after.
The benchmark's own runs plant nothing: the faults serve
``control_train.py`` (their readings on the card, at the cell's size)
and the CPU tests.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict


def _weighted_without(name: str):
    def fault(step, losses):
        real = losses.weighted_total

        def broken(parts, cfg):
            return real({k: v * 0.0 if k == name else v
                         for k, v in parts.items()}, cfg)

        return losses, "weighted_total", broken
    return fault


def edge_weight_0(step, losses):
    """The edge loss weighted 0 (a no-op where the stage computes no edge
    loss, as heart 'beginning')."""
    return _weighted_without("mrcnn_mask_edge_loss")(step, losses)


def mask_weight_0(step, losses):
    """The mask loss weighted 0: the U-Net learns nothing from its
    targets."""
    return _weighted_without("mrcnn_mask_loss")(step, losses)


def dropout_ignored(step, losses):
    """The U-Net's dropout keep masks ignored: no dropout."""
    real = step.apply_mask_head

    def broken(*args, **kwargs):
        kwargs["dropout_masks"] = None
        return real(*args, **kwargs)

    return step, "apply_mask_head", broken


def k1_iou_05(step, losses):
    """The proposal layer's K1 at IoU 0.5, not the configuration's."""
    real = step.cfun.propose

    def broken(rpn_logits, rpn_deltas, anchors, cfg, count, nms=None):
        inner = nms or step.sorted_nms
        return real(rpn_logits, rpn_deltas, anchors, cfg, count,
                    nms=lambda boxes, valid, thr, k: inner(boxes, valid,
                                                           0.5, k))

    return step.cfun, "propose", broken


def pre_nms_half(step, losses):
    """The proposal layer's NMS given half the configuration's
    ``pre_nms_limit`` boxes: a wrong top-k."""
    real = step.cfun.propose

    def broken(rpn_logits, rpn_deltas, anchors, cfg, count, nms=None):
        cfg = cfg.replace(pre_nms_limit=cfg.pre_nms_limit // 2)
        return real(rpn_logits, rpn_deltas, anchors, cfg, count,
                    nms=nms or step.sorted_nms)

    return step.cfun, "propose", broken


def deltas_unscaled(step, losses):
    """The proposal layer's boxes decoded from the RPN deltas without
    ``rpn_bbox_std``: a wrong decode."""
    real = step.cfun.propose

    def broken(rpn_logits, rpn_deltas, anchors, cfg, count, nms=None):
        std = step.torch.tensor(cfg.rpn_bbox_std, dtype=rpn_deltas.dtype,
                                device=rpn_deltas.device)
        return real(rpn_logits, rpn_deltas / std, anchors, cfg, count,
                    nms=nms or step.sorted_nms)

    return step.cfun, "propose", broken


def decay_on_norm(step, losses):
    """Weight decay on the norm layers' parameters too."""
    real = step.decay_mask

    def broken(params):
        return step.weights._unflatten({p: True for p in step.weights._leaves(
            real(params))})

    return step, "decay_mask", broken


def clip_skipped(step, losses):
    """The gradient norm never clipped."""
    real = step.make_optimizer

    def broken(cfg, params):
        opt = real(cfg, params)
        opt.max_norm = float("inf")
        return opt

    return step, "make_optimizer", broken


FAULTS: Dict[str, Callable] = {
    f.__name__: f for f in (edge_weight_0, mask_weight_0, dropout_ignored,
                            k1_iou_05, pre_nms_half, deltas_unscaled,
                            decay_on_norm, clip_skipped)}


@contextlib.contextmanager
def planted(name: str):
    """The program's train step (``cfun_tpu_torch.train.step``) with the
    fault ``name`` planted, for the block."""
    from cfun_tpu_torch.train import losses, step

    owner, attr, broken = FAULTS[name](step, losses)
    real = getattr(owner, attr)
    setattr(owner, attr, broken)
    try:
        yield
    finally:
        setattr(owner, attr, real)
