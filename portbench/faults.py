"""Faults planted in the program under test, to show that ``correct``
catches them: each breaks the served path where it produces an answer.

    with planted("k1_second_best"):
        det.detect(volume)

patches a function of the program for the duration of the block and
restores it after.  The benchmark's own runs plant nothing: the faults
serve ``control.py`` (their readings on the card, at a cell's size) and
the CPU tests.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch


def _with_nms(cfun, nms_of: Callable):
    """``cfun.infer_forward`` with its NMS (K1, at both sites) replaced
    by ``nms_of(real nms)``."""
    real = cfun.infer_forward

    def broken(*args, **kwargs):
        kwargs["nms"] = nms_of(kwargs.get("nms", cfun.sorted_nms))
        return real(*args, **kwargs)

    return "infer_forward", broken


def k1_no_suppression(cfun):
    """K1 suppresses nothing: the first ``k`` valid boxes by score."""
    def nms_of(nms):
        return lambda boxes, valid, thr, k: nms(boxes, valid, 1.0, k)
    return _with_nms(cfun, nms_of)


def k1_second_best(cfun):
    """K1 drops its first kept box and returns the next ones."""
    def nms_of(nms):
        def second(boxes, valid, thr, k):
            idx, keep = nms(boxes, valid, thr, k + 1)
            return idx[1:], keep[1:]
        return second
    return _with_nms(cfun, nms_of)


def drop_partial(cfun):
    """The detection layer keeps only its first detection of several."""
    real = cfun.refine_detections

    def broken(*args, **kwargs):
        det, kept = real(*args, **kwargs)
        first = torch.zeros_like(kept)
        first[:1] = kept[:1]
        return det * first[:, None].to(det.dtype), first

    return "refine_detections", broken


def drop_all(cfun):
    """Every detection dropped where the device graph produces them."""
    real = cfun.refine_detections

    def broken(*args, **kwargs):
        det, kept = real(*args, **kwargs)
        return torch.zeros_like(det), torch.zeros_like(kept)

    return "refine_detections", broken


def box_moved(cfun):
    """Every kept box moved off its object, by its own depth along z
    (towards the side of the window with room), where the detection
    layer produces it."""
    real = cfun.refine_detections

    def broken(rois, roi_valid, probs, deltas, window, *args, **kwargs):
        det, kept = real(rois, roi_valid, probs, deltas, window, *args,
                         **kwargs)
        depth = det[:, 3] - det[:, 0]
        up = det[:, 3] + depth <= window[3]
        shift = torch.where(up, depth, -depth) * kept.to(det.dtype)
        moved = det.clone()
        moved[:, 0] += shift
        moved[:, 3] += shift
        return moved, kept

    return "refine_detections", broken


def device_labels(cfun):
    """A third of the label volume altered where the device graph
    produces it."""
    real = cfun.infer_forward

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        labels = out.mask_labels.clone()
        flat = labels.view(-1)
        flat[: flat.numel() // 3] = 1
        return out._replace(mask_labels=labels)

    return "infer_forward", broken


FAULTS: Dict[str, Callable] = {
    f.__name__: f for f in (k1_no_suppression, k1_second_best, drop_partial,
                            drop_all, box_moved, device_labels)}


@contextlib.contextmanager
def planted(name: str):
    """The program's graph module (``cfun_tpu_torch.models.cfun``) with
    the fault ``name`` planted, for the block."""
    from cfun_tpu_torch.models import cfun

    attr, broken = FAULTS[name](cfun)
    real = getattr(cfun, attr)
    setattr(cfun, attr, broken)
    try:
        yield
    finally:
        setattr(cfun, attr, real)
