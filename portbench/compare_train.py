"""The comparison that decides ``correct`` for a training step.

A judged step is what the program's step took and gave, kept by
``drivers/train.py`` as the step handed its gradients to the optimizer
(a ``Judged``):
its batch, its draws, its K1 call, its detection targets, the loss parts
it reported, its gradients, its parameters and momentum before it and
its parameters after.  The plain reference (``reference/train.py``,
float32) judges it at the program's own choices:

* ``proposal_mismatch``: the proposal layer before its NMS, the
  program's 1000 boxes against the reference's own (its float32 scores
  and deltas, the anchors, ``pre_nms_boxes``): the larger share, of
  either side's boxes, that no box of the other side overlaps by IoU
  ``MATCH_IOU`` or more.  It reads a wrong decode, clip or top-k, which
  the sides' shared inputs otherwise hide (the proposals carry no
  gradient), and RPN outputs computed below bfloat16; rank swaps at the
  top-k's edge are its sound reading;
* ``k1_keep_mismatch``: boxes whose place in the 1000 -> 500 keep set
  breaks greedy NMS of the program's own boxes at the configuration's
  threshold (``keep_set_violations``; exact);
* ``targets_mismatch``: ROI slots whose proposal, validity or class
  differ from the reference's sampler on the program's proposals, GT box
  and uniforms (exact);
* ``rpn_target_violations``: anchors whose RPN match breaks the published
  rule, on the reference's own IoUs (exact);
* ``loss_rel_err``: the largest error of a loss part against the
  reference's forward, weighted as the objective weighs the part,
  relative to the reference's objective (the weighted total): a part
  counts by how far it moves the objective.  A part's error relative to
  itself is heavy-tailed where the part is small (the RPN box loss of
  trained weights: bfloat16 deltas close to their targets read 0.62 in
  one of ~190 sound steps);
* ``grad_cos_min``: the lowest cosine of a trainable leaf's gradient with
  the reference's (autograd), over the leaves that carry at least
  ``LEAF_SHARE`` of the reference's global gradient norm; a floor;
* ``grad_cos_group_min``: the lowest cosine of a module's gradient, all
  its leaves in one vector, over the modules (the tree's first level:
  backbone, fpn, rpn, classifier, mask); a floor.  A module's leaves may
  each carry under ``LEAF_SHARE`` (the mask U-Net's, on some steps: it
  learns from RoIAlign crops of the image, so no trunk leaf carries its
  error), and a module's cosine judges them together;
* ``grad_norm_rel_err``: the relative error of the global gradient norm;
* ``update_rel_err``: the program's update against the reference
  optimizer's on the program's own gradients, momentum and parameters
  (``update_number``).

Only the numbers named in a configuration's ``limits`` decide.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

from portbench.reference import train as ref

NUMBERS = ("proposal_mismatch", "k1_keep_mismatch", "targets_mismatch",
           "rpn_target_violations", "loss_rel_err", "grad_cos_min",
           "grad_cos_group_min", "grad_norm_rel_err", "update_rel_err")
FLOORS = ("grad_cos_min", "grad_cos_group_min")  # judged from below
# a leaf whose gradient carries less of the global norm moves the update
# by less than that; its cosine is the rounding of a sum that cancels
# (the RPN class bias: two entries, equal and opposite), and is not judged
LEAF_SHARE = 0.01
# a box refined from the same anchor by bfloat16 deltas overlaps the
# float32 one by IoU 0.99 or more (the card's sound steps), by float8
# deltas 0.95-0.96 at the 40th lowest of 1000; an anchor's neighbour of
# the same size, one stride over, by (1 - stride / size)^3 at most
MATCH_IOU = 0.97


class Judged(NamedTuple):
    """One step of the program, as ``drivers/train.py`` kept it (tensors
    on the device; leaves by tree path)."""
    step: int
    image: torch.Tensor
    rpn_match: torch.Tensor
    rpn_deltas: torch.Tensor
    gt_box_norm: torch.Tensor
    labels: torch.Tensor
    u_pos: torch.Tensor
    u_neg: torch.Tensor
    keep_masks: Optional[List[torch.Tensor]]
    nms: Tuple  # (score-sorted boxes, valid, threshold, idx, keep)
    targets: Tuple  # (rois, roi_valid, class_ids) of the program's sampler
    parts: Dict[str, float]
    grads: Dict[str, torch.Tensor]
    before: Dict[str, torch.Tensor]
    momentum: Dict[str, Optional[torch.Tensor]]
    after: Dict[str, torch.Tensor]
    momentum_after: Dict[str, torch.Tensor]


def proposals_of(cfg, nms) -> Tuple[torch.Tensor, torch.Tensor]:
    """The normalized proposals of a K1 call: (boxes, valid)."""
    boxes, _, _, idx, keep = nms
    picked = boxes[idx.long()]
    picked = torch.where(keep[:, None], picked, torch.zeros_like(picked))
    return picked / ref._shape6(cfg.image_shape, boxes.device), keep


def batch_of(cfg, j: Judged) -> ref.Batch:
    proposals, valid = proposals_of(cfg, j.nms)
    return ref.Batch(j.image, j.rpn_match, j.rpn_deltas, j.gt_box_norm,
                     j.labels, proposals, valid, j.u_pos, j.u_neg,
                     j.keep_masks)


def proposal_ious(mine: torch.Tensor, want: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each box's best IoU with a box of the other side, for the boxes
    ``mine`` and ``want`` ([N, 6] in voxels): (mine's, want's)."""
    iou = ref.iou_matrix(mine.float(), want.float())
    return iou.amax(1), iou.amax(0)


def choice_numbers(cfg, j: Judged, t: ref.Targets) -> Dict[str, float]:
    """The program's choices against the published rules."""
    boxes, valid, _, idx, keep = j.nms
    k1 = ref.keep_set_violations(boxes, valid, cfg.rpn_nms_threshold,
                                 cfg.post_nms_rois_training, idx, keep)
    rois, roi_valid, class_ids = j.targets
    slot = (roi_valid.bool() != t.roi_valid) | (
        t.roi_valid & ((class_ids.long() != t.class_ids)
                       | (rois.float() != t.rois).any(1)))
    return {"k1_keep_mismatch": float(k1),
            "targets_mismatch": float(slot.sum()),
            "rpn_target_violations": float(ref.rpn_target_violations(
                cfg, j.gt_box_norm, j.rpn_match))}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a)


def leaf_cosines(grads: Dict[str, torch.Tensor],
                 want: Dict[str, torch.Tensor]
                 ) -> Dict[str, Tuple[float, float]]:
    """Each trainable leaf's (gradient cosine with the reference's, 1
    where both are zero; the reference gradient's share of the global
    norm)."""
    total = sum(float((b * b).sum()) for b in want.values()) ** 0.5
    out = {}
    for path, b in want.items():
        a = grads[path].float() if path in grads else torch.zeros_like(b)
        sa, sb = float((a * a).sum()), float((b * b).sum())
        cos = (float((a * b).sum()) / max((sa * sb) ** 0.5, 1e-300)
               if sa or sb else 1.0)
        out[path] = (cos, sb ** 0.5 / max(total, 1e-300))
    return out


def group_cosines(grads: Dict[str, torch.Tensor],
                  want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{module (a path's first part): the cosine of its leaves' gradients,
    as one vector, with the reference's (1 where both are zero)}."""
    sums: Dict[str, List[float]] = {}
    for path, b in want.items():
        a = grads[path].float() if path in grads else torch.zeros_like(b)
        acc = sums.setdefault(path.split("/")[0], [0.0, 0.0, 0.0])
        acc[0] += float((a * b).sum())
        acc[1] += float((a * a).sum())
        acc[2] += float((b * b).sum())
    return {g: ab / max((aa * bb) ** 0.5, 1e-300) if aa or bb else 1.0
            for g, (ab, aa, bb) in sums.items()}


def gradient_numbers(grads: Dict[str, torch.Tensor],
                     want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``grad_cos_min`` over the leaves that carry at least
    ``LEAF_SHARE`` of the reference's global gradient norm,
    ``grad_cos_group_min`` (and each module's cosine, as
    ``grad_cos.<module>``) and ``grad_norm_rel_err``."""
    na = sum(float((g.float() ** 2).sum()) for g in grads.values())
    nb = sum(float((g ** 2).sum()) for g in want.values())
    cos = [c for c, share in leaf_cosines(grads, want).values()
           if share >= LEAF_SHARE]
    groups = group_cosines(grads, want)
    return {"grad_cos_min": min(cos),
            "grad_cos_group_min": min(groups.values()),
            **{f"grad_cos.{g}": c for g, c in groups.items()},
            "grad_norm_rel_err": _rel(na ** 0.5, nb ** 0.5)}


def update_number(cfg, j: Judged) -> float:
    """The program's update against the reference optimizer's on the
    program's own gradients, momentum and parameters: the larger of the
    worst trainable leaf's new momentum (the step's direction, whose
    ``learning_rate`` multiple the parameters move by) and the parameter
    change over all leaves, each relative to the reference's.  The
    parameter change is judged over all leaves together: one leaf's
    change is a few float32 steps of its values, which its rounding
    moves.  A frozen leaf that moves reads 1."""
    grads = {p: j.grads.get(p, torch.zeros_like(v))
             for p, v in j.before.items() if ref.trainable(p)}
    new, new_m = ref.sgd_update(cfg, j.before, grads, j.momentum)
    worst, err2, want2 = 0.0, 0.0, 0.0
    for path, before in j.before.items():
        moved = j.after[path] - before
        if path not in new:
            worst = max(worst, 1.0 if bool(moved.any()) else 0.0)
            continue
        want = new[path] - before
        err2 += float(((moved - want).double() ** 2).sum())
        want2 += float((want.double() ** 2).sum())
        m = new_m[path]
        got = j.momentum_after.get(path)
        got = torch.zeros_like(m) if got is None else got
        worst = max(worst, _rel(float(torch.linalg.vector_norm(got - m)),
                                0.0) if not bool(m.any()) else
                    float(torch.linalg.vector_norm(got - m))
                    / float(torch.linalg.vector_norm(m)))
    return max(worst, (err2 / want2) ** 0.5 if want2 else err2 ** 0.5)


def reference_params(j: Judged) -> dict:
    """The reference's own float32 copy of the parameters before the
    step, nested."""
    from portbench.reference.weights import nest

    return nest({p: v.detach().float().clone() for p, v in j.before.items()})


def judge(cfg, j: Judged, prec: str = "float32") -> Dict[str, float]:
    """The numbers of one judged step (``prec`` 'fp8': the float8 control
    stands in for the program's loss parts, gradients and update)."""
    b = batch_of(cfg, j)
    _, parts, t, grads, boxes = ref.gradients(reference_params(j), cfg, b)
    if not bool(t.pos_valid.any()):
        raise RuntimeError(f"judged step {j.step} has no valid positive "
                           "ROI: its mask branch ran on nothing")
    out = choice_numbers(cfg, j, t)
    if prec == "float32":
        mine, my_grads = j.parts, j.grads
        my_boxes = j.nms[0][j.nms[1]]
        out["update_rel_err"] = update_number(cfg, j)
    else:
        _, low, _, my_grads, my_boxes = ref.gradients(
            reference_params(j), cfg, b, prec)
        mine = {k: float(v) for k, v in low.items()}
        out["update_rel_err"] = 0.0
    best = proposal_ious(my_boxes, boxes)
    out["proposal_mismatch"] = max(float((b < MATCH_IOU).float().mean())
                                   for b in best)
    print(json.dumps({"judge": j.step, "prec": prec, "proposal_iou_lowest": [
        [round(float(x), 4) for x in torch.sort(b).values[:40]]
        for b in best]}), file=sys.stderr)
    weights = dict(cfg.loss_weights)
    objective = abs(sum(weights[k] * float(parts[k])
                        for k in ref.LOSS_NAMES))
    for k in ref.LOSS_NAMES:
        out[f"loss_rel_err.{k}"] = weights[k] * abs(
            float(mine[k]) - float(parts[k])) / max(objective, 1e-30)
    out["loss_rel_err"] = max(out[f"loss_rel_err.{k}"]
                              for k in ref.LOSS_NAMES)
    out.update(gradient_numbers(my_grads, grads))
    out["grad_norm"] = sum(float((g ** 2).sum())
                           for g in grads.values()) ** 0.5
    cos = leaf_cosines(my_grads, grads)
    low = sorted(cos, key=lambda p: cos[p][0])[:12]
    print(json.dumps({"judge": j.step, "prec": prec, "lowest_leaves": [
        [p, round(cos[p][0], 4), round(cos[p][1], 5)] for p in low]}),
        file=sys.stderr)
    out["positive_rois"] = float(t.pos_valid.sum())
    return out


def _floor(name: str) -> bool:
    return name in FLOORS or name.startswith("grad_cos.")


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    readings = list(readings)
    return {k: (min if _floor(k) else max)(r[k] for r in readings)
            for k in readings[0]}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, List[Dict]]:
    """(every limited number within its limit, [{name, value, limit}]:
    the limited numbers in order, then the others with limit None);
    ``grad_cos_min``'s limit is a floor, every other one a ceiling."""
    rows = [{"name": k, "value": numbers[k], "limit": limits[k]}
            for k in NUMBERS if k in limits]
    rows += [{"name": k, "value": numbers[k], "limit": None}
             for k in NUMBERS if k not in limits]

    def within(r):
        if r["name"] in FLOORS:
            return r["value"] >= r["limit"]
        return r["value"] <= r["limit"]

    return all(within(r) for r in rows if r["limit"] is not None), rows
