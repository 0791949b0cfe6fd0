"""The comparison that decides ``correct`` for a served request.

The program's outputs are judged where the device graph hands them to
the host (its molded detections and label volume, as ``Detector.unmold``
receives them) and where the request ends (the raw-geometry result
dict).  The plain reference serves the same raw volume and weights in
float32 and judges them, as a served token is judged by the reference's
logits at the position the program chose it:

* ``det_missed``: the reference's own detections that no program
  detection overlaps by the matching IoU (the configuration's detection
  NMS threshold, above which two boxes are one object, or 0.5, the usual
  criterion of a detection benchmark, where that is lower), each read as how far the reference's score lies
  above the confidence limit; the largest, 0 where none is missed.  A
  detection the program drops, or moves off its object, reads its whole
  margin; one that only the rounding of a near-tie moves, or that lies at
  the limit, reads about 0;
* ``det_unsupported``: each program detection rescored by the
  reference's classifier at the program's own box (RoIAlign of the
  reference's pyramid), read as how far the reference's probability of
  the program's class lies below the confidence limit; the largest;
* ``det_overlap_excess``: how far the largest IoU between two detections
  the program keeps lies above the configuration's detection NMS
  threshold, a guarantee of the NMS (0 where it holds);
* ``label_mismatch_pct``: on the program's own boxes, the labels whose
  class is not the argmax of the reference's probabilities, in % of the
  voxels either side labels as foreground (the heart's 2x crop, LiTS'
  molded overlap-paste volume); where the program keeps no detection and
  the reference keeps one, the reference's labels on its own boxes
  against none (100%);
* ``label_gap_mean``: the mean, over those foreground voxels, of how far
  the reference's probability of the program's label lies below its best;
* ``unmold_mismatch``: raw voxels, box coordinates and scores in which
  the program's result differs from the reference's unmold of the
  program's own molded outputs (exact: the host unmold).

Only the numbers named in a configuration's ``limits`` decide; the
others are printed beside them.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from portbench.reference.model import (Served, iou_matrix, label_probs,
                                       rescore, serve, uses_overlap_paste)
from portbench.reference.serve import molded_image, unmold, window_of

NUMBERS = ("det_missed", "det_unsupported", "det_overlap_excess",
           "label_mismatch_pct", "label_gap_mean", "label_gap_max",
           "unmold_mismatch")


def detection_numbers(params, cfg, det, kept, ref: Served, prec
                      ) -> Dict[str, float]:
    """The program's kept detections (molded voxel boxes) against the
    reference's detections, its classifier and the NMS threshold."""
    thr = cfg.detection_min_confidence
    match = min(cfg.detection_nms_threshold, 0.5)
    mine = det[kept]
    theirs = ref.detections[ref.kept]
    missed = 0.0
    if theirs.shape[0]:
        best = (iou_matrix(theirs[:, :6], mine[:, :6]).amax(1)
                if mine.shape[0] else torch.zeros(theirs.shape[0],
                                                  device=det.device))
        lost = best < match
        if bool(lost.any()):
            missed = max(0.0, float((theirs[lost, 7] - thr).max()))
    probs = rescore(params, cfg, ref, mine[:, :6], prec)
    own = probs.gather(1, mine[:, 6:7].long().clamp(0, 1))[:, 0]
    unsupported = max(0.0, float((thr - own).max())) if own.numel() else 0.0
    excess = 0.0
    if mine.shape[0] > 1:
        iou = iou_matrix(mine[:, :6], mine[:, :6])
        iou.fill_diagonal_(0.0)
        excess = max(0.0, float(iou.max()) - cfg.detection_nms_threshold)
    return {"det_missed": missed, "det_unsupported": unsupported,
            "det_overlap_excess": excess}


def label_numbers(cfg, probs, labels, kept) -> Dict[str, float]:
    """Program labels against the reference's probabilities on the
    program's boxes."""
    if uses_overlap_paste(cfg):
        p, lab = probs, labels.long()
        cls = 0
    else:
        p, lab = probs[kept], labels[kept].long()
        cls = 1
    if lab.numel() == 0:
        return {"label_mismatch_pct": 0.0, "label_gap_mean": 0.0,
                "label_gap_max": 0.0}
    best, arg = p.max(cls)
    own = p.gather(cls, lab.unsqueeze(cls)).squeeze(cls)
    fg = (arg != 0) | (lab != 0)
    gap = (best - own)[fg]
    n = max(int(fg.sum()), 1)
    return {"label_mismatch_pct": 100.0 * int((arg != lab).sum()) / n,
            "label_gap_mean": float(gap.sum()) / n,
            "label_gap_max": float(gap.max()) if gap.numel() else 0.0}


def reference(params, cfg, raw: np.ndarray, device, prec="float32"
              ) -> Tuple[torch.Tensor, np.ndarray, Served]:
    """The reference's request on ``raw``: (molded image, window, what its
    graph serves)."""
    window = window_of(cfg, raw.shape)
    image = molded_image(cfg, raw, device)
    return image, window, serve(params, cfg, image,
                                torch.from_numpy(window).to(device), prec)


def judge(params, cfg, raw: np.ndarray, ref: Tuple, molded: Tuple,
          result: Dict, device, prec: str = "float32") -> Dict[str, float]:
    """The numbers of one request: ``ref`` the reference's request on the
    same raw volume (``reference``), ``molded`` = (detections [Dmax, 8],
    kept [Dmax], labels int8) as the program's graph handed them to the
    host, ``result`` the program's result dict."""
    image, window, served = ref
    det_np, kept_np, labels_np = molded
    det = torch.from_numpy(np.ascontiguousarray(det_np)).to(device)
    kept = torch.from_numpy(np.ascontiguousarray(kept_np)).to(device)
    labels = torch.from_numpy(np.ascontiguousarray(labels_np)).to(device)
    with torch.no_grad():
        out = detection_numbers(params, cfg, det, kept, served, prec)
        if bool(kept.any()) or not bool(served.kept.any()):
            probs = label_probs(params, cfg, image, det, kept, prec)
            out.update(label_numbers(cfg, probs, labels, kept))
        else:  # every detection the reference keeps is missing
            probs = label_probs(params, cfg, image, served.detections,
                                served.kept, prec)
            out.update(label_numbers(cfg, probs, torch.zeros_like(
                served.labels), served.kept))
    del probs
    again = unmold(cfg, det_np, kept_np, labels, raw.shape, window)
    mask = torch.from_numpy(np.ascontiguousarray(result["mask"])).to(device)
    diff = int((mask.to(torch.int16) != again["mask"]).sum()) \
        if tuple(mask.shape) == tuple(again["mask"].shape) else mask.numel()
    for key in ("rois", "scores"):
        a, b = np.asarray(result[key]), np.asarray(again[key])
        diff += int((a != b).sum()) if a.shape == b.shape else max(a.size,
                                                                   1)
    out["unmold_mismatch"] = float(diff)
    return out


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    readings = list(readings)
    return {k: max(r[k] for r in readings) for k in readings[0]}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, List[Dict]]:
    """(every limited number within its limit, [{name, value, limit}] in
    order: the limited numbers, then the others with limit None)."""
    rows = [{"name": k, "value": numbers[k], "limit": limits[k]}
            for k in NUMBERS if k in limits]
    rows += [{"name": k, "value": numbers[k], "limit": None}
             for k in NUMBERS if k not in limits]
    return all(r["value"] <= r["limit"] for r in rows
               if r["limit"] is not None), rows
