"""Greedy 3D NMS over unsorted candidates, the gather of its picks
(port of ``cfun_tpu/ops/nms.py``), and the exact top-k that sorts the
NMS sites' input and the training samplers' draws.

``masked_nms`` takes scores and picks the best live candidate ``max_out``
times; on score-sorted input it keeps exactly what
``ops/sorted_nms.py::sorted_nms`` keeps, which is what the inference graph
runs.  It stays as the plain form for callers whose candidates are not
sorted.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cfun_tpu_torch.ops.boxes import pairwise_iou

_NEG = -1e30


def top_desc(scores: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k, lower index first on ties (``lax.top_k``'s order)."""
    values, order = torch.sort(scores, descending=True, stable=True)
    return values[:k], order[:k]


def masked_nms(boxes: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, iou_threshold: float,
               max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over [N, 6] boxes; invalid rows are never picked.

    Suppresses boxes with IoU > threshold (strict) against a pick.
    Returns (indices [max_out] int32, keep [max_out] bool); indices of
    un-kept slots are arbitrary.
    """
    n = boxes.shape[0]
    live = torch.where(valid, scores.float(),
                       torch.full_like(scores, _NEG, dtype=torch.float32))
    over = pairwise_iou(boxes.float(), boxes.float()) > torch.tensor(
        iou_threshold, dtype=torch.float32, device=boxes.device)
    arange = torch.arange(n, device=boxes.device)
    idx, keep = [], []
    for _ in range(max_out):
        i = torch.argmax(live)
        ok = live[i] > _NEG * 0.5
        suppress = over[i] | (arange == i)
        live = torch.where(ok & suppress, torch.full_like(live, _NEG), live)
        idx.append(i)
        keep.append(ok)
    return (torch.stack(idx).to(torch.int32), torch.stack(keep))


def nms_gather(boxes: torch.Tensor, idx: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
    """Gather picked boxes, zeroing un-kept slots."""
    out = boxes[idx.long()]
    return torch.where(keep[:, None], out, torch.zeros_like(out))
