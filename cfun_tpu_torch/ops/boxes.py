"""3D box arithmetic on tensors (port of ``cfun_tpu/ops/boxes.py:18-122``).

Boxes are ``(z1, y1, x1, z2, y2, x2)`` with the far corner outside the box.
The operation order follows the JAX functions term by term (volumes as
``(d * h) * w``, IoU as ``inter / ((v1 + v2 - inter) + eps)``), so the
f32 results agree bit for bit where both run the same IEEE operations.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# device_constant's tensors by (values, dtype, device): the config- and
# shape-derived constants of the served graph, a handful a configuration
_constants: Dict[Tuple, torch.Tensor] = {}


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and kept.  Building a small tensor from host
    values on a CUDA device is a copy from pageable memory, which waits for
    the device; the served graph makes none per request, so its launches
    do not wait on earlier work.  For values fixed by a configuration
    (its box std, its image shape), not per-request ones.  The tensor is
    shared: do not write to it."""
    device = torch.device(device)
    key = (tuple(float(v) for v in values), dtype, device)
    t = _constants.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.tensor(key[0], dtype=dtype, device=device)
        _constants[key] = t
    return t


def box_volume(boxes: torch.Tensor) -> torch.Tensor:
    """Volume of [..., 6] boxes."""
    d = boxes[..., 3] - boxes[..., 0]
    h = boxes[..., 4] - boxes[..., 1]
    w = boxes[..., 5] - boxes[..., 2]
    return d * h * w


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """IoU matrix [N, M] between [N, 6] and [M, 6] boxes; intersection
    edges clamp at 0, the union gets a +eps guard."""
    b1 = boxes1[:, None, :]
    b2 = boxes2[None, :, :]
    lo = torch.maximum(b1[..., :3], b2[..., :3])
    hi = torch.minimum(b1[..., 3:], b2[..., 3:])
    edge = torch.clamp(hi - lo, min=0.0)
    inter = edge[..., 0] * edge[..., 1] * edge[..., 2]
    union = box_volume(boxes1)[:, None] + box_volume(boxes2)[None, :] - inter
    return inter / (union + eps)


def apply_box_deltas(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply (dz, dy, dx, log dd, log dh, log dw) refinements."""
    size = boxes[..., 3:] - boxes[..., :3]
    center = boxes[..., :3] + 0.5 * size
    center = center + deltas[..., :3] * size
    size = size * torch.exp(deltas[..., 3:])
    lo = center - 0.5 * size
    hi = lo + size
    return torch.cat([lo, hi], dim=-1)


def clip_boxes(boxes: torch.Tensor, window) -> torch.Tensor:
    """Clamp box corners into ``window`` = (z1, y1, x1, z2, y2, x2)."""
    window = torch.as_tensor(window, dtype=boxes.dtype, device=boxes.device)
    lo = torch.minimum(torch.maximum(boxes[..., :3], window[:3]), window[3:])
    hi = torch.minimum(torch.maximum(boxes[..., 3:], window[:3]), window[3:])
    return torch.cat([lo, hi], dim=-1)


def _scale(volume_shape, like: torch.Tensor) -> torch.Tensor:
    d, h, w = volume_shape
    return device_constant((d, h, w, d, h, w), like.dtype, like.device)


def normalize_boxes(boxes: torch.Tensor, volume_shape) -> torch.Tensor:
    """Voxel -> [0, 1] coordinates; ``volume_shape`` = (D, H, W)."""
    return boxes / _scale(volume_shape, boxes)


def denormalize_boxes(boxes: torch.Tensor, volume_shape) -> torch.Tensor:
    """[0, 1] -> voxel coordinates; ``volume_shape`` = (D, H, W)."""
    return boxes * _scale(volume_shape, boxes)


def box_refinement(boxes: torch.Tensor, gt_boxes: torch.Tensor
                   ) -> torch.Tensor:
    """The deltas (dz, dy, dx, log dd, log dh, log dw) that turn ``boxes``
    into ``gt_boxes`` (reference utils.py:92-119).  Sizes are floored at
    1e-6, so zero-size padded rows give finite values that the callers'
    masks drop."""
    size = torch.clamp(boxes[..., 3:] - boxes[..., :3], min=1e-6)
    center = boxes[..., :3] + 0.5 * (boxes[..., 3:] - boxes[..., :3])
    gt_size = torch.clamp(gt_boxes[..., 3:] - gt_boxes[..., :3], min=1e-6)
    gt_center = gt_boxes[..., :3] + 0.5 * (gt_boxes[..., 3:]
                                           - gt_boxes[..., :3])
    d_center = (gt_center - center) / size
    d_size = torch.log(gt_size / size)
    return torch.cat([d_center, d_size], dim=-1)


def extend_box(box: torch.Tensor, volume_shape,
               frac: float = 0.05) -> torch.Tensor:
    """A [6] voxel box grown by ``frac`` of its size on each face, floored
    / ceiled to integers and clamped to the (D, H, W) volume (reference
    model.py:1059-1075)."""
    size = box[3:] - box[:3]
    lo = torch.floor(torch.clamp(box[:3] - frac * size, min=0.0))
    limit = torch.tensor(volume_shape, dtype=box.dtype, device=box.device)
    hi = torch.ceil(torch.minimum(box[3:] + frac * size, limit))
    return torch.cat([lo, hi])


def mask_to_bbox(mask: torch.Tensor) -> torch.Tensor:
    """Bounding box [6] f32 of the nonzero voxels of a [D, H, W] mask, far
    corner exclusive (reference ``extract_bboxes``, utils.py:20-47); zeros
    for an empty mask.  Fixed shapes, no host sync."""
    nz = mask > 0
    edges = []
    for flags in (nz.any(dim=2).any(dim=1), nz.any(dim=2).any(dim=0),
                  nz.any(dim=1).any(dim=0)):
        n = flags.shape[0]
        idx = torch.arange(n, device=mask.device)
        first = torch.where(flags, idx, torch.full_like(idx, n)).min()
        last = torch.where(flags, idx, torch.full_like(idx, -1)).max()
        edges.append((first, last))
    (z1, z2), (y1, y2), (x1, x2) = edges
    box = torch.stack([z1, y1, x1, z2 + 1, y2 + 1, x2 + 1]).float()
    return torch.where(nz.any(), box, torch.zeros_like(box))
