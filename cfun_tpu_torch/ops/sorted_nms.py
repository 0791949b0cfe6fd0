"""Greedy 3D NMS over score-sorted boxes: the CUDA kernel and its plain
PyTorch version.

Port of ``cfun_tpu/ops/pallas_nms.py::pallas_sorted_nms`` (the Pallas TPU
kernel ``_nms_kernel`` and the compaction after it).  The kernel is
``csrc/sorted_nms.cu``, built by ``_build.py`` and bound with ctypes; its
header comment gives the design.  ``sorted_nms`` launches it for CUDA
tensors and uses ``sorted_nms_reference`` only for CPU tensors.
"""

from __future__ import annotations

import collections
from typing import Dict, Tuple

import torch

from cfun_tpu_torch.ops.boxes import pairwise_iou

# Kernel launches made by ``sorted_nms`` (one per call on a CUDA tensor),
# and the same launches by shape (N, max_out); chip_smoke.py resets and
# reads them around the served requests.
launches = 0
launch_shapes: collections.Counter = collections.Counter()
# the kernel's workspace by (device index, stream, N); see _workspace
_workspaces: Dict[Tuple[int, int, int], torch.Tensor] = {}


def sorted_nms_reference(boxes: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float, max_out: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on the inputs' device.

    boxes: [N, 6] f32 sorted by descending score; valid: [N] bool.
    Returns (idx [max_out] int32, keep [max_out] bool): the kept positions
    in score order, unfilled slots idx 0 / keep False.
    """
    n = boxes.shape[0]
    device = boxes.device
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=device)
    over = (pairwise_iou(boxes.float(), boxes.float()) > thr).cpu()
    suppressed = ~valid.cpu()
    keep_vec = torch.zeros(n, dtype=torch.bool)
    count = 0
    for i in range(n):
        if count == max_out:
            break
        if not bool(suppressed[i]):
            keep_vec[i] = True
            suppressed |= over[i]
            count += 1
    # cumsum-scatter compaction (pallas_nms.py:113-122)
    pos = torch.cumsum(keep_vec.to(torch.int64), 0) - 1
    slot = torch.where(keep_vec & (pos < max_out), pos,
                       torch.full_like(pos, max_out))
    idx = torch.zeros(max_out + 1, dtype=torch.int32)
    idx[slot] = torch.arange(n, dtype=torch.int32)
    keep = torch.arange(max_out) < count
    return idx[:max_out].to(device), keep.to(device)


def _check(boxes: torch.Tensor, valid: torch.Tensor, max_out: int) -> None:
    if boxes.dim() != 2 or boxes.shape[1] != 6:
        raise ValueError(f"boxes must be [N, 6], got {tuple(boxes.shape)}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if valid.shape != (boxes.shape[0],) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool [{boxes.shape[0]}], got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if valid.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device}, valid on {valid.device}")
    if max_out < 1:
        raise ValueError(f"max_out must be >= 1, got {max_out}")


def _workspace(lib, n: int, device: torch.device, stream: int
               ) -> torch.Tensor:
    """The kernel's workspace for N boxes on ``stream``: its tiles, valid
    words and the ticket that picks the sweeping block, zeroed once and
    held for the process.  The kernel resets the ticket itself, so calls
    in one stream's order (or replays of a CUDA graph captured on it)
    share it; another stream gets its own."""
    key = (device.index, stream, n)
    ws = _workspaces.get(key)
    if ws is None:
        if n > lib.cfun_sorted_nms_max_n():
            raise ValueError(f"the sorted_nms kernel takes N <= "
                             f"{lib.cfun_sorted_nms_max_n()}, got {n}")
        ws = torch.zeros(lib.cfun_sorted_nms_workspace_bytes(n),
                         dtype=torch.uint8, device=device)
        _workspaces[key] = ws
    return ws


def sorted_nms(boxes: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float, max_out: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over score-descending [N, 6] boxes; see
    :func:`sorted_nms_reference` for the contract.  CUDA tensors go to the
    kernel (N <= 4096, one launch), CPU tensors to the plain version."""
    global launches
    _check(boxes, valid, max_out)
    device = boxes.device
    if device.type == "cpu":
        return sorted_nms_reference(boxes, valid, iou_threshold, max_out)
    if device.type != "cuda":
        raise ValueError(f"sorted_nms runs on CPU or CUDA, got {device}")
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return sorted_nms(boxes, valid, iou_threshold, max_out)
    from cfun_tpu_torch import _build

    lib = _build.library()
    n = boxes.shape[0]
    boxes = boxes.contiguous()
    valid = valid.contiguous()
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    ws = _workspace(lib, n, device, stream)
    idx = torch.empty(max_out, dtype=torch.int32, device=device)
    keep = torch.empty(max_out, dtype=torch.bool, device=device)
    err = lib.cfun_sorted_nms(boxes.data_ptr(), valid.data_ptr(), n,
                              iou_threshold, max_out, ws.data_ptr(),
                              idx.data_ptr(), keep.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sorted_nms kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    launch_shapes[(n, max_out)] += 1
    return idx, keep
