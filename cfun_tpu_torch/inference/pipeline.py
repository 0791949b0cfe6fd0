"""The detector: host mold -> device graph -> host unmold (port of
``cfun_tpu/inference/pipeline.py::Detector``: ``__init__``, ``detect`` and
``unmold``).

Output dict, as in the JAX package (reference model.py:1341-1389):
  rois      [N, (y1, x1, z1, y2, x2, z2)] in original voxel coords
  class_ids [num_classes - 1]
  scores    [N]
  mask      [H, W, D] int16 label volume at the original resolution

The mold is the JAX detector's NumPy path (resize + z-score + int8
quantization); the slab-streamed native molds and ``detect_stream`` are a
later slice.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from cfun_tpu_torch.config import Config
from cfun_tpu_torch.data.mold import (mold_volume, normalize_intensity,
                                      quantize_int8)
from cfun_tpu_torch.data.resample import resize, unmold_mask_labels
from cfun_tpu_torch.models import cfun
from cfun_tpu_torch.ops.anchors import config_anchors
from cfun_tpu_torch.weights import to_device


class Detector:
    """Single-volume heart detector over a port parameter tree
    (``weights.load_npz`` / ``weights.params_from_numpy``).

    ``device`` defaults to CUDA; pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the CPU.  There is no fallback: a
    CUDA device that is not there raises.
    """

    def __init__(self, cfg: Config, params, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Detector: no CUDA device (pass device='cpu' "
                               "to run on the CPU)")
        if cfun.uses_overlap_paste(cfg) or cfg.pad_shape is not None:
            raise NotImplementedError(
                "the port serves single-instance heart configs; LiTS and "
                "the multi-instance overlap unmold are later slices")
        self.cfg = cfg
        self.params = to_device(params, self.device)
        self.anchors = torch.from_numpy(config_anchors(cfg)).to(self.device)
        # fast path: one packed int8 buffer (4-bit labels) crosses to the
        # host instead of three arrays
        self._packed = cfg.fast_unmold and cfg.num_classes <= 16
        self.labels_shape = (cfg.detection_max_instances,
                              *(2 * p for p in cfg.mask_pool_size))
        self.pack_bits = 2 if cfg.num_classes <= 4 else 4
        self.last_timings: Dict[str, float] = {}

    def mold(self, image_hwd: np.ndarray):
        """Raw [H, W, D] volume -> (wire tensor [1, 1, D, H, W] on the
        device, window, original shape)."""
        cfg = self.cfg
        if image_hwd.ndim == 4:
            image_hwd = image_hwd[..., 0]
        molded, window = mold_volume(image_hwd, cfg)
        molded = normalize_intensity(molded)
        if cfg.wire_image_dtype == "int8":
            wire = torch.from_numpy(quantize_int8(molded,
                                                  cfg.wire_int8_scale))
        else:
            wire = torch.from_numpy(np.ascontiguousarray(molded)).to(
                torch.bfloat16)
        wire = wire.to(self.device)[None, None]
        return wire, window, image_hwd.shape[:3]

    @torch.inference_mode()
    def infer(self, wire: torch.Tensor, window: np.ndarray,
              nms: cfun.NmsFn = cfun.sorted_nms):
        """The device graph on a molded wire tensor: the packed int8 buffer
        on the fast path, else the :class:`cfun.InferOut`."""
        win = torch.as_tensor(window, dtype=torch.float32, device=self.device)
        out = cfun.infer_forward(self.params, wire, self.anchors, win,
                                 self.cfg, nms=nms)
        if self._packed:
            return cfun.pack_fast_output(out, bits=self.pack_bits)
        return out

    def detect(self, image_hwd: np.ndarray,
               timings: Optional[dict] = None) -> Dict[str, np.ndarray]:
        """image_hwd: [H, W, D] or [H, W, D, 1] raw volume."""
        t0 = time.perf_counter()
        wire, window, orig_shape = self.mold(image_hwd)
        t1 = time.perf_counter()
        out = self.infer(wire, window)
        if self._packed:
            buf = out.cpu().numpy()  # waits for the device
            t2 = time.perf_counter()
            detections, kept, masks = cfun.unpack_fast_output(
                buf, self.cfg.detection_max_instances, self.labels_shape,
                bits=self.pack_bits)
        else:
            detections = out.detections.cpu().numpy()
            t2 = time.perf_counter()
            kept = out.det_valid.cpu().numpy()
            if out.mask_labels is not None:  # fast path, unpacked
                masks = out.mask_labels.cpu().numpy()
            else:
                masks = out.mask_probs.float().cpu().numpy()
        result = self.unmold(detections, kept, masks, orig_shape, window)
        t3 = time.perf_counter()
        self.last_timings = {"mold": t1 - t0, "device": t2 - t1,
                             "unmold": t3 - t2, "total": t3 - t0}
        if timings is not None:
            timings.update(self.last_timings)
        return result

    def unmold(self, detections: np.ndarray, kept: np.ndarray,
               mask_data: np.ndarray, orig_shape_hwd,
               window: np.ndarray) -> Dict[str, np.ndarray]:
        """Reference unmold (model.py:1812-1864): scale boxes from the
        molded window back to original voxels, drop zero-volume boxes,
        paste the first detection's mask into its box.  ``mask_data`` is
        [N, 2m...] int8 labels (fast path) or the [N, m..., C] probability
        stack (exact path), told apart by rank."""
        cfg = self.cfg
        h0, w0, d0 = orig_shape_hwd[0], orig_shape_hwd[1], orig_shape_hwd[2]
        n = int(kept.sum())
        boxes = detections[:n, :6].astype(np.int64)
        scores = detections[:n, 7]

        win = np.asarray(window, np.float64)
        scales = np.array([d0 / (win[3] - win[0]),
                           h0 / (win[4] - win[1]),
                           w0 / (win[5] - win[2])])
        shifts = win[:3]
        boxes = ((boxes - np.concatenate([shifts, shifts]))
                 * np.concatenate([scales, scales])).astype(np.int64)

        volume = ((boxes[:, 3] - boxes[:, 0]) * (boxes[:, 4] - boxes[:, 1])
                  * (boxes[:, 5] - boxes[:, 2]))
        good = volume > 0
        boxes, scores = boxes[good], scores[good]
        masks = mask_data[:n][good]

        full = np.zeros((d0, h0, w0), np.int16)
        if boxes.shape[0] > 0:
            boxes = np.clip(boxes, 0, np.array([d0, h0, w0, d0, h0, w0]))
            z1, y1, x1, z2, y2, x2 = boxes[0]
            target = (max(z2 - z1, 1), max(y2 - y1, 1), max(x2 - x1, 1))
            if masks.ndim == 4:  # [N, d, h, w] int8 labels
                full[z1:z1 + target[0], y1:y1 + target[1],
                     x1:x1 + target[2]] = resize(masks[0], target, order=0)
            else:
                full = unmold_mask_labels(masks[0], boxes[0], (d0, h0, w0))

        # (z, y, x) -> (y, x, z) box order; [D, H, W] -> [H, W, D] volume
        return {
            "rois": boxes[:, [1, 2, 0, 4, 5, 3]],
            "class_ids": np.arange(1, cfg.num_classes),
            "scores": scores,
            "mask": full.transpose(1, 2, 0),
        }
