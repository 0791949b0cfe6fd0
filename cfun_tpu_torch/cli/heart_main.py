"""Whole-heart (MM-WHS 2017) train / test / submit CLI of the port.

The port's copy of ``cfun_tpu/cli/heart_main.py``, with the same argparse
surface (the reference's heart_main.py:367-446) and one option more,
``--device``:

    python -m cfun_tpu_torch.cli.heart_main train --weights none \
        --stage beginning --data /path/to/data/ [--epochs 10 --workers 8]
    python -m cfun_tpu_torch.cli.heart_main test --weights ckpt.npz \
        --stage finetune --data /path/to/data/ [--limit 5 --save true]
    python -m cfun_tpu_torch.cli.heart_main submit --weights ckpt.npz \
        --stage beginning --data /path/to/data/ [--limit 5]

``train`` runs ``train/loop.py::train_model`` on ``heart_config(stage)``
over the manifest's volumes (the first 13 validate, the rest train),
from a checkpoint (the port's or the JAX package's ``.npz``, which resumes
the optimizer and the epoch count, or a reference PyTorch checkpoint) or
from seeded random weights ('none'), writing ``train_metrics.jsonl`` and
``model.npz`` under ``--logs``.  ``--aug-device`` rotates and targets on
the device; ``--device-cache`` (with it) keeps the molds in device memory.
``--mesh DATA[,SPACE]`` trains on DATA x SPACE ranks (one card a rank on
CUDA, gloo processes with ``--device cpu``; fewer cards than ranks stop
with an error).

``test`` runs the full inference stack on labeled volumes, reports per-class
mask IoU (and Dice -- the paper's headline metric) plus per-volume latency,
and optionally exports predicted label volumes as .nii.gz with the GT affine
into ./results (heart_main.py:286-360).  ``submit`` exports the labels of
every manifest image through ``Detector.detect_stream``.

Every command runs on CUDA unless ``--device cpu`` is given; without a
card it stops with an error.  ``--weights`` takes the JAX package's
``.npz`` checkpoints or a reference PyTorch checkpoint (told apart by
content).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def draw_bbox_wireframe(mask: np.ndarray, roi, value: int = 10) -> None:
    """Draw the detection box edges into the mask in-place
    (heart_main.py:335-348).  roi: (y1, x1, z1, y2, x2, z2)."""
    y1, x1, z1, y2, x2, z2 = [int(v) for v in roi]
    h, w, d = mask.shape
    y1, y2 = np.clip([y1, y2], 0, h - 1)
    x1, x2 = np.clip([x1, x2], 0, w - 1)
    z1, z2 = np.clip([z1, z2], 0, d - 1)
    for y in (y1, y2):
        for z in (z1, z2):
            mask[y, x1:x2, z] = value
    for x in (x1, x2):
        for z in (z1, z2):
            mask[y1:y2, x, z] = value
    for y in (y1, y2):
        for x in (x1, x2):
            mask[y, x, z1:z2] = value


def _manifest(data_dir: str):
    import json

    with open(os.path.join(data_dir, "dataset.json")) as f:
        return list(json.load(f)["train_and_test"])


def run_test(cfg, params, data_dir: str, limit: int, save: bool,
             bbox: bool, results_dir: str = "./results", device="cuda",
             native: bool = True, span_log=None):
    """Detect, score and (``save``) export the first ``limit`` manifest
    volumes.  Returns (per-class IoU [n, C-1], per-class Dice [n, C-1]).
    ``span_log`` (a ``SpanLog``) turns the detector's spans on."""
    from cfun_tpu_torch.data import nifti
    from cfun_tpu_torch.data.datasets import _resolve
    from cfun_tpu_torch.inference import Detector
    from cfun_tpu_torch.utils.metrics import per_class_dice, per_class_mask_iou

    detector = Detector(cfg, params, device=device, native=native)
    detector.spans.log = span_log
    info = _manifest(data_dir)

    per_class_ious, per_class_dices = [], []
    detect_time = 0.0
    for item in info[:limit]:
        image, _ = nifti.load(_resolve(data_dir, item["image"]))
        label, affine = nifti.load(_resolve(data_dir, item["label"]))
        t0 = time.time()
        result = detector.detect(image.astype(np.float32))
        dt = time.time() - t0
        detect_time += dt
        print(f"detect_time: {dt:.3f}s  breakdown: "
              f"{ {k: round(v, 3) for k, v in detector.last_timings.items()} }")

        mask = result["mask"]
        iou = per_class_mask_iou(label, mask, cfg.num_classes)
        dice = per_class_dice(label, mask, cfg.num_classes)
        per_class_ious.append(iou)
        per_class_dices.append(dice)
        name = os.path.basename(item["image"])
        print(f"{name} detected done. iou = {iou}")

        if save:
            if bbox and result["rois"].shape[0] > 0:
                draw_bbox_wireframe(mask, result["rois"][0])
            os.makedirs(results_dir, exist_ok=True)
            nifti.save(os.path.join(
                results_dir, f"{iou.mean():.4f}_{name}"),
                mask.astype(np.int32), affine)

    per_class_ious = np.array(per_class_ious)
    per_class_dices = np.array(per_class_dices)
    print("Test completed.")
    print("per class iou mean:", per_class_ious.mean(axis=0))
    print("std:", per_class_ious.std(axis=0))
    print("Total ious mean:", per_class_ious.mean())
    print("per class dice mean:", per_class_dices.mean(axis=0))
    print("Total dice mean:", per_class_dices.mean())
    print("Total detect time:", detect_time)
    return per_class_ious, per_class_dices


def run_submit(cfg, params, data_dir: str, limit: int,
               results_dir: str = "./results/heart_submissions",
               device="cuda", native: bool = True,
               span_log=None) -> float:
    """Export predicted label volumes for the first ``limit`` manifest
    images (no labels needed) -- the heart-variant counterpart of LiTS
    `submit` (the reference only ships it for LiTS, LiTS_main.py:370-394).
    Returns the sustained seconds a volume.  ``span_log`` (a ``SpanLog``)
    turns the detector's spans on."""
    from cfun_tpu_torch.data import nifti
    from cfun_tpu_torch.data.datasets import _resolve
    from cfun_tpu_torch.inference import Detector

    detector = Detector(cfg, params, device=device, native=native)
    detector.spans.log = span_log
    info = _manifest(data_dir)
    os.makedirs(results_dir, exist_ok=True)
    items = info[:limit]
    affines = []

    def volumes():
        for item in items:
            image, affine = nifti.load(_resolve(data_dir, item["image"]))
            affines.append(affine)
            yield image.astype(np.float32)

    # pipelined: volume N+1 loads + molds while N runs on the device and
    # N-1 is fetched + unmolded on detect_stream's worker thread
    t0 = time.time()
    try:
        for item, result in zip(items, detector.detect_stream(volumes())):
            name = os.path.basename(item["image"])
            print(f"{name} predicted ({time.time() - t0:.3f}s elapsed)")
            nifti.save(os.path.join(results_dir, name),
                       result["mask"].astype(np.int32), affines.pop(0))
    finally:
        detector.close()
    total = time.time() - t0
    per_volume = total / max(len(items), 1)
    print(f"prediction completed: {len(items)} volumes in {total:.3f}s "
          f"({per_volume:.3f}s/volume sustained)")
    return per_volume


def main(argv=None):
    """Parse ``argv`` and run the command.  Returns what its
    ``train_model`` (the final checkpoint's path) / ``run_test`` /
    ``run_submit`` returns."""
    parser = argparse.ArgumentParser(
        description="Train and test the CFUN whole-heart pipeline on "
                    "PyTorch + CUDA.")
    parser.add_argument("command", metavar="<command>",
                        help="'train', 'test' or 'submit'")
    parser.add_argument("--weights", required=True,
                        help="Path to a .npz or reference PyTorch "
                             "checkpoint, or 'none'")
    parser.add_argument("--stage", required=True,
                        choices=["beginning", "finetune"])
    parser.add_argument("--logs", default="./logs/")
    parser.add_argument("--data", required=True)
    parser.add_argument("--limit", default=5, type=int)
    parser.add_argument("--save", default="true")
    parser.add_argument("--bbox", default="false")
    parser.add_argument("--epochs", default=None, type=int)
    parser.add_argument("--workers", default=8, type=int)
    parser.add_argument("--mesh", default=None, metavar="DATA[,SPACE]",
                        help="train over DATA x SPACE ranks: DATA volumes "
                             "a step, each volume's mask U-Net split along "
                             "D over SPACE ranks (with shard_unet_spatial); "
                             "one card a rank on CUDA (NCCL), gloo "
                             "processes with --device cpu")
    parser.add_argument("--aug-device", action="store_true",
                        help="train: rotation, GT box and RPN targets on "
                             "the device")
    parser.add_argument("--device-cache", action="store_true",
                        help="train (with --aug-device): keep the molded "
                             "volumes in device memory across epochs")
    parser.add_argument("--exact", action="store_true",
                        help="disable every wire/unmold approximation "
                             "(bf16 wire, host normalization, "
                             "probability-stack unmold) for "
                             "reference-exact numerics at latency cost")
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="capture a torch.profiler host + device trace "
                             "into DIR (TensorBoard/Perfetto-compatible), "
                             "with each request's stages as named spans")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu' (the kernels' "
                             "plain PyTorch versions)")
    args = parser.parse_args(argv)

    import contextlib

    from cfun_tpu_torch.cli import (inference_params, require_device,
                                    require_mesh)
    from cfun_tpu_torch.config import (exact_reference_overrides,
                                       heart_config, heart_inference_config)
    from cfun_tpu_torch.utils.profiling import SpanLog, device_trace

    if args.command not in ("train", "test", "submit"):
        parser.error(f"'{args.command}' is not recognized. "
                     "Use 'train', 'test' or 'submit'")
    trace_ctx = (device_trace(args.trace) if args.trace
                 else contextlib.nullcontext())
    if args.command == "train":
        if args.device_cache and not args.aug_device:
            # the device mold cache holds angle-independent molds, which
            # only exist when the rotation happens on the device
            raise SystemExit("--device-cache requires --aug-device")
        require_device(parser, args.device)
        mesh = require_mesh(parser, args.mesh, args.device)
        cfg = heart_config(args.stage)
        if args.aug_device:
            cfg = cfg.replace(augment_on_device=True,
                              device_mold_cache=args.device_cache)
        from cfun_tpu_torch.data.datasets import HeartDataset
        from cfun_tpu_torch.train.loop import train_model

        train_ds = HeartDataset()
        train_ds.load_heart(args.data, "train")
        train_ds.prepare()
        val_ds = HeartDataset()
        val_ds.load_heart(args.data, "val")
        val_ds.prepare()
        print(cfg.describe())
        print("Training...")
        with trace_ctx:
            return train_model(cfg, train_ds, val_ds, log_dir=args.logs,
                               weights=args.weights, epochs=args.epochs,
                               num_workers=args.workers, mesh_spec=mesh,
                               device=args.device)
    require_device(parser, args.device)
    overrides = exact_reference_overrides() if args.exact else {}
    cfg = heart_inference_config(args.stage, **overrides)
    params = inference_params(cfg, args.weights)
    # under --trace the detector's spans name each request's stages
    span_log = SpanLog() if args.trace else None
    if args.command == "test":
        print("Testing..." + (" (exact reference mode)" if args.exact
                              else ""))
        with trace_ctx:
            return run_test(cfg, params, args.data, args.limit,
                            args.save.lower() == "true",
                            args.bbox.lower() == "true", device=args.device,
                            span_log=span_log)
    print("Predicting...")
    with trace_ctx:
        return run_submit(cfg, params, args.data, args.limit,
                          device=args.device, span_log=span_log)


if __name__ == "__main__":
    main()
