"""Liver/tumor (LiTS 2017) preprocess / test / submit CLI of the port.

The port's copy of ``cfun_tpu/cli/lits_main.py``, with the same argparse
surface (the reference's LiTS_2017/LiTS_main.py:401-487, plus the
``preprocess`` command that builds the spacing-resampled .npy cache) and
one option more, ``--device``:

    python -m cfun_tpu_torch.cli.lits_main preprocess --data /raw/LiTS \
        --out /cache
    python -m cfun_tpu_torch.cli.lits_main test --weights ckpt.npz \
        --stage finetune --data /cache/ [--limit 111]
    python -m cfun_tpu_torch.cli.lits_main submit --weights ckpt.npz \
        --data /cache/

``test`` reports box IoU vs the extended GT box in every stage and
per-class mask IoU after 'beginning' (LiTS_main.py:285-367), over the
cached volumes from index ``--limit`` on; ``submit`` exports test-set
segmentations resized to the original NIfTI geometry (LiTS_main.py:
370-394).  Both run on CUDA unless ``--device cpu`` is given; without a
card the command stops with an error.  ``train`` is not ported yet and
stops with an error.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _gt_extended_box_yxz(label_hwd: np.ndarray) -> np.ndarray:
    """Whole-region bbox in (y1, x1, z1, y2, x2, z2) order, extended 5%
    (LiTS_2017/utils.py:20-46 + 124-144 operate in [H, W, D] layout)."""
    nz = np.nonzero(label_hwd > 0)
    if nz[0].size == 0:
        return np.zeros(6, np.int64)
    lo = np.array([a.min() for a in nz], np.float64)
    hi = np.array([a.max() + 1 for a in nz], np.float64)
    size = hi - lo
    lo = np.floor(np.maximum(lo - 0.05 * size, 0))
    hi = np.ceil(np.minimum(hi + 0.05 * size, label_hwd.shape))
    return np.concatenate([lo, hi]).astype(np.int64)


def _box_iou(a: np.ndarray, b: np.ndarray) -> float:
    lo = np.maximum(a[:3], b[:3])
    hi = np.minimum(a[3:], b[3:])
    inter = np.prod(np.maximum(hi - lo, 0.0))
    va = np.prod(a[3:] - a[:3])
    vb = np.prod(b[3:] - b[:3])
    return float(inter / (va + vb - inter + 1e-6))


def run_test(cfg, params, data_dir: str, limit: int, save: bool, bbox: bool,
             results_dir: str = "./results/lits", device="cuda",
             native: bool = True):
    """Detect, score and (``save``) export every cached volume from index
    ``limit`` on.  A volume whose detection fails is reported and skipped
    (LiTS_main.py:354-356).  Returns (box IoUs, per-class IoUs), one entry
    a volume with a detection / a volume scored."""
    from cfun_tpu_torch.data import nifti
    from cfun_tpu_torch.inference import Detector
    from cfun_tpu_torch.utils.metrics import per_class_mask_iou

    detector = Detector(cfg, params, device=device, native=native)
    per_class_ious, box_ious = [], []
    detect_time = 0.0
    os.makedirs(results_dir, exist_ok=True)
    for i in range(limit, 131):
        img_path = os.path.join(data_dir, "image_np", f"liver_{i}.npy")
        lbl_path = os.path.join(data_dir, "label_np", f"liver_label_{i}.npy")
        if not os.path.exists(img_path):
            continue
        image = np.load(img_path).astype(np.float32)
        label = np.load(lbl_path).astype(np.int32)
        gt_box = _gt_extended_box_yxz(label)

        t0 = time.time()
        try:
            result = detector.detect(image)
        except Exception as e:  # per-volume resilience (LiTS_main.py:354-356)
            print(f"liver_{i} detect error: {e!r}")
            continue
        dt = time.time() - t0
        detect_time += dt
        print(f"liver_{i} detect_time: {dt:.3f}s")

        rois = np.clip(result["rois"], 0, None).astype(np.int64)
        mask = result["mask"]
        if cfg.stage == "beginning":
            mask = np.zeros_like(mask)
        if rois.shape[0] > 0:
            box_ious.append(_box_iou(gt_box.astype(np.float64),
                                     rois[0].astype(np.float64)))
        if cfg.stage != "beginning":
            iou = per_class_mask_iou(label, mask, cfg.num_classes)
            per_class_ious.append(iou)
            print(f"  iou = {iou}")
        if save:
            if bbox:
                for j in range(rois.shape[0]):
                    y1, x1, z1, y2, x2, z2 = rois[j]
                    mask[y1:y2, x1:x2, z1:z2] = 100
            tag = (f"{per_class_ious[-1].mean():.4f}" if per_class_ious
                   else f"{box_ious[-1] if box_ious else 0:.4f}")
            nifti.save(os.path.join(results_dir, f"{tag}_liver_{i}.nii.gz"),
                       mask.astype(np.uint8))

    print("Test completed.")
    if box_ious:
        print("box iou mean:", np.mean(box_ious))
    if per_class_ious:
        arr = np.array(per_class_ious)
        print("per class iou mean:", arr.mean(axis=0), "std:", arr.std(axis=0))
        print("Total ious mean:", arr.mean())
    print("Total detect time:", detect_time)
    return box_ious, per_class_ious


def run_submit(cfg, params, data_dir: str, start: int = 0,
               results_dir: str = "./results/submissions", device="cuda",
               native: bool = True) -> float:
    """Predict the 70 LiTS test volumes and export original-geometry .nii
    (LiTS_main.py:370-394).  Returns the sustained seconds a volume."""
    from cfun_tpu_torch.data import nifti
    from cfun_tpu_torch.data.resample import resize
    from cfun_tpu_torch.inference import Detector

    detector = Detector(cfg, params, device=device, native=native)
    os.makedirs(results_dir, exist_ok=True)
    present = [i for i in range(start, 70) if os.path.exists(
        os.path.join(data_dir, "image_test_np", f"liver_{i}.npy"))]
    geoms = []

    def volumes():
        for i in present:
            image = np.load(os.path.join(data_dir, "image_test_np",
                                         f"liver_{i}.npy")).astype(np.float32)
            raw_path = os.path.join(data_dir, "imagesTs",
                                    f"test-volume-{i}.nii.gz")
            if os.path.exists(raw_path):
                raw, affine = nifti.load(raw_path)
                geoms.append((affine, raw.shape[:3]))
            else:
                geoms.append((np.eye(4), image.shape))
            yield image

    # pipelined: volume N+1 loads + molds while N runs on the device and
    # N-1 is fetched + unmolded on detect_stream's worker thread
    t0 = time.time()
    try:
        for i, result in zip(present, detector.detect_stream(volumes())):
            print(f"processing {i} ({time.time() - t0:.3f}s elapsed)")
            affine, ori_shape = geoms.pop(0)
            mask = resize(result["mask"], tuple(ori_shape), order=0)
            nifti.save(os.path.join(results_dir,
                                    f"test-segmentation-{i}.nii"),
                       mask.astype(np.uint8), affine)
    finally:
        detector.close()
    total = time.time() - t0
    per_volume = total / max(len(present), 1)
    print(f"prediction completed: {len(present)} volumes in {total:.3f}s "
          f"({per_volume:.3f}s/volume sustained)")
    return per_volume


def main(argv=None):
    """Parse ``argv`` and run the command.  Returns what its
    ``run_test`` / ``run_submit`` returns (None for ``preprocess``)."""
    parser = argparse.ArgumentParser(
        description="Test the CFUN liver/tumor pipeline on PyTorch + CUDA.")
    parser.add_argument("command", metavar="<command>",
                        help="'test', 'submit' or 'preprocess' ('train' "
                             "is not ported)")
    parser.add_argument("--weights", default="none")
    parser.add_argument("--stage", default="beginning",
                        choices=["beginning", "together", "finetune"])
    parser.add_argument("--logs", default="./logs/")
    parser.add_argument("--data", default="../")
    parser.add_argument("--out", default=None, help="preprocess output dir")
    parser.add_argument("--limit", default=111, type=int,
                        help="test: the first cached volume index")
    parser.add_argument("--save", default="true")
    parser.add_argument("--bbox", default="false")
    parser.add_argument("--epochs", default=None, type=int)
    parser.add_argument("--workers", default=8, type=int)
    parser.add_argument("--mesh", default=None, metavar="DATA[,SPACE]",
                        help="train over a device mesh (training is not "
                             "ported)")
    parser.add_argument("--exact", action="store_true",
                        help="disable every wire/unmold approximation for "
                             "reference-exact numerics at latency cost")
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="capture a torch.profiler host + device trace "
                             "into DIR")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu' (the kernels' "
                             "plain PyTorch versions)")
    args = parser.parse_args(argv)

    if args.command == "preprocess":
        from cfun_tpu_torch.data.preprocess_lits import preprocess
        preprocess(args.data, args.out or args.data)
        return None

    import contextlib

    from cfun_tpu_torch.cli import (inference_params, require_device,
                                    train_not_ported)
    from cfun_tpu_torch.config import (exact_reference_overrides,
                                       lits_inference_config)
    from cfun_tpu_torch.utils.profiling import device_trace

    if args.command == "train":
        train_not_ported(parser, "lits_main")
    if args.command not in ("test", "submit"):
        parser.error(f"'{args.command}' is not recognized.")
    require_device(parser, args.device)
    overrides = exact_reference_overrides() if args.exact else {}
    cfg = lits_inference_config(args.stage, **overrides)
    params = inference_params(cfg, args.weights)
    trace_ctx = (device_trace(args.trace) if args.trace
                 else contextlib.nullcontext())
    if args.command == "test":
        print("Testing..." + (" (exact reference mode)" if args.exact else ""))
        with trace_ctx:
            return run_test(cfg, params, args.data, args.limit,
                            args.save.lower() == "true",
                            args.bbox.lower() == "true", device=args.device)
    print("Predicting...")
    with trace_ctx:
        return run_submit(cfg, params, args.data, device=args.device)


if __name__ == "__main__":
    main()
