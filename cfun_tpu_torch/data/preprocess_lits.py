"""Offline LiTS preprocessing: resample every volume to the dataset-mean
voxel spacing and cache as .npy (reference LiTS_2017/preprocessing.py:6-45;
the port's copy of ``cfun_tpu/data/preprocess_lits.py``, on the port's
``data/resample.py::resize``).

Images are linearly resampled (float32), labels nearest (int8).  Output
naming follows the reference cache layout so the CLI and dataset adapter can
consume either cache:

    <out>/image_np/liver_<i>.npy         (train images)
    <out>/label_np/liver_label_<i>.npy   (train labels)
    <out>/image_test_np/liver_<i>.npy    (test images)
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from cfun_tpu_torch.data import nifti
from cfun_tpu_torch.data.resample import resize

MEAN_SPACING = np.array([0.79272507, 0.79272507, 1.50625819])


def resample_to_mean_spacing(volume: np.ndarray, affine: np.ndarray,
                             order: int) -> np.ndarray:
    spacing = np.abs(np.array([affine[0, 0], affine[1, 1], affine[2, 2]]))
    shape = np.round(np.array(volume.shape[:3]) * spacing /
                     MEAN_SPACING).astype(np.int64)
    return resize(volume, tuple(shape), order=order)


def preprocess(data_dir: str, out_dir: str, n_train: int = 131,
               n_test: int = 70) -> None:
    os.makedirs(os.path.join(out_dir, "image_np"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "label_np"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "image_test_np"), exist_ok=True)

    for i in range(n_train):
        img_path = os.path.join(data_dir, "imagesTr", f"volume-{i}.nii.gz")
        lbl_path = os.path.join(data_dir, "labelsTr",
                                f"segmentation-{i}.nii.gz")
        if not os.path.exists(img_path):
            continue
        image, affine = nifti.load(img_path)
        label, _ = nifti.load(lbl_path)
        image = resample_to_mean_spacing(image.astype(np.float32), affine, 1)
        label = resample_to_mean_spacing(label, affine, 0)
        np.save(os.path.join(out_dir, "image_np", f"liver_{i}.npy"),
                image.astype(np.float32))
        np.save(os.path.join(out_dir, "label_np", f"liver_label_{i}.npy"),
                label.astype(np.int8))
        print(f"volume {i}: {image.shape}")

    for i in range(n_test):
        img_path = os.path.join(data_dir, "imagesTs",
                                f"test-volume-{i}.nii.gz")
        if not os.path.exists(img_path):
            continue
        image, affine = nifti.load(img_path)
        image = resample_to_mean_spacing(image.astype(np.float32), affine, 1)
        np.save(os.path.join(out_dir, "image_test_np", f"liver_{i}.npy"),
                image.astype(np.float32))
        print(f"test volume {i}: {image.shape}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="raw LiTS root")
    p.add_argument("--out", required=True, help="cache output root")
    args = p.parse_args()
    preprocess(args.data, args.out)
