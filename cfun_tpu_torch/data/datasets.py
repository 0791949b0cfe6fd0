"""Dataset registry and the MM-WHS / LiTS dataset adapters (the port's
copy of ``cfun_tpu/data/datasets.py``, NumPy only).

Mirrors the reference's registry surface (utils.py:181-315: add_class /
add_image / prepare / load_image / load_mask) on top of the self-contained
NIfTI reader.  HeartDataset semantics from heart_main.py:181-261: a
``dataset.json`` manifest ``{'train_and_test': [{'image': ..., 'label': ...}]}``,
val = first 13 volumes, train = the rest, 7 foreground classes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from cfun_tpu_torch.data import nifti


class Dataset:
    """Source/class/image bookkeeping with contiguous internal class ids."""

    def __init__(self):
        self.image_info: List[Dict] = []
        self.class_info: List[Dict] = [{"source": "", "id": 0, "name": "BG"}]

    def add_class(self, source: str, class_id: int, class_name: str) -> None:
        assert "." not in source, "Source name cannot contain a dot"
        for info in self.class_info:
            if info["source"] == source and info["id"] == class_id:
                return
        self.class_info.append(
            {"source": source, "id": class_id, "name": class_name})

    def add_image(self, source: str, image_id, path: str, **kwargs) -> None:
        info = {"id": image_id, "source": source, "path": path}
        info.update(kwargs)
        self.image_info.append(info)

    def prepare(self) -> None:
        self.num_classes = len(self.class_info)
        self.class_ids = np.arange(self.num_classes)
        self.class_names = [c["name"] for c in self.class_info]
        self.num_images = len(self.image_info)
        self.image_ids = np.arange(self.num_images)
        self.class_from_source_map = {
            f"{info['source']}.{info['id']}": cid
            for info, cid in zip(self.class_info, self.class_ids)
        }

    # ---- IO ----------------------------------------------------------------
    def load_image(self, image_id: int) -> np.ndarray:
        """[H, W, D, 1] float array."""
        data, _ = nifti.load(self.image_info[image_id]["path"])
        return np.expand_dims(data, -1)

    def load_mask(self, image_id: int) -> np.ndarray:
        """[H, W, D] integer label volume."""
        data, _ = nifti.load(self.image_info[image_id]["mask"])
        return np.asarray(data)

    def load_affine(self, image_id: int) -> np.ndarray:
        _, affine = nifti.load(self.image_info[image_id]["mask"])
        return affine


class HeartDataset(Dataset):
    """MM-WHS 2017 whole-heart dataset (heart_main.py:181-261)."""

    CLASS_NAMES = ("a", "b", "c", "d", "e", "f", "g")

    def load_heart(self, data_dir: str, subset: str,
                   val_size: int = 13) -> None:
        assert subset in ("train", "val", "all")
        for i, name in enumerate(self.CLASS_NAMES, start=1):
            self.add_class("heart", i, name)
        with open(os.path.join(data_dir, "dataset.json")) as f:
            info = list(json.load(f)["train_and_test"])
        if subset == "train":
            info = info[val_size:]
        elif subset == "val":
            info = info[:val_size]
        for item in info:
            self.add_image("heart", image_id=item["image"],
                           path=_resolve(data_dir, item["image"]),
                           mask=_resolve(data_dir, item["label"]))

    @staticmethod
    def process_mask(mask: np.ndarray, num_classes: int = 8):
        """Label volume -> per-class binary masks [C, D, H, W] + class ids
        (heart_main.py:226-238).  Retained for API parity; the device path
        one-hots labels on the fly instead."""
        masks = np.stack([(mask == i).astype(np.int32)
                          for i in range(num_classes)])
        return masks, np.arange(1, num_classes, dtype=np.int32)


class LiTSDataset(Dataset):
    """LiTS 2017 liver/tumor dataset over the preprocessed .npy cache
    (LiTS_2017/preprocessing.py + LiTS_main.py:183-260: spacing-resampled
    arrays under image_np/ and label_np/; split train = volumes 0..110,
    val = 111..130)."""

    def load_lits(self, data_dir: str, subset: str) -> None:
        assert subset in ("train", "val", "all")
        self.add_class("lits", 1, "liver")
        self.add_class("lits", 2, "tumor")
        ranges = {"train": range(0, 111), "val": range(111, 131),
                  "all": range(0, 131)}[subset]
        for i in ranges:
            img = os.path.join(data_dir, "image_np", f"liver_{i}.npy")
            lbl = os.path.join(data_dir, "label_np", f"liver_label_{i}.npy")
            if not os.path.exists(img):
                continue
            self.add_image("lits", image_id=i, path=img, mask=lbl)

    def load_image(self, image_id: int) -> np.ndarray:
        return np.expand_dims(
            np.load(self.image_info[image_id]["path"]), -1)

    def load_mask(self, image_id: int) -> np.ndarray:
        mask_path = self.image_info[image_id]["mask"]
        if mask_path is None:
            raise ValueError("no segmentation for this volume")
        return np.load(mask_path)

    def load_affine(self, image_id: int) -> np.ndarray:
        return np.eye(4)


class SyntheticDataset(Dataset):
    """In-memory volumes with an embedded multi-class organ blob, volume
    ``i`` from seed ``seed + i``: the JAX package's synthetic train and
    held-out sets (``SyntheticDataset(cfg, n=12, seed=3000,
    host_shape=(144, 144, 96), n_fg=7)`` is the heart held-out set of
    ``benchmarks/heart_synth_eval.py``)."""

    def __init__(self, cfg, n: int = 4, seed: int = 0,
                 host_shape=(48, 48, 24), n_fg: int = 3):
        super().__init__()
        self._volumes = []
        h, w, d = host_shape
        n_fg = min(cfg.num_classes - 1, n_fg)
        for i in range(n):
            rng = np.random.default_rng(seed + i)
            labels = np.zeros((h, w, d), np.int32)
            cy, cx, cz = (rng.integers(h // 3, 2 * h // 3),
                          rng.integers(w // 3, 2 * w // 3), d // 2)
            for cls in range(1, n_fg + 1):
                # nested ellipsoids, shrinking with class index
                frac = 1.0 - (cls - 1) / max(n_fg, 1) * 0.8
                r = max(2.0, (h // 4) * frac)
                rz = max(1.0, (d // 4) * frac)
                yy, xx, zz = np.ogrid[:h, :w, :d]
                ball = (((yy - cy) / r) ** 2 + ((xx - cx) / r) ** 2 +
                        ((zz - cz) / rz) ** 2) < 1.0
                labels[ball] = cls
            image = rng.normal(0.0, 1.0, size=(h, w, d)).astype(np.float32)
            image += 3.0 * (labels > 0)
            self._volumes.append((image, labels))
            self.add_image("synth", image_id=i, path=f"synth_{i}")
        for cls in range(1, cfg.num_classes):
            self.add_class("synth", cls, f"organ_{cls}")
        self.prepare()

    def load_image(self, image_id: int) -> np.ndarray:
        return np.expand_dims(self._volumes[image_id][0], -1)

    def load_mask(self, image_id: int) -> np.ndarray:
        return self._volumes[image_id][1]

    def load_affine(self, image_id: int) -> np.ndarray:
        return np.eye(4)


def _resolve(data_dir: str, path: str) -> str:
    """Manifest paths may be absolute or data_dir-relative."""
    if os.path.isabs(path) and os.path.exists(path):
        return path
    cand = os.path.join(data_dir, path)
    if os.path.exists(cand):
        return cand
    return os.path.join(data_dir, os.path.basename(path))
