"""Host molding of a raw heart volume (NumPy; the heart branch of
``cfun_tpu/data/feeder.py::mold_volume`` and ``normalize_intensity``, and
the wire quantization of ``cfun_tpu/inference/pipeline.py::Detector._mold``).

Heart molding (reference utils.py:389-393 + model.py:1902-1904): trilinear
'self' resize of the [H, W, D] volume to the config's (H, W, D), then a
whole-volume z-score.  ``Detector(..., native=False)`` molds with these;
by default it takes the native ops of ``native.py``.
"""

from __future__ import annotations

import numpy as np

from cfun_tpu_torch.config import Config
from cfun_tpu_torch.data.resample import resize


def normalize_intensity(image: np.ndarray) -> np.ndarray:
    """Whole-volume z-score (the heart's 'zscore' normalization)."""
    image = image.astype(np.float32)
    std = image.std()
    return (image - image.mean()) / (std if std > 0 else 1.0)


def mold_volume(image_hwd: np.ndarray, cfg: Config):
    """[H, W, D(, 1)] raw volume -> ([D, H, W] float32 resized volume,
    window [6] = the full molded volume).  Heart configs only."""
    if cfg.pad_shape is not None or cfg.intensity_norm != "zscore":
        raise NotImplementedError(
            "the port molds heart volumes only (LiTS pad-then-resize "
            "molding is a later slice)")
    if image_hwd.ndim == 4:
        image_hwd = image_hwd[..., 0]
    d_t, h_t, w_t = cfg.image_shape
    molded = resize(image_hwd.astype(np.float32), (h_t, w_t, d_t), order=1)
    window = np.array([0, 0, 0, d_t, h_t, w_t], np.float32)
    return molded.transpose(2, 0, 1), window


def quantize_int8(molded: np.ndarray, scale: float) -> np.ndarray:
    """The int8 wire: clip the z-scored volume to +-5 sigma and scale."""
    return (np.clip(molded, -5.0, 5.0) * scale).astype(np.int8)
