"""Host molding of a raw volume (NumPy; the port's copy of
``cfun_tpu/data/feeder.py::mold_volume`` and ``normalize_intensity``, and
of the wire quantization of
``cfun_tpu/inference/pipeline.py::Detector._mold``).

Heart molding (reference utils.py:389-393 + model.py:1902-1904): trilinear
'self' resize of the [H, W, D] volume to the config's (H, W, D), then a
whole-volume z-score.  LiTS molding (LiTS_2017/model.py:1154-1233 +
1875-1886): the inverted HU window to [0, 1], a centre-pad to
``cfg.pad_shape`` and a nearest resize to the config's shape; the pad is
virtual (``resample.pad_resize_nearest``).  ``Detector(..., native=False)``
molds with these; by default it takes the native ops of ``native.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from cfun_tpu_torch.config import Config
from cfun_tpu_torch.data.resample import pad_resize_nearest, resize


def normalize_intensity(image: np.ndarray,
                        cfg: Optional[Config] = None) -> np.ndarray:
    """'zscore' (heart, model.py:1902-1904; also without a ``cfg``) or the
    LiTS inverted HU window ``clip((x - 300) / -600, 0, 1)``
    (LiTS_2017/model.py:1875-1886: the reference's MIN/MAX bounds are
    swapped, and kept so)."""
    image = image.astype(np.float32)
    if cfg is not None and cfg.intensity_norm == "hu_window":
        mn, mx = cfg.hu_window  # (300, -300): inverted on purpose
        out = (image - mn) / (mx - mn)
        return np.clip(out, 0.0, 1.0)
    std = image.std()
    return (image - image.mean()) / (std if std > 0 else 1.0)


def pad_offsets(src_hwd, pad_shape_dhw) -> Tuple[int, int, int]:
    """(oh, ow, od): where a raw [H, W, D] volume sits in the centre-pad
    target.  A source larger than the pad on an axis gets offset 0 there
    and its extra voxels are cropped by the nearest map."""
    h0, w0, d0 = src_hwd[:3]
    pd, ph, pw = pad_shape_dhw
    return (max(0, (ph - h0) // 2), max(0, (pw - w0) // 2),
            max(0, (pd - d0) // 2))


def lits_window(src_hwd, cfg: Config) -> np.ndarray:
    """Voxel coordinates (z1, y1, x1, z2, y2, x2) of the raw volume inside
    the molded one, from the pad offsets (fractional)."""
    h0, w0, d0 = src_hwd[:3]
    d_t, h_t, w_t = cfg.image_shape
    pd, ph, pw = cfg.pad_shape
    oh, ow, od = pad_offsets(src_hwd, cfg.pad_shape)
    sh, sw, sd = h_t / ph, w_t / pw, d_t / pd
    return np.array([od * sd, oh * sh, ow * sw,
                     (od + d0) * sd, (oh + h0) * sh, (ow + w0) * sw],
                    np.float32)


def mold_volume(image_hwd: np.ndarray, cfg: Config):
    """[H, W, D(, 1)] raw volume -> ([D, H, W] float32 molded volume,
    window [6] = voxel coordinates of the raw volume in it).

    Heart: the trilinear resize (not yet normalized: see
    ``normalize_intensity``), window = the full volume.  LiTS: HU window,
    virtual centre-pad, nearest resize (already in [0, 1])."""
    if image_hwd.ndim == 4:
        image_hwd = image_hwd[..., 0]
    d_t, h_t, w_t = cfg.image_shape
    if cfg.pad_shape is not None:
        pd, ph, pw = cfg.pad_shape
        normed = normalize_intensity(image_hwd, cfg)
        molded = pad_resize_nearest(
            normed, (ph, pw, pd), (h_t, w_t, d_t),
            pad_offsets(image_hwd.shape, cfg.pad_shape))
        return molded.transpose(2, 0, 1), lits_window(image_hwd.shape, cfg)
    molded = resize(image_hwd.astype(np.float32), (h_t, w_t, d_t), order=1)
    window = np.array([0, 0, 0, d_t, h_t, w_t], np.float32)
    return molded.transpose(2, 0, 1), window


def quantize_int8(molded: np.ndarray, scale: float) -> np.ndarray:
    """The int8 wire: clip to +-5 (the z-scored heart volume's +-5 sigma; a
    no-op on LiTS' [0, 1]), times ``scale`` (25.4 heart, 127 LiTS),
    truncated toward zero by ``astype``."""
    return (np.clip(molded, -5.0, 5.0) * scale).astype(np.int8)
