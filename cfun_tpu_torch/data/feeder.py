"""Host-side training data (the port's copy of the NumPy parts of
``cfun_tpu/data/feeder.py``): the whole-organ GT box of a molded label
volume.  The threaded feeder itself is not ported yet."""

from __future__ import annotations

import numpy as np


def np_mask_to_extended_bbox(labels_dhw: np.ndarray, frac: float = 0.05
                             ) -> np.ndarray:
    """Whole-organ bbox of the nonzero labels of a [D, H, W] volume,
    extended by ``frac`` of its size per face, floored / ceiled and
    clamped to the volume (reference model.py:1057-1075).  Returns [6]
    float32 (z1, y1, x1, z2, y2, x2); zeros for an empty volume.

    Axis-wise ``any`` reductions give the same min / max as
    ``np.nonzero`` without its index arrays."""
    nz = labels_dhw > 0
    axes = [nz.any(axis=(1, 2)), nz.any(axis=(0, 2)), nz.any(axis=(0, 1))]
    if not bool(axes[0].any()):
        return np.zeros(6, np.float32)
    lo = np.array([int(a.argmax()) for a in axes], np.float64)
    hi = np.array([a.size - int(a[::-1].argmax()) for a in axes],
                  np.float64)
    size = hi - lo
    lo = np.floor(np.maximum(lo - frac * size, 0))
    hi = np.ceil(np.minimum(hi + frac * size, labels_dhw.shape))
    return np.concatenate([lo, hi]).astype(np.float32)
