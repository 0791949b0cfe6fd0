"""Host-side separable volume resampling (NumPy; a copy of the parts of
``cfun_tpu/data/resample.py`` the port's detector uses).

Axis-separable linear / nearest interpolation with the half-pixel
convention ``src = (i + 0.5) * L_in / L_out - 0.5`` and no anti-aliasing,
equivalent to ``skimage.transform.resize(order<=1, anti_aliasing=False)``
(the reference's molding, utils.py:318-408).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _axis_indices(n_in: int, n_out: int, order: int):
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5
    src = np.clip(src, 0, n_in - 1)
    if order == 0:
        i0 = np.floor(src + 0.5).astype(np.int64)
        return i0, None, None
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = (src - i0).astype(np.float32)
    return i0, i1, frac


def _resize_axis(vol: np.ndarray, n_out: int, axis: int,
                 order: int) -> np.ndarray:
    n_in = vol.shape[axis]
    if n_in == n_out:
        return vol
    i0, i1, frac = _axis_indices(n_in, n_out, order)
    a0 = np.take(vol, i0, axis=axis)
    if order == 0:
        return a0
    a1 = np.take(vol, i1, axis=axis)
    shape = [1] * vol.ndim
    shape[axis] = n_out
    f = frac.reshape(shape)
    return a0 * (1.0 - f) + a1 * f


def resize(vol: np.ndarray, out_shape: Tuple[int, ...],
           order: int = 1) -> np.ndarray:
    """Resize the leading len(out_shape) axes; trailing axes untouched.

    order: 0 (nearest, for labels) or 1 (linear, for images).  Axes go
    biggest shrink first (ties: innermost axis first), which is faster
    and, by separability, gives the same result as any other order.
    """
    out = vol.astype(np.float32) if order == 1 else vol
    axes = sorted(range(len(out_shape)),
                  key=lambda a: (out_shape[a] / vol.shape[a], -a))
    for axis in axes:
        out = _resize_axis(out, out_shape[axis], axis, order)
    return out


def unmold_mask_labels(crop_probs: np.ndarray, box: np.ndarray,
                       out_shape: Tuple[int, int, int]) -> np.ndarray:
    """Trilinear-resize a [d, h, w, C] probability crop into integer
    ``box`` and argmax it, in a zero [*out_shape] int16 label volume (the
    reference's paste-then-argmax, utils.py:443-460 + model.py:1856-1858:
    background wins outside the box either way)."""
    z1, y1, x1, z2, y2, x2 = [int(v) for v in box]
    target = (max(z2 - z1, 1), max(y2 - y1, 1), max(x2 - x1, 1))
    resized = resize(crop_probs, target, order=1)
    labels = np.argmax(resized, axis=-1).astype(np.int16)
    full = np.zeros(out_shape, np.int16)
    full[z1:z1 + target[0], y1:y1 + target[1], x1:x1 + target[2]] = labels
    return full
