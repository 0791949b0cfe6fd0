"""Host-side separable volume resampling (NumPy; a copy of the parts of
``cfun_tpu/data/resample.py`` the port's detector uses: the heart's
trilinear resize, the LiTS virtual-pad nearest mold, the overlap-tile
unmold of the exact path, and the train feeder's slice rotation).

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


def pad_resize_nearest(vol_hwd: np.ndarray, pad_shape_hwd: Tuple[int, int, int],
                       out_shape_hwd: Tuple[int, int, int],
                       offsets_hwd: Tuple[int, int, int]) -> np.ndarray:
    """Nearest-resize from a *virtually* center-padded volume.

    Equivalent to ``resize(zero_pad(vol), out_shape, order=0)`` (the LiTS
    molding, LiTS_2017/model.py:1154-1233) without materializing the pad
    buffer (0.9 GB at PAD_IMAGE_SHAPE [646, 646, 536]): each output index
    maps through pad space to a source index, out-of-source voxels become 0.
    Nearest interpolation never mixes pad and interior values, so the
    result is bit-identical to the pad-then-resize path.
    """
    h0, w0, d0 = vol_hwd.shape[:3]

    def ax(n_out: int, n_pad: int, n_src: int, off: int):
        s = np.clip((np.arange(n_out, dtype=np.float64) + 0.5) * n_pad /
                    n_out - 0.5, 0, n_pad - 1)
        p = np.floor(s + 0.5).astype(np.int64) - off
        valid = (p >= 0) & (p < n_src)
        return np.clip(p, 0, n_src - 1), valid

    (ph, pw, pd), (ht, wt, dt) = pad_shape_hwd, out_shape_hwd
    oh, ow, od = offsets_hwd
    iy, vy = ax(ht, ph, h0, oh)
    ix, vx = ax(wt, pw, w0, ow)
    iz, vz = ax(dt, pd, d0, od)
    out = vol_hwd[np.ix_(iy, ix, iz)].copy()
    out[~vy] = 0
    out[:, ~vx] = 0
    out[:, :, ~vz] = 0
    return out


_ROTATE_GRID_CACHE: dict = {}


def _rotate_grid(h: int, w: int):
    """The float32 (y, x) index grids of an [h, w] slice (cached)."""
    key = (h, w)
    if key not in _ROTATE_GRID_CACHE:
        if len(_ROTATE_GRID_CACHE) > 8:
            _ROTATE_GRID_CACHE.clear()
        _ROTATE_GRID_CACHE[key] = np.meshgrid(
            np.arange(h, dtype=np.float32),
            np.arange(w, dtype=np.float32), indexing="ij")
    return _ROTATE_GRID_CACHE[key]


def rotate_hw(vol: np.ndarray, angle_deg: float, order: int = 0) -> np.ndarray:
    """Rotate every [H, W] slice about the slice centre (the reference's
    slice-wise imgaug Affine augmentation, model.py:1019-1052), constant-0
    fill.  vol: [H, W, ...]; the rotation acts on axes (0, 1).  ``order``
    0 is nearest with round-half-to-even, 1 bilinear."""
    if angle_deg == 0:
        return vol
    h, w = vol.shape[:2]
    theta = np.deg2rad(angle_deg)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = _rotate_grid(h, w)
    # inverse mapping: output (y, x) samples the input rotated by -theta
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    ys = cos_t * (yy - cy) - sin_t * (xx - cx) + cy
    xs = sin_t * (yy - cy) + cos_t * (xx - cx) + cx
    inside = (ys >= -0.5) & (ys <= h - 0.5) & (xs >= -0.5) & (xs <= w - 0.5)
    if order == 0:
        yi = np.clip(np.round(ys).astype(np.int64), 0, h - 1)
        xi = np.clip(np.round(xs).astype(np.int64), 0, w - 1)
        out = vol[yi, xi]
    else:
        y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        fy = np.clip(ys, 0, h - 1) - y0
        fx = np.clip(xs, 0, w - 1) - x0
        if vol.ndim > 2:
            fy, fx = fy[..., None], fx[..., None]
        v00 = vol[y0, x0].astype(np.float32)
        v01 = vol[y0, x1].astype(np.float32)
        v10 = vol[y1, x0].astype(np.float32)
        v11 = vol[y1, x1].astype(np.float32)
        out = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
               v10 * fy * (1 - fx) + v11 * fy * fx)
    mask = inside if vol.ndim == 2 else inside[..., None]
    return np.where(mask, out, 0).astype(vol.dtype)


def trilinear_into_box(crop: np.ndarray, box: np.ndarray,
                       out_shape: Tuple[int, int, int]) -> np.ndarray:
    """Resize a [d, h, w, C] crop into integer ``box`` of a zero
    [*out_shape, C] volume with half-pixel trilinear mapping -- the
    reference's mask unmold (utils.py:443-460) without the GPU round-trip.
    """
    z1, y1, x1, z2, y2, x2 = [int(v) for v in box]
    target = (max(z2 - z1, 1), max(y2 - y1, 1), max(x2 - x1, 1))
    resized = resize(crop, target, order=1)
    full = np.zeros((*out_shape, crop.shape[-1]), np.float32)
    full[z1:z1 + target[0], y1:y1 + target[1], x1:x1 + target[2]] = resized
    return full


def unmold_overlap_labels(crop_probs: np.ndarray, boxes: np.ndarray,
                          out_shape: Tuple[int, int, int]) -> np.ndarray:
    """Overlap-tile mask unmold (LiTS variant, LiTS_2017/utils.py:383-408):
    every detection's probability stack is resized into its box, overlapping
    voxels are averaged by hit count, then argmax'd to labels.

    crop_probs: [N, mD, mH, mW, C]; boxes: [N, 6] integer voxel coords.
    Accumulation happens only inside the union bounding box, so the full
    [D, H, W, C] float stack the reference allocates is avoided.
    """
    n = boxes.shape[0]
    if n == 0:
        return np.zeros(out_shape, np.int16)
    boxes = boxes.astype(np.int64)
    lo = np.maximum(boxes[:, :3].min(axis=0), 0)
    hi = np.minimum(boxes[:, 3:].max(axis=0), np.asarray(out_shape))
    usize = np.maximum(hi - lo, 1)
    c = crop_probs.shape[-1]
    acc = np.zeros((*usize, c), np.float32)
    cnt = np.zeros(tuple(usize), np.float32)
    for i in range(n):
        z1, y1, x1, z2, y2, x2 = boxes[i]
        target = (max(z2 - z1, 1), max(y2 - y1, 1), max(x2 - x1, 1))
        resized = resize(crop_probs[i], target, order=1)
        sl = (slice(z1 - lo[0], z1 - lo[0] + target[0]),
              slice(y1 - lo[1], y1 - lo[1] + target[1]),
              slice(x1 - lo[2], x1 - lo[2] + target[2]))
        acc[sl] += resized
        cnt[sl] += 1.0
    acc /= (cnt[..., None] + 1e-6)
    labels = np.argmax(acc.clip(0.0, 1.0), axis=-1).astype(np.int16)
    full = np.zeros(out_shape, np.int16)
    full[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = \
        labels[:hi[0] - lo[0], :hi[1] - lo[1], :hi[2] - lo[2]]
    return full


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
