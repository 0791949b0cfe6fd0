"""Dense 3D anchor generation (a copy of ``cfun_tpu/ops/anchors.py``:
NumPy, kept here because the port imports nothing of the JAX package).

The anchor array is built once in NumPy at program-construction time and
uploaded once as a constant (the reference regenerates it as a
CUDA tensor at model build, model.py:1276-1284; semantics from
utils.py:467-528: cube anchors d = h = w = scale centered at
``cell_index * feature_stride`` with no half-cell offset).

DESIGN DEVIATION (deliberate, documented): the reference flattens anchors in
y-major order (an artifact of ``np.meshgrid``'s default 'xy' indexing,
utils.py:493) while its RPN head emits predictions in z-major (D, H, W)
order (model.py:727-729) -- a consistent but scrambled pairing the network
must learn around, breaking translation covariance.  We flatten anchors in
the same z-major (D, H, W, anchor) order the head uses, so prediction slot i
always corresponds to the anchor at the conv position that produced it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def generate_level_anchors(scale: float,
                           ratios: Sequence[float],
                           feature_shape: Tuple[int, int, int],
                           feature_stride: int,
                           anchor_stride: int = 1) -> np.ndarray:
    """Anchors for one pyramid level, z-major, [D*H*W*A, 6] float32.

    Cube anchors: the reference collapses ratios to d = h = w = scale
    (utils.py:485-487); we honor ratios as (h/w aspect in the transverse
    plane) when != 1 for forward-compatibility, which reduces to cubes for
    the reference's ratios = [1].
    """
    fd, fh, fw = feature_shape
    zs = np.arange(0, fd, anchor_stride, dtype=np.float32) * feature_stride
    ys = np.arange(0, fh, anchor_stride, dtype=np.float32) * feature_stride
    xs = np.arange(0, fw, anchor_stride, dtype=np.float32) * feature_stride

    sizes = []
    for r in ratios:
        h = scale * np.sqrt(r)
        w = scale / np.sqrt(r)
        sizes.append((scale, h, w))
    sizes = np.asarray(sizes, dtype=np.float32)  # [A, 3] (d, h, w)

    cz, cy, cx = np.meshgrid(zs, ys, xs, indexing="ij")  # each [fd, fh, fw]
    centers = np.stack([cz, cy, cx], axis=-1).reshape(-1, 1, 3)  # [DHW, 1, 3]
    half = 0.5 * sizes[None, :, :]  # [1, A, 3]
    boxes = np.concatenate(
        [centers - half + np.zeros_like(half), centers + half], axis=-1
    )  # [DHW, A, 6]
    return boxes.reshape(-1, 6).astype(np.float32)


def generate_pyramid_anchors(scales: Sequence[float],
                             ratios: Sequence[float],
                             feature_shapes: Sequence[Tuple[int, int, int]],
                             feature_strides: Sequence[int],
                             anchor_stride: int = 1) -> np.ndarray:
    """Concatenate per-level anchors, scale[i] <-> level i (utils.py:511-528)."""
    out = [
        generate_level_anchors(s, ratios, fs, st, anchor_stride)
        for s, fs, st in zip(scales, feature_shapes, feature_strides)
    ]
    return np.concatenate(out, axis=0)


def config_anchors(cfg) -> np.ndarray:
    """All anchors for a :class:`cfun_tpu_torch.config.Config`,
    [num_anchors, 6]."""
    return generate_pyramid_anchors(
        cfg.anchor_scales,
        cfg.anchor_ratios,
        cfg.backbone_feature_shapes,
        cfg.backbone_strides,
        cfg.anchor_stride,
    )
