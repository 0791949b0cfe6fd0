"""Separable trilinear sampling and RoIAlign3D (port of
``cfun_tpu/ops/sample3d.py:112-148``).

Volumes are channel-first ``[C, D, H, W]`` (the port's layout).  RoIAlign
keeps the reference's semantics: the normalized box is denormalized to the
grid, floor/ceil'd to integers, and the crop is resampled with the
align-corners mapping (reference model.py:265-289).  Each axis becomes a
[points, size] linear-interpolation matrix, so a crop is three
contractions instead of eight 3D gathers.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cfun_tpu_torch.ops.boxes import device_constant


def _axis_weights(coords: torch.Tensor, size: int) -> torch.Tensor:
    """Interpolation matrices [..., m, size] for float coords [..., m]:
    row i holds (1-f) at floor(c_i) and f at floor(c_i)+1, clamped to the
    axis (edge rows collapse to a single 1)."""
    c = torch.clamp(coords, 0.0, size - 1.0)
    i0 = torch.floor(c).long()
    i1 = torch.clamp(i0 + 1, max=size - 1)
    f = (c - i0.float())[..., None]
    one_hot = torch.nn.functional.one_hot
    return (one_hot(i0, size).float() * (1.0 - f) +
            one_hot(i1, size).float() * f)


def separable_trilinear(vol: torch.Tensor, zc: torch.Tensor,
                        yc: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Trilinear resample of ``vol [C, D, H, W]`` on separable grids.

    zc/yc/xc: per-axis coordinate vectors [m] or batches of them [K, m].
    Returns [C, mz, my, mx] (or [K, C, mz, my, mx]) in ``vol``'s dtype;
    the contractions run in f32."""
    d, h, w = vol.shape[1:]
    wz = _axis_weights(zc, d)
    wy = _axis_weights(yc, h)
    wx = _axis_weights(xc, w)
    v = vol.float()
    if wz.dim() == 2:
        out = torch.einsum("zD,CDHW->CzHW", wz, v)
        out = torch.einsum("yH,CzHW->CzyW", wy, out)
        out = torch.einsum("xW,CzyW->Czyx", wx, out)
    else:
        out = torch.einsum("kzD,CDHW->kCzHW", wz, v)
        out = torch.einsum("kyH,kCzHW->kCzyW", wy, out)
        out = torch.einsum("kxW,kCzyW->kCzyx", wx, out)
    return out.to(vol.dtype)


def _align_corner_coords(lo: torch.Tensor, hi: torch.Tensor,
                         out_size: int) -> torch.Tensor:
    """Per-axis sample coords [K, out_size] of the reference RoIAlign:
    crop [lo, hi) integer bounds mapped onto ``out_size`` points with
    align-corners."""
    length = torch.clamp(hi - lo, min=1.0)
    step = (length - 1.0) / max(out_size - 1, 1)
    grid = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    return lo[:, None] + grid[None, :] * step[:, None]


def roi_align(vol: torch.Tensor, boxes: torch.Tensor,
              out_shape: Tuple[int, int, int]) -> torch.Tensor:
    """RoIAlign3D of ``vol [C, D, H, W]`` over [K, 6] normalized boxes ->
    [K, C, *out_shape]."""
    d, h, w = vol.shape[1:]
    scale = device_constant((d, h, w, d, h, w), torch.float32,
                            boxes.device)
    b = boxes.float() * scale
    lo = torch.floor(b[:, :3])
    hi = torch.ceil(b[:, 3:])
    coords = [_align_corner_coords(lo[:, a], hi[:, a], out_shape[a])
              for a in range(3)]
    return separable_trilinear(vol, *coords)


def crop_resize_align_corners(vol: torch.Tensor, box_norm: torch.Tensor,
                              out_shape: Tuple[int, int, int]
                              ) -> torch.Tensor:
    """RoIAlign3D for one normalized box [6] -> [C, *out_shape]."""
    return roi_align(vol, box_norm[None], out_shape)[0]
