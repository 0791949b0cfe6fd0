"""Trilinear / nearest sampling, RoIAlign3D, half-pixel crop-resizes and
the GT-mask crop (port of ``cfun_tpu/ops/sample3d.py``).

Volumes are channel-first ``[C, D, H, W]`` (the port's layout).  RoIAlign
keeps the reference's semantics: the normalized box is denormalized to the
grid, floor/ceil'd to integers, and the crop is resampled with the
align-corners mapping (reference model.py:265-289).  Each axis becomes a
[points, size] linear-interpolation matrix, so a crop is three
contractions instead of eight 3D gathers.  The GT-mask crop takes the
reference's truncated-int box and skimage order=0 resize
(model.py:481-493): the half-pixel map ``lo + (i + 0.5) * L / P - 0.5``,
rounded half up.  Coordinates are clamped, so a box out of range degrades
instead of raising.
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


def _flat_gather(vol: torch.Tensor, zi: torch.Tensor, yi: torch.Tensor,
                 xi: torch.Tensor) -> torch.Tensor:
    """``vol[:, zi, yi, xi]`` for broadcastable int index tensors ->
    [C, *broadcast shape]."""
    c, d, h, w = vol.shape
    idx = (zi * h + yi) * w + xi
    return vol.reshape(c, d * h * w)[:, idx.reshape(-1)].reshape(
        c, *idx.shape)


def trilinear_sample(vol: torch.Tensor, z: torch.Tensor, y: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of ``vol [C, D, H, W]`` at float voxel coordinates
    (broadcastable tensors), clamped to the volume -> [C, *shape]."""
    z, y, x = torch.broadcast_tensors(z, y, x)
    d, h, w = vol.shape[1:]
    z = torch.clamp(z, 0.0, d - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x = torch.clamp(x, 0.0, w - 1.0)
    z0, y0, x0 = (torch.floor(v).long() for v in (z, y, x))
    z1 = torch.clamp(z0 + 1, max=d - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fz, fy, fx = ((v - v0).to(vol.dtype) for v, v0 in ((z, z0), (y, y0),
                                                          (x, x0)))
    c00 = _flat_gather(vol, z0, y0, x0) * (1 - fx) + \
        _flat_gather(vol, z0, y0, x1) * fx
    c01 = _flat_gather(vol, z0, y1, x0) * (1 - fx) + \
        _flat_gather(vol, z0, y1, x1) * fx
    c10 = _flat_gather(vol, z1, y0, x0) * (1 - fx) + \
        _flat_gather(vol, z1, y0, x1) * fx
    c11 = _flat_gather(vol, z1, y1, x0) * (1 - fx) + \
        _flat_gather(vol, z1, y1, x1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def nearest_sample(vol: torch.Tensor, z: torch.Tensor, y: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Nearest sample of ``vol [C, D, H, W]`` at float voxel coordinates
    (broadcastable tensors), rounded half up as ``floor(c + 0.5)`` and
    clamped to the volume -> [C, *shape]."""
    d, h, w = vol.shape[1:]
    zi = torch.clamp(torch.floor(z + 0.5).long(), 0, d - 1)
    yi = torch.clamp(torch.floor(y + 0.5).long(), 0, h - 1)
    xi = torch.clamp(torch.floor(x + 0.5).long(), 0, w - 1)
    return _flat_gather(vol, zi, yi, xi)


def _halfpix_coords(lo: torch.Tensor, hi: torch.Tensor,
                    out_size: int) -> torch.Tensor:
    """skimage / ``align_corners=False`` coordinates [K, out_size] of the
    crops [lo, hi) resized to ``out_size`` samples, clamped inside each
    crop (skimage's edge mode)."""
    i = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    lo, hi = lo[:, None], hi[:, None]
    c = lo + (i + 0.5) * (hi - lo) / out_size - 0.5
    return torch.minimum(torch.maximum(c, lo),
                         torch.maximum(hi - 1, lo))


def crop_resize_halfpix(vol: torch.Tensor, box_vox: torch.Tensor,
                        out_shape: Tuple[int, int, int],
                        method: str = "nearest") -> torch.Tensor:
    """Crop ``vol [C, D, H, W]`` to ``box_vox`` (voxel coordinates, [6] or
    [K, 6], truncated toward zero like the reference's ``int()`` casts,
    model.py:483-488) and resize it with the half-pixel convention:
    'nearest' (skimage order=0; a gather, exact on integer labels) or
    'trilinear' (``F.interpolate(align_corners=False)``).  Returns
    [C, *out_shape] (or [K, C, *out_shape])."""
    single = box_vox.dim() == 1
    boxes = box_vox.reshape(-1, 6)
    lo = torch.trunc(boxes[:, :3]).float()
    hi = torch.trunc(boxes[:, 3:]).float()
    zc, yc, xc = (_halfpix_coords(lo[:, a], hi[:, a], out_shape[a])
                  for a in range(3))
    if method == "nearest":
        out = nearest_sample(vol, zc[:, :, None, None], yc[:, None, :, None],
                             xc[:, None, None, :]).transpose(0, 1)
    elif method == "trilinear":
        out = separable_trilinear(vol, zc, yc, xc)
    else:
        raise ValueError(f"method must be 'nearest' or 'trilinear', got "
                         f"{method!r}")
    return out[0] if single else out


def resize_trilinear(vol: torch.Tensor,
                     out_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Whole-volume trilinear resize of ``vol [C, D, H, W]``, half-pixel
    convention (the device-side form of the reference's skimage 'self'
    mold resize, utils.py:389-393)."""
    d, h, w = vol.shape[1:]
    box = torch.tensor([0.0, 0.0, 0.0, d, h, w], device=vol.device)
    return crop_resize_halfpix(vol, box, out_shape, method="trilinear")


def one_hot_crop(labels: torch.Tensor, box_norm: torch.Tensor,
                 out_shape: Tuple[int, int, int],
                 num_classes: int) -> torch.Tensor:
    """Crop an integer label volume [D, H, W] to a normalized box ([6] or
    [K, 6]), nearest-resize it to ``out_shape`` and one-hot it, channels
    first: [num_classes, *out_shape] (or [K, ...]) float32, the layout of
    the mask logits.  The reference crops and resizes the per-class GT
    mask stack on the host (model.py:481-493); this crops the one label
    volume and one-hots the crop."""
    d, h, w = labels.shape
    scale = device_constant((d, h, w, d, h, w), torch.float32,
                            labels.device)
    crop = crop_resize_halfpix(labels[None].to(torch.int32),
                               box_norm.float() * scale, out_shape,
                               method="nearest")
    classes = torch.arange(num_classes, dtype=torch.int32,
                           device=labels.device)
    # [.., 1, m...] == [C, 1, 1, 1]: the one-hot made channels first, with
    # no int64 [.., m..., C] intermediate
    return (crop == classes[:, None, None, None]).float()
