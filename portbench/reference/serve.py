"""The plain reference of a whole served request: the raw [H, W, D]
volume molded to the wire as the configuration states it (the heart's
trilinear resize quantized to int8 against the statistics of a strided
sample and z-scored again; LiTS' inverted HU window, virtual centre-pad
and nearest resize, quantized to int8 with a fixed affine), the graph of
``reference/model.py``, and the unmold back to the raw geometry (boxes
scaled out of the molded window, the heart's label crop pasted nearest
into its box, LiTS' molded label volume mapped back through nearest
index maps).  Plain PyTorch on the device it is given.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference.model import RefConfig

CLIP_SIGMA = 5.0      # the int8 wire clips the z-scored heart volume here
STATS_STRIDE = 523    # the heart wire's statistics: every 523rd raw voxel


def _linear_axis(n_out: int, n_in: int, device):
    """Half-pixel source coordinates in float32, edge-clamped: (i0, i1,
    frac) of each output index."""
    scale = np.float32(n_in) / np.float32(n_out)
    s = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * scale \
        - np.float32(0.5)
    s = np.clip(s, np.float32(0), np.float32(n_in - 1))
    i0 = s.astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = s - i0.astype(np.float32)
    return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
            torch.from_numpy(frac).to(device))


def sample_stats(raw: np.ndarray):
    """(mean, 1 / std) of every ``STATS_STRIDE``-th voxel, sums in
    float64."""
    flat = raw.reshape(-1)[::STATS_STRIDE].astype(np.float64)
    mean = flat.sum() / flat.size
    var = (flat * flat).sum() / flat.size - mean * mean
    std = np.float32(np.sqrt(var if var >= 1e-12 else 1.0))
    return np.float32(mean), np.float32(1.0 / max(float(std), 1e-6))


def mold_heart(cfg: RefConfig, raw: np.ndarray, device) -> torch.Tensor:
    """The heart's wire: trilinear resize of [H, W, D] to the molded
    (D, H, W), z-scored with the sample's statistics, clipped at +-5,
    times the int8 scale, truncated to int8 -> [D, H, W] int8."""
    dt, ht, wt = cfg.image_shape
    h0, w0, d0 = raw.shape
    mean, inv_std = sample_stats(raw)
    src = torch.from_numpy(raw).to(device)
    z0, z1, fz = _linear_axis(dt, d0, device)
    y0, y1, fy = _linear_axis(ht, h0, device)
    x0, x1, fx = _linear_axis(wt, w0, device)
    a = src[:, :, z0]
    a = a + fz * (src[:, :, z1] - a)
    b = a[:, x0]
    b = b + fx[:, None] * (a[:, x1] - b)
    c = b[y0]
    c = c + fy[:, None, None] * (b[y1] - c)
    v = torch.clamp((c - float(mean)) * float(inv_std), -CLIP_SIGMA,
                    CLIP_SIGMA) * np.float32(cfg.wire_int8_scale)
    return torch.trunc(v).to(torch.int8).permute(2, 0, 1).contiguous()


def pad_offsets(shape_hwd, pad_dhw):
    h0, w0, d0 = shape_hwd
    pd, ph, pw = pad_dhw
    return (max(0, (ph - h0) // 2), max(0, (pw - w0) // 2),
            max(0, (pd - d0) // 2))


def _pad_axis(n_out, n_pad, n_src, off, device):
    s = np.clip((np.arange(n_out, dtype=np.float64) + 0.5) * (n_pad / n_out)
                - 0.5, 0, n_pad - 1)
    p = np.floor(s + 0.5).astype(np.int64) - off
    valid = (p >= 0) & (p < n_src)
    return (torch.from_numpy(np.clip(p, 0, n_src - 1)).to(device),
            torch.from_numpy(valid).to(device))


def mold_lits(cfg: RefConfig, raw: np.ndarray, device) -> torch.Tensor:
    """LiTS' wire: the inverted HU window to [0, 1], a virtual centre-pad
    to the pad shape (pad voxels 0) and a nearest resize, times the int8
    scale, truncated -> [D, H, W] int8."""
    dt, ht, wt = cfg.image_shape
    pd, ph, pw = cfg.pad_shape
    h0, w0, d0 = raw.shape
    oh, ow, od = pad_offsets(raw.shape, cfg.pad_shape)
    yi, vy = _pad_axis(ht, ph, h0, oh, device)
    xi, vx = _pad_axis(wt, pw, w0, ow, device)
    zi, vz = _pad_axis(dt, pd, d0, od, device)
    mn, mx = cfg.hu_window
    inv = np.float32(1.0) / (np.float32(mx) - np.float32(mn))
    src = torch.from_numpy(raw).to(device)
    v = src[yi][:, xi][:, :, zi]
    v = torch.clamp((v - float(mn)) * float(inv), 0.0, 1.0) * np.float32(
        cfg.wire_int8_scale)
    v = v * (vy[:, None, None] & vx[None, :, None] & vz[None, None, :])
    return torch.trunc(v).to(torch.int8).permute(2, 0, 1).contiguous()


def window_of(cfg: RefConfig, shape_hwd) -> np.ndarray:
    """The raw volume's place in the molded one (z1, y1, x1, z2, y2, x2)."""
    d_t, h_t, w_t = cfg.image_shape
    if cfg.pad_shape is None:
        return np.array([0, 0, 0, d_t, h_t, w_t], np.float32)
    h0, w0, d0 = shape_hwd
    pd, ph, pw = cfg.pad_shape
    oh, ow, od = pad_offsets(shape_hwd, cfg.pad_shape)
    sh, sw, sd = h_t / ph, w_t / pw, d_t / pd
    return np.array([od * sd, oh * sh, ow * sw, (od + d0) * sd,
                     (oh + h0) * sh, (ow + w0) * sw], np.float32)


def molded_image(cfg: RefConfig, raw: np.ndarray, device) -> torch.Tensor:
    """The wire as the device reads it, in float32: [1, 1, D, H, W]."""
    mold = mold_lits if cfg.pad_shape is not None else mold_heart
    x = mold(cfg, raw, device).float() * np.float32(
        1.0 / cfg.wire_int8_scale)
    if cfg.device_normalize:
        mean = x.mean()
        var = torch.clamp((x * x).mean() - mean * mean, min=1e-12)
        x = (x - mean) * torch.rsqrt(var)
    return x[None, None]


def _nearest(n_in, n_out, device):
    if n_in == n_out:
        return torch.arange(n_out, device=device)
    s = np.clip((np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out
                - 0.5, 0, n_in - 1)
    return torch.from_numpy(np.floor(s + 0.5).astype(np.int64)).to(device)


def unmold(cfg: RefConfig, det: np.ndarray, kept: np.ndarray, labels,
           shape_hwd, window: np.ndarray) -> Dict:
    """Boxes scaled from the molded window back to raw voxels (truncated,
    zero-volume boxes dropped), the labels to the raw [H, W, D] int16
    volume (on ``labels``' device)."""
    h0, w0, d0 = shape_hwd
    device = labels.device
    n = int(kept.sum())
    boxes = det[:n, :6].astype(np.int64)
    scores = det[:n, 7]
    win = np.asarray(window, np.float64)
    scales = np.array([d0 / (win[3] - win[0]), h0 / (win[4] - win[1]),
                       w0 / (win[5] - win[2])])
    boxes = ((boxes - np.concatenate([win[:3], win[:3]]))
             * np.concatenate([scales, scales])).astype(np.int64)
    vol = ((boxes[:, 3] - boxes[:, 0]) * (boxes[:, 4] - boxes[:, 1])
           * (boxes[:, 5] - boxes[:, 2]))
    good = vol > 0
    boxes, scores = boxes[good], scores[good]
    boxes = np.clip(boxes, 0, np.array([d0, h0, w0, d0, h0, w0]))
    if labels.dim() == 3:  # the molded label volume of the overlap paste
        dt, ht, wt = cfg.image_shape
        if cfg.pad_shape is not None:
            pd, ph, pw = cfg.pad_shape
            oh, ow, od = pad_offsets(shape_hwd, cfg.pad_shape)
        else:
            pd, ph, pw, oh, ow, od = d0, h0, w0, 0, 0, 0

        def inv(n_src, n_pad, n_out, off):
            s = np.clip((np.arange(n_src) + off + 0.5) * n_out / n_pad - 0.5,
                        0, n_out - 1)
            return torch.from_numpy(np.floor(s + 0.5).astype(np.int64)).to(
                device)

        full = labels[inv(d0, pd, dt, od)][:, inv(h0, ph, ht, oh)][
            :, :, inv(w0, pw, wt, ow)].permute(1, 2, 0).to(torch.int16)
    else:
        full = torch.zeros((d0, h0, w0), dtype=torch.int16, device=device)
        if boxes.shape[0] > 0:
            lab = labels[:n][torch.from_numpy(good).to(device)][0]
            z1, y1, x1, z2, y2, x2 = (int(v) for v in boxes[0])
            if z1 < d0 and y1 < h0 and x1 < w0:
                td, th, tw = max(z2 - z1, 1), max(y2 - y1, 1), max(x2 - x1, 1)
                md, mh, mw = lab.shape
                full[z1:z1 + td, y1:y1 + th, x1:x1 + tw] = lab[
                    _nearest(md, td, device)][:, _nearest(mh, th, device)][
                    :, :, _nearest(mw, tw, device)].to(torch.int16)
        full = full.permute(1, 2, 0)
    return {"rois": boxes[:, [1, 2, 0, 4, 5, 3]], "scores": scores,
            "mask": full}
