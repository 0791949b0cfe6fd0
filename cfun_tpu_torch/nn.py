"""Layer functions over channel-first tensors (port of ``cfun_tpu/nn.py``).

Parameters are plain dicts of tensors, as in the JAX package, with PyTorch
layouts: conv weights ``[C_out, C_in, kd, kh, kw]``, linear weights
``[out, in]`` (``weights.py`` converts).  Convolutions cast their input and
weights to ``dtype`` (bfloat16 for the heart model) and go to
``F.conv3d``: XLA generated them outside any Pallas kernel.

The JAX package's ``conv3d_stem_s2d`` and the ``_conv1ch_s1`` custom VJP
are workarounds for the TPU's lane padding of 1-channel tensors; they
compute the same map as a plain stride-2 conv and a plain 1-channel conv,
which is what the port runs.  ``upsample2_conv`` and
``upsample2_conv_residual`` are likewise computed as a nearest upsample
followed by the conv (the same maps as the JAX package's phase-decomposed
forms, up to reassociation).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Params = dict


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[C] -> [1, C, 1, 1, 1] for a channel-first 5D ``x``."""
    return v.reshape(1, -1, *([1] * (x.dim() - 2)))


def conv3d(p: Params, x: torch.Tensor, stride=1,
           dtype=torch.float32) -> torch.Tensor:
    """3D conv over [N, C, D, H, W] with 'torch' padding: symmetric
    (k-1)//2 per axis."""
    w = p["w"]
    pads = tuple((k - 1) // 2 for k in w.shape[2:])
    b = p.get("b")
    return F.conv3d(x.to(dtype), w.to(dtype),
                    None if b is None else b.to(dtype),
                    stride=stride, padding=pads)


def conv3d_1ch(p: Params, x: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """Stride-1 conv over a 1-channel volume (the U-Net's first layer)."""
    return conv3d(p, x, dtype=dtype)


def linear(p: Params, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return F.linear(x.to(dtype), p["w"].to(dtype), p["b"].to(dtype))


def frozen_bn(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode batch norm: affine transform with stored statistics
    (scale and shift formed in f32, applied in ``x``'s dtype)."""
    inv = torch.rsqrt(p["var"].float() + eps)
    scale = (p["scale"] * inv).to(x.dtype)
    shift = (p["bias"] - p["mean"] * p["scale"] * inv).to(x.dtype)
    return x * _bcast(scale, x) + _bcast(shift, x)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free instance norm over the spatial dims; statistics in
    f32, the normalization applied in ``x``'s dtype."""
    dims = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=dims, keepdim=True, dtype=torch.float32)
    diff = x - mean.to(x.dtype)
    var = torch.mean(torch.square(diff), dim=dims, keepdim=True,
                     dtype=torch.float32)
    return diff * torch.rsqrt(var + eps).to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    return F.max_pool3d(x, window, stride)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest upsampling of [N, C, D, H, W] by an integer factor."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def upsample2_conv(p: Params, x: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """``conv3d(p, upsample_nearest(x))`` for a 3^3 kernel (the U-Net
    decoder's up-conv)."""
    if tuple(p["w"].shape[2:]) != (3, 3, 3):
        raise ValueError(f"upsample2_conv takes a 3^3 kernel, got "
                         f"{tuple(p['w'].shape[2:])}")
    return conv3d(p, upsample_nearest(x.to(dtype)), dtype=dtype)


def upsample2_conv_residual(p: Params, x: torch.Tensor,
                            dtype=torch.float32) -> torch.Tensor:
    """``up + conv3d(p, up)`` with ``up = upsample_nearest(x)``: the
    finetune 2x upscale head (5^3 ``out_upscale`` kernel, reference
    mask_branch.py:216-218).

    Computed in the explicit form, so ``up`` is materialized: at heart
    finetune (one [1, 8, 192, 192, 192] crop in bf16) that is 113 MB, and
    the conv's output as much again."""
    up = upsample_nearest(x.to(dtype))
    return up + conv3d(p, up, dtype=dtype)
