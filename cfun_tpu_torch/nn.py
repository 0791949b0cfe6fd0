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
``upsample2_conv_residual`` are the JAX package's phase-decomposed forms
(one stride-1 3^3 conv with 8x the output channels, then depth-to-space);
``upsample2_conv_explicit`` and ``upsample2_conv_residual_explicit``
compute the same maps as a nearest upsample followed by the conv.
``channel_dropout`` is the U-Net's training dropout; its keep masks are
drawn from an explicit ``torch.Generator`` or passed in.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

Params = dict

# each up-conv weight leaf's phase kernel by compute dtype, as (the leaf's
# version, kernel); an entry goes with its leaf
_phase_kernels = WeakIdKeyDictionary()


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


def _fold_taps(w: torch.Tensor) -> torch.Tensor:
    """``K[t] = w[t] + w[t - 1]`` (w zero-padded) along each spatial axis
    of [C_out, C_in, k, k, k], in the order d, h, w: the (k+1)-tap kernel
    that a k-tap correlation over a nearest 2x upsample is on the
    dilation-2 grid of its input."""
    for ax in (2, 3, 4):
        zero = torch.zeros_like(w.narrow(ax, 0, 1))
        w = torch.cat([zero, w], dim=ax) + torch.cat([w, zero], dim=ax)
    return w


def _depth_to_space(y: torch.Tensor, c_out: int) -> torch.Tensor:
    """[N, 8 * C_out, D, H, W] with phase-major channels (qd, qh, qw,
    c_out) -> [N, C_out, 2D, 2H, 2W], output voxel 2i + q from phase q."""
    n, _, d, h, w = y.shape
    y = y.view(n, 2, 2, 2, c_out, d, h, w)
    return y.permute(0, 4, 5, 1, 6, 2, 7, 3).reshape(n, c_out, 2 * d,
                                                     2 * h, 2 * w)


def _phase_kernel(w: torch.Tensor, dtype,
                  build: Callable[[torch.Tensor], list]) -> torch.Tensor:
    """The 8 phase kernels ``build(w)`` ([C_out, C_in, 3, 3, 3] f32 each,
    in (qd, qh, qw) order) as one [8 * C_out, C_in, 3, 3, 3] kernel in
    ``dtype``, made at the first use of the leaf ``w`` (and again after an
    in-place change to it) and kept, as the JAX package composes it once
    when it compiles: a request makes one conv call per up-conv, not the
    ~60 small launches of the composition.  It is made on the current
    stream.  Where autograd tracks ``w`` it is composed on every call
    instead."""
    if w.requires_grad and torch.is_grad_enabled():
        return torch.cat(build(w.float()), dim=0).to(dtype)
    per_dtype = _phase_kernels.get(w)
    if per_dtype is None:
        per_dtype = _phase_kernels[w] = {}
    version, kernel = per_dtype.get(dtype, (None, None))
    if version != w._version:
        with torch.inference_mode(False):
            kernel = torch.cat(build(w.detach().float()), dim=0).to(dtype)
        per_dtype[dtype] = (w._version, kernel)
    return kernel


def _phase_conv(x: torch.Tensor, p: Params, build, dtype) -> torch.Tensor:
    """The phase kernel of ``p["w"]`` as one stride-1 conv with 8 * C_out
    outputs, then depth-to-space, plus the bias."""
    c_out = p["w"].shape[0]
    y = F.conv3d(x.to(dtype), _phase_kernel(p["w"], dtype, build), padding=1)
    out = _depth_to_space(y, c_out)
    if "b" in p:
        out = out + _bcast(p["b"].to(out.dtype), out)
    return out


def _up_phases(w: torch.Tensor) -> list:
    """The 8 phase kernels of a 3^3 up-conv kernel (:func:`upsample2_conv`)."""
    k = _fold_taps(w)  # [co, ci, 4, 4, 4]

    def phase(t, ax, q):
        taps = t.narrow(ax, q, 3)[(slice(None),) * ax + (slice(0, 3, 2),)]
        zero = torch.zeros_like(taps.narrow(ax, 0, 1))
        return torch.cat([zero, taps] if q else [taps, zero], dim=ax)

    return [phase(phase(phase(k, 2, qd), 3, qh), 4, qw)
            for qd in (0, 1) for qh in (0, 1) for qw in (0, 1)]


def _residual_phases(w: torch.Tensor) -> list:
    """The 8 phase kernels of a 5^3 head kernel
    (:func:`upsample2_conv_residual`)."""
    w = w.clone()
    w[:, :, 2, 2, 2] += torch.eye(w.shape[0], w.shape[1], dtype=w.dtype,
                                  device=w.device)
    k = _fold_taps(w)  # [co, ci, 6, 6, 6]
    return [k[:, :, 1 - qd::2][:, :, :3][:, :, :, 1 - qh::2][:, :, :, :3]
            [..., 1 - qw::2][..., :3]
            for qd in (0, 1) for qh in (0, 1) for qw in (0, 1)]


def upsample2_conv(p: Params, x: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """``conv3d(p, upsample_nearest(x))`` for a 3^3 kernel (the U-Net
    decoder's up-conv) as one phase-decomposed conv + depth-to-space, with
    no 2x input materialized (``cfun_tpu/nn.py::upsample2_conv``).

    Per axis, ``up[2i + q] = x[i]``, so output 2i + q takes two source
    taps of the composed kernel ``K[t] = w[t] + w[t - 1]``: q = 0 takes
    (K[0], K[2]) at offsets (-1, 0), q = 1 takes (K[1], K[3]) at (0, +1),
    each set in a zero-padded 3-tap window.  Differs from
    :func:`upsample2_conv_explicit` by the reassociation of the folded
    taps."""
    if tuple(p["w"].shape[2:]) != (3, 3, 3):
        raise ValueError(f"upsample2_conv takes a 3^3 kernel, got "
                         f"{tuple(p['w'].shape[2:])}")
    return _phase_conv(x, p, _up_phases, dtype)


def upsample2_conv_explicit(p: Params, x: torch.Tensor,
                            dtype=torch.float32) -> torch.Tensor:
    """``conv3d(p, upsample_nearest(x))`` for a 3^3 kernel, as written."""
    if tuple(p["w"].shape[2:]) != (3, 3, 3):
        raise ValueError(f"upsample2_conv takes a 3^3 kernel, got "
                         f"{tuple(p['w'].shape[2:])}")
    return conv3d(p, upsample_nearest(x.to(dtype)), dtype=dtype)


def upsample2_conv_residual(p: Params, x: torch.Tensor,
                            dtype=torch.float32) -> torch.Tensor:
    """``up + conv3d(p, up)`` with ``up = upsample_nearest(x)``: the
    finetune 2x upscale head (5^3 ``out_upscale`` kernel, reference
    mask_branch.py:216-218) as one phase-decomposed conv + depth-to-space
    (``cfun_tpu/nn.py::upsample2_conv_residual``): ``up`` is never
    materialized.

    The residual is folded into the centre tap (``W' = w + I`` there), the
    6-tap composed kernel is ``K[t] = W'[t] + W'[t - 1]``, and output phase
    q of an axis takes ``K[2 * delta + 3 - q]`` for delta in (-1, 0, 1):
    the strided slices ``K[1 - q::2][:3]``.  The slices are those of a
    5^3 kernel; another size raises."""
    if tuple(p["w"].shape[2:]) != (5, 5, 5):
        raise ValueError(f"upsample2_conv_residual implements the k=5 "
                         f"head (reference mask_branch.py:216-218); got "
                         f"kernel {tuple(p['w'].shape[2:])}")
    return _phase_conv(x, p, _residual_phases, dtype)


def upsample2_conv_residual_explicit(p: Params, x: torch.Tensor,
                                     dtype=torch.float32) -> torch.Tensor:
    """``up + conv3d(p, up)`` with ``up = upsample_nearest(x)``, as
    written: ``up`` is materialized (at heart finetune, one [1, 8, 192,
    192, 192] crop in bf16 is 113 MB, and the conv's output as much
    again)."""
    up = upsample_nearest(x.to(dtype))
    return up + conv3d(p, up, dtype=dtype)


def dropout_keep(shape, rate: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """A bool keep mask of ``shape`` on ``device``, each entry True with
    probability ``1 - rate``: a uniform draw from ``generator`` (on the
    generator's device) below ``1 - rate``, as ``jax.random.bernoulli``
    draws it."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u < 1.0 - rate).to(device)


def channel_dropout(x: torch.Tensor, rate: float,
                    keep: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Dropout3d over whole channels of [N, C, D, H, W] (reference
    mask_branch.py:19): channel c of item n is zeroed where ``keep[n, c]``
    is False and scaled by ``1 / (1 - rate)`` elsewhere.  ``keep`` [N, C,
    1, 1, 1] bool is drawn from ``generator`` when not given; a caller
    that recomputes the forward (``torch.utils.checkpoint``) passes it, so
    the recomputation sees the same mask."""
    if rate == 0.0:
        return x
    if keep is None:
        keep = dropout_keep((x.shape[0], x.shape[1], 1, 1, 1), rate,
                            generator, device=x.device)
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device)
                       ).to(x.dtype)
