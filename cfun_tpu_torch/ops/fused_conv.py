"""Fused pre-affine + LeakyReLU + 3^3 conv with output moments: the CUDA
kernel and its plain PyTorch version.

Port of ``cfun_tpu/ops/pallas_conv.py`` (the Pallas TPU kernel ``_kernel``
launched by ``fused_conv3d``, and the helpers ``in_affine_from_sums`` and
``identity_affine``).  The kernel is ``csrc/fused_conv3d.cu``, built by
``_build.py`` and bound with ctypes; its header comment gives the design
(a bf16 implicit GEMM on the tensor cores, whose weight layout
``pack_weights`` defines).
``fused_conv3d`` launches it for CUDA tensors, which take bf16 output only,
and uses ``fused_conv3d_reference`` only for CPU tensors.

The function, over channel-first volumes::

    act  = bf16(lrelu(x * scale + shift))     in f32, on the unpadded volume
    y    = conv3x3x3(act, bf16(w))            zero padding 1, f32 sums
    sums = [sum(y), sum(y^2)] per (batch, out-channel), from the f32 sums

so the previous op's InstanceNorm and LeakyReLU ride into the conv as an
affine, and the next InstanceNorm needs no reduction pass.  The padding
holds zeros, not ``lrelu(shift)``.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

# Kernel launches made by ``fused_conv3d`` (one per call on CUDA tensors),
# the same launches by shape (B, C_in, C_out, D, H, W), and calls it
# answered with the plain version (one per call on CPU tensors).
# chip_smoke.py and the tests reset and read them.
launches = 0
launch_shapes: collections.Counter = collections.Counter()
cpu_calls = 0

_OUT_DTYPES = (torch.bfloat16, torch.float32)


def fused_conv3d_reference(x: torch.Tensor, w: torch.Tensor,
                           scale: torch.Tensor, shift: torch.Tensor, *,
                           pre_lrelu: bool = True, alpha: float = 0.01,
                           out_dtype=torch.bfloat16
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on the inputs' device.

    x: [B, C_in, D, H, W]; w: [C_out, C_in, 3, 3, 3]; scale/shift:
    [B, C_in] f32.  Returns (y [B, C_out, D, H, W] ``out_dtype``,
    sums [B, 2, C_out] f32)."""
    act = x.float() * scale[:, :, None, None, None] + \
        shift[:, :, None, None, None]
    if pre_lrelu:
        act = F.leaky_relu(act, alpha)
    act = act.to(torch.bfloat16).float()
    y32 = F.conv3d(act, w.to(torch.bfloat16).float(), padding=1)
    sums = torch.stack([y32.sum(dim=(2, 3, 4)),
                        torch.square(y32).sum(dim=(2, 3, 4))], dim=1)
    return y32.to(out_dtype), sums


CHUNK = 32  # input channels the kernel stages at a time


def chunk_groups(c_in: int):
    """The kernel's walk over C_in: (first channel, groups of 8) of each
    chunk of up to ``CHUNK`` channels; the last group is zero-padded."""
    return [(ci0, min(CHUNK // 8, -(-(c_in - ci0) // 8)))
            for ci0 in range(0, c_in, CHUNK)]


def _fragment_order(wk: torch.Tensor) -> torch.Tensor:
    """[C_out, C_in, 27] -> [steps, ceil(C_out / 8), 32, 4], zero-padded;
    see :func:`pack_weights`."""
    c_out, c_in = wk.shape[:2]
    n_pad = -(-c_out // 8) * 8
    c_pad = -(-c_in // 8) * 8
    wk = F.pad(wk, (0, 0, 0, c_pad - c_in, 0, n_pad - c_out))
    parts = []
    for ci0, g in chunk_groups(c_in):
        steps = -(-27 * g // 2)
        # [N, group, ci, tap] -> [N, tap, group, ci]: K = (tap * g + group)
        # * 8 + ci
        part = wk[:, ci0:ci0 + 8 * g].reshape(n_pad, g, 8, 27)
        part = part.permute(0, 3, 1, 2).reshape(n_pad, 27 * g * 8)
        part = F.pad(part, (0, steps * 16 - 27 * g * 8))
        # [ntile, n % 8, step, k // 8, (k % 8) // 2, k % 2]
        part = part.reshape(n_pad // 8, 8, steps, 2, 4, 2)
        parts.append(part.permute(2, 0, 1, 4, 3, 5).reshape(
            steps, n_pad // 8, 32, 4))
    return torch.cat(parts)


# (C_out, C_in, device) -> pack_index's map: the layout depends on the
# shapes alone, so one gather packs a call's w
_pack_index: dict = {}


def pack_index(c_out: int, c_in: int, device) -> torch.Tensor:
    """Where each value of :func:`pack_weights` comes from: an int32 index
    into w [C_out, C_in, 3, 3, 3] flattened, C_out * C_in * 27 where the
    layout pads with zero.  Built once per shape and device."""
    key = (c_out, c_in, torch.device(device))
    idx = _pack_index.get(key)
    if idx is None:
        n = c_out * c_in * 27
        # position + 1 of every value, 0 where the layout pads
        pos = torch.arange(1, n + 1, dtype=torch.float64)
        idx = _fragment_order(pos.reshape(c_out, c_in, 27)).long() - 1
        idx = torch.where(idx < 0, n, idx).to(torch.int32).to(device)
        _pack_index[key] = idx
    return idx


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """w [C_out, C_in, 3, 3, 3] -> the kernel's bf16 B fragments
    [steps, ceil(C_out / 8), 32, 4], on w's device.

    K is walked chunk by chunk (``chunk_groups``); within a chunk of G
    groups, K slice kg = tap * G + group holds 8 input channels, and a
    step of the mma (k = 16) takes slices 2s and 2s + 1, the last one
    zero when 27 * G is odd.  For n8 tile j and lane l, the four values
    are B[k][n] at n = 8j + l // 4 and k = 2(l % 4) + (0, 1, 8, 9): the
    ``.col`` B operand of mma.m16n8k16, two bf16 a register.  Zero past
    C_in and C_out.  The wrapper packs each call, with the same map,
    in the launch that precedes the conv (``pack_weights_kernel``)."""
    idx = pack_index(w.shape[0], w.shape[1], w.device)
    return F.pad(w.reshape(-1).to(torch.bfloat16), (0, 1))[idx.long()]


def _check(x, w, scale, shift, out_dtype) -> None:
    if x.dim() != 5:
        raise ValueError(f"x must be [B, C_in, D, H, W], got "
                         f"{tuple(x.shape)}")
    b, c = x.shape[:2]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if w.dim() != 5 or tuple(w.shape[1:]) != (c, 3, 3, 3):
        raise ValueError(f"w must be [C_out, {c}, 3, 3, 3], got "
                         f"{tuple(w.shape)}")
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w must be bfloat16 or float32, got {w.dtype}")
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (b, c) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{b}, {c}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}, got "
                        f"{out_dtype}")
    for name, t in (("w", w), ("scale", scale), ("shift", shift)):
        if t.device != x.device:
            raise ValueError(f"x on {x.device}, {name} on {t.device}")


def fused_conv3d(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor, *, pre_lrelu: bool = True,
                 alpha: float = 0.01, out_dtype=torch.bfloat16
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``conv3d(lrelu(x * scale + shift))`` with output moments; see
    :func:`fused_conv3d_reference` for the contract.  x is bfloat16 and,
    on CUDA, contiguous; w is cast to bfloat16.  CUDA tensors go to the
    kernel, which writes bfloat16 y only; CPU tensors to the plain
    version."""
    global launches, cpu_calls
    _check(x, w, scale, shift, out_dtype)
    if x.device.type == "cpu":
        cpu_calls += 1
        return fused_conv3d_reference(x, w, scale, shift,
                                      pre_lrelu=pre_lrelu, alpha=alpha,
                                      out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3d runs on CPU or CUDA, got {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()
            and shift.is_contiguous()):
        raise ValueError("fused_conv3d takes contiguous x, scale and shift")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the fused_conv3d kernel writes bfloat16 y, got "
                        f"out_dtype {out_dtype}")
    from cfun_tpu_torch import _build

    lib = _build.library()
    b, c, d, h, wd = x.shape
    c_out = w.shape[0]
    wc = w.contiguous()
    idx = pack_index(c_out, c, x.device)
    wp = torch.empty(idx.shape, dtype=torch.bfloat16, device=x.device)
    tiles = lib.cfun_fused_conv3d_tiles(d, h, wd)
    y = torch.empty((b, c_out, d, h, wd), dtype=out_dtype, device=x.device)
    partial = torch.empty((b, tiles, 2, c_out), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cfun_fused_conv3d(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(wc.data_ptr()),
            int(wc.dtype == torch.float32), ctypes.c_void_p(idx.data_ptr()),
            idx.numel(), ctypes.c_void_p(wp.data_ptr()),
            ctypes.c_void_p(scale.data_ptr()),
            ctypes.c_void_p(shift.data_ptr()), b, c, c_out, d, h, wd,
            int(pre_lrelu), ctypes.c_float(alpha),
            ctypes.c_void_p(y.data_ptr()),
            ctypes.c_void_p(partial.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused_conv3d kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    launch_shapes[(b, c, c_out, d, h, wd)] += 1
    return y, partial.sum(dim=1)


def in_affine_from_sums(sums: torch.Tensor, n_spatial: int,
                        eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """InstanceNorm as a per-(batch, channel) affine from emitted moments
    (one pass: ``E[y^2] - mean^2``, clamped at 0): returns (scale, shift)
    with IN(y) = y * scale + shift."""
    mean = sums[:, 0] / n_spatial
    var = sums[:, 1] / n_spatial - torch.square(mean)
    scale = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    return scale, -mean * scale


def identity_affine(b: int, c: int, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.ones((b, c), dtype=torch.float32, device=device),
            torch.zeros((b, c), dtype=torch.float32, device=device))
