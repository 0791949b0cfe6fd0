"""The port's fused conv (``ops/fused_conv.py``, CPU tensors: the plain
version of the K2 kernel) against the JAX package's Pallas kernel
``cfun_tpu.ops.pallas_conv.fused_conv3d`` in interpret mode, on the CPU,
with the same inputs made by numpy from a seed.

Tolerances.  Both sides compute the same f32 activation and round it to
bf16 at the same place, and bf16 x bf16 products are exact in f32, so the
f32 outputs differ only in the order of their sums: at most 2^-16 of the
sum of |terms| (``y_abs`` below; ~4e-6 relative is typical at these
depths).  After the bf16 cast that is one bf16 ulp of the output's
magnitude (2^-7 of it bounds an ulp) on top.  The moments are sums of
those f32 values in another order: 1e-4 relative to the sum of |y| and to
the sum of y^2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cfun_tpu.ops import pallas_conv as jconv
from cfun_tpu_torch.ops import fused_conv as k2


def _inputs(seed, b, d, h, w, c, co, affine=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, d, h, w, c)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    wk = (0.3 * rng.normal(size=(3, 3, 3, c, co))).astype(np.float32)
    if affine:
        scale = (1.0 + 0.2 * rng.normal(size=(b, c))).astype(np.float32)
        shift = (0.3 * rng.normal(size=(b, c))).astype(np.float32)
    else:
        scale = np.ones((b, c), np.float32)
        shift = np.zeros((b, c), np.float32)
    return x, wk, scale, shift


def _port(x, wk, scale, shift, **kw):
    """The port on the same arrays: NCDHW, [C_out, C_in, 3, 3, 3]."""
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy()).to(torch.bfloat16)
    wt = torch.from_numpy(wk.transpose(4, 3, 0, 1, 2).copy())
    return k2.fused_conv3d(xt, wt, torch.from_numpy(scale),
                           torch.from_numpy(shift), **kw)


def _y_abs(x, wk, scale, shift, pre_lrelu):
    """Sum of |terms| of each output: conv(|act|, |w|) in float64, NDHWC."""
    act = torch.from_numpy(x).double() * torch.from_numpy(scale).double()[
        :, None, None, None, :] + torch.from_numpy(shift).double()[
        :, None, None, None, :]
    if pre_lrelu:
        act = F.leaky_relu(act, 0.01)
    w = torch.from_numpy(wk.transpose(4, 3, 0, 1, 2).copy()).double()
    y = F.conv3d(act.abs().permute(0, 4, 1, 2, 3), w.abs(), padding=1)
    return np.moveaxis(y.numpy(), 1, -1)


def _assert_y_close(got, want, y_abs):
    tol = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want)) + \
        2.0 ** -16 * y_abs
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{int(bad.sum())} outputs differ by more than "
                           f"one bf16 ulp; worst "
                           f"{float(np.abs(got - want).max())}")


CASES = [
    # b, d, h, w, c_in, c_out, pre_lrelu, affine, h_tile (JAX side)
    (2, 5, 7, 9, 6, 5, True, True, None),
    (2, 5, 7, 9, 6, 5, False, True, None),
    (1, 4, 12, 6, 4, 4, True, True, 4),
    (1, 1, 8, 8, 4, 3, True, False, None),
]


@pytest.mark.parametrize("b,d,h,w,c,co,pre_lrelu,affine,h_tile", CASES)
def test_plain_k2_matches_pallas_interpret(b, d, h, w, c, co, pre_lrelu,
                                           affine, h_tile):
    x, wk, scale, shift = _inputs(b * 100 + d, b, d, h, w, c, co, affine)
    jy, js = jconv.fused_conv3d(jnp.asarray(x), jnp.asarray(wk),
                                jnp.asarray(scale), jnp.asarray(shift),
                                pre_lrelu=pre_lrelu, h_tile=h_tile,
                                interpret=True)
    before = k2.cpu_calls
    ty, ts = _port(x, wk, scale, shift, pre_lrelu=pre_lrelu)
    assert k2.cpu_calls == before + 1 and k2.launches == 0
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    assert tuple(ty.shape) == (b, co, d, h, w) and tuple(ts.shape) == (b, 2,
                                                                       co)
    got = np.moveaxis(ty.float().numpy(), 1, -1)
    want = np.asarray(jy, np.float32)
    _assert_y_close(got, want, _y_abs(x, wk, scale, shift, pre_lrelu))
    js = np.asarray(js)
    ts = ts.numpy()
    ysum_abs = np.abs(want).sum(axis=(1, 2, 3))
    assert np.all(np.abs(ts[:, 0] - js[:, 0]) <= 1e-4 * ysum_abs)
    np.testing.assert_allclose(ts[:, 1], js[:, 1], rtol=1e-4)


def test_f32_output():
    x, wk, scale, shift = _inputs(5, 1, 3, 4, 5, 4, 6)
    ty, ts = _port(x, wk, scale, shift, out_dtype=torch.float32)
    y16, s16 = _port(x, wk, scale, shift)
    assert ty.dtype == torch.float32
    np.testing.assert_array_equal(ty.to(torch.bfloat16).float().numpy(),
                                  y16.float().numpy())
    np.testing.assert_array_equal(ts.numpy(), s16.numpy())


def test_padding_holds_zeros():
    """With x = 0 and a large positive shift, every voxel inside the
    volume activates to lrelu(shift) = shift; a border voxel's output is
    the sum over its in-volume taps only, so it equals the interior
    formula with zero neighbours.  Both the port and the JAX kernel."""
    b, d, h, w, c, co = 1, 4, 5, 6, 3, 2
    _, wk, _, _ = _inputs(9, b, d, h, w, c, co)
    x = np.zeros((b, d, h, w, c), np.float32)
    scale = np.ones((b, c), np.float32)
    shift = np.full((b, c), 4.0, np.float32)
    w16 = np.asarray(jnp.asarray(wk).astype(jnp.bfloat16).astype(jnp.float32))
    # corner (0, 0, 0): taps 1..2 on every axis; interior: all 27 taps
    corner = 4.0 * w16[1:, 1:, 1:].sum(axis=(0, 1, 2, 3))
    interior = 4.0 * w16.sum(axis=(0, 1, 2, 3))
    # the face z = 0, away from the other borders: taps 1..2 in z only
    face = 4.0 * w16[1:].sum(axis=(0, 1, 2, 3))
    ty, _ = _port(x, wk, scale, shift, out_dtype=torch.float32)
    jy, _ = jconv.fused_conv3d(jnp.asarray(x), jnp.asarray(wk),
                               jnp.asarray(scale), jnp.asarray(shift),
                               out_dtype=jnp.float32, interpret=True)
    for y in (np.moveaxis(ty.numpy(), 1, -1), np.asarray(jy)):
        np.testing.assert_allclose(y[0, 0, 0, 0], corner, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(y[0, 2, 2, 2], interior, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(y[0, 0, 2, 2], face, rtol=1e-5,
                                   atol=1e-5)


def test_affine_helpers_match_jax():
    rng = np.random.default_rng(4)
    y = rng.normal(size=(3, 2, 7)).astype(np.float32) * 3 + 1
    sums = np.stack([y.sum(1), np.square(y).sum(1)], 1).astype(np.float32)
    # one channel with a negative one-pass variance: the clamp at 0
    sums[0, 1, 0] = sums[0, 0, 0] ** 2 / 2 - 1.0
    js, jh = jconv.in_affine_from_sums(jnp.asarray(sums), 2)
    ts, th = k2.in_affine_from_sums(torch.from_numpy(sums), 2)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6)
    for a, b in zip(k2.identity_affine(3, 5), jconv.identity_affine(3, 5)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_wrapper_rejects():
    x = torch.zeros(1, 4, 3, 3, 3, dtype=torch.bfloat16)
    w = torch.zeros(2, 4, 3, 3, 3)
    sc, sh = k2.identity_affine(1, 4)
    with pytest.raises(TypeError, match="bfloat16"):
        k2.fused_conv3d(x.float(), w, sc, sh)
    with pytest.raises(ValueError, match="3, 3, 3"):
        k2.fused_conv3d(x, torch.zeros(2, 4, 5, 5, 5), sc, sh)
    with pytest.raises(ValueError, match="scale"):
        k2.fused_conv3d(x, w, sc[:, :2], sh)
    with pytest.raises(TypeError, match="out_dtype"):
        k2.fused_conv3d(x, w, sc, sh, out_dtype=torch.float16)


def _emulate_kernel(x, w, scale, shift, pre_lrelu):
    """The implicit GEMM that ``csrc/fused_conv3d.cu`` runs, in float64 on
    the CPU: the channel-last activated halo (zeros outside the volume and
    past C_in, C_in padded to 8), K walked chunk by chunk as (tap, group
    of 8 channels) slices two a k16 step, and B read from
    ``pack_weights``' fragments by the mma's own lane map (C_out padded
    to 8).  Returns y [B, C_out, D, H, W] float64."""
    b, c, d, h, wd = x.shape
    co = w.shape[0]
    act = x.float() * scale[:, :, None, None, None] + \
        shift[:, :, None, None, None]
    if pre_lrelu:
        act = F.leaky_relu(act, 0.01)
    act = act.to(torch.bfloat16).double()
    c8, n_pad = -(-c // 8) * 8, -(-co // 8) * 8
    halo = torch.zeros(b, d + 2, h + 2, wd + 2, c8, dtype=torch.float64)
    halo[:, 1:-1, 1:-1, 1:-1, :c] = act.permute(0, 2, 3, 4, 1)
    packed = k2.pack_weights(w).double()
    chunks = [(ci0, min(4, -(-(c - ci0) // 8))) for ci0 in range(0, c, 32)]
    assert k2.chunk_groups(c) == chunks
    assert packed.shape == (sum(-(-27 * g // 2) for _, g in chunks),
                            n_pad // 8, 32, 4)
    # lane l, value v of n8 tile j: B[2 (l % 4) + (0, 1, 8, 9)[v]][8j + l // 4]
    lane = torch.arange(32)[:, None]
    kk = 2 * (lane % 4) + torch.tensor([0, 1, 8, 9])[None, :]
    nn = (lane // 4).expand(32, 4)
    acc = torch.zeros(b * d * h * wd, n_pad, dtype=torch.float64)
    step = 0
    for ci0, g in chunks:
        for s in range(-(-27 * g // 2)):
            halves = []
            for kg in (2 * s, 2 * s + 1):
                if kg >= 27 * g:
                    halves.append(torch.zeros(b * d * h * wd, 8,
                                              dtype=torch.float64))
                    continue
                tap, grp = divmod(kg, g)
                dz, dy, dx = tap // 9, (tap // 3) % 3, tap % 3
                lo = ci0 + grp * 8
                halves.append(halo[:, dz:dz + d, dy:dy + h, dx:dx + wd,
                                   lo:lo + 8].reshape(-1, 8))
            bmat = torch.zeros(16, n_pad, dtype=torch.float64)
            for j in range(n_pad // 8):
                bmat[kk, 8 * j + nn] = packed[step, j]
            acc += torch.cat(halves, 1) @ bmat
            step += 1
    assert step == packed.shape[0]
    return acc[:, :co].reshape(b, d, h, wd, co).permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("b,c,co,d,h,w,pre_lrelu", [
    (2, 6, 5, 5, 7, 9, True), (1, 33, 47, 9, 9, 9, True),
    (1, 8, 24, 3, 5, 1, True), (1, 20, 81, 4, 9, 10, False),
    (1, 25, 161, 3, 5, 6, True), (1, 40, 20, 3, 4, 5, True)])
def test_kernel_layout_emulation_matches_plain(b, c, co, d, h, w,
                                               pre_lrelu):
    """The kernel's padding and index maps, emulated, give the plain
    version's sums: the emulation's float64 sums and a float64 conv of the
    plain version's bf16 activation and weights, both rounded to f32 (the
    kernel's and the plain version's rounding points), are equal."""
    g = torch.Generator().manual_seed(c * 100 + co)
    x = torch.randn((b, c, d, h, w), generator=g).to(torch.bfloat16)
    wt = 0.1 * torch.randn((co, c, 3, 3, 3), generator=g)
    scale = 1.0 + 0.2 * torch.randn((b, c), generator=g)
    shift = 0.3 * torch.randn((b, c), generator=g)
    got = _emulate_kernel(x, wt, scale, shift, pre_lrelu)
    act = x.float() * scale[:, :, None, None, None] + \
        shift[:, :, None, None, None]
    if pre_lrelu:
        act = F.leaky_relu(act, 0.01)
    want = F.conv3d(act.to(torch.bfloat16).double(),
                    wt.to(torch.bfloat16).double(), padding=1)
    assert torch.equal(got.float(), want.float())
    ry, _ = k2.fused_conv3d_reference(x, wt, scale, shift,
                                      pre_lrelu=pre_lrelu)
    _assert_y_close(got.to(torch.bfloat16).float().numpy(),
                    ry.float().numpy(),
                    F.conv3d(act.abs().double(),
                             wt.to(torch.bfloat16).double().abs(),
                             padding=1).numpy())
