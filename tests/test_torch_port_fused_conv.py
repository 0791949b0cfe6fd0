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
