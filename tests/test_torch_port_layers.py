"""Port layers and geometry ops against the JAX package, on the CPU.

Same seeded numpy inputs through ``cfun_tpu`` (NDHWC) and
``cfun_tpu_torch`` (NCDHW).  Tolerance: float32, rtol 1e-5 / atol 1e-5 for
single layers (both run f32 IEEE arithmetic; sums differ only in order);
exact where the op is pure indexing or elementwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfun_tpu import nn as jnn
from cfun_tpu.config import heart_inference_config, tiny_config
from cfun_tpu.ops import boxes as jboxes
from cfun_tpu.ops import sample3d as jsample
from cfun_tpu.ops.anchors import config_anchors as jax_anchors
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import nn as tnn
from cfun_tpu_torch.ops import boxes as tboxes
from cfun_tpu_torch.ops import sample3d as tsample
from cfun_tpu_torch.ops.anchors import config_anchors as port_anchors
from cfun_tpu_torch.weights import _convert

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _to_t(x_ndhwc):
    """NDHWC numpy -> NCDHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x_ndhwc, -1, 1)))


def _to_np(t_ncdhw):
    return np.moveaxis(t_ncdhw.detach().numpy(), 1, -1)


def _conv_params(rng, k, ci, co, bias=True):
    w = rng.normal(size=(*k, ci, co)).astype(np.float32) * 0.2
    p = {"w": w}
    if bias:
        p["b"] = rng.normal(size=(co,)).astype(np.float32)
    tp = {"w": _convert("x/w", w)}
    if bias:
        tp["b"] = torch.from_numpy(p["b"])
    return p, tp


@pytest.mark.parametrize("k,stride,ci,co,bias", [
    ((3, 3, 3), 1, 3, 5, True),
    ((1, 1, 1), 2, 4, 6, True),
    ((3, 7, 7), 2, 1, 4, True),   # the P3D stem
    ((1, 3, 3), 1, 4, 4, True),   # conv_S
    ((3, 1, 1), 1, 4, 4, True),   # conv_T
    ((3, 3, 3), 2, 4, 8, False),  # U-Net down conv
])
def test_conv3d(k, stride, ci, co, bias):
    rng = _rng(0)
    x = rng.normal(size=(2, 8, 12, 10, ci)).astype(np.float32)
    p, tp = _conv_params(rng, k, ci, co, bias)
    want = np.asarray(jnn.conv3d(p, jnp.asarray(x), stride=stride))
    got = _to_np(tnn.conv3d(tp, _to_t(x), stride=stride))
    np.testing.assert_allclose(got, want, **TOL)


def test_stem_s2d_and_conv1ch_are_plain_convs():
    """The TPU workarounds compute the port's plain convs."""
    rng = _rng(1)
    x = rng.normal(size=(1, 8, 16, 16, 1)).astype(np.float32)
    p, tp = _conv_params(rng, (3, 7, 7), 1, 4)
    want = np.asarray(jnn.conv3d_stem_s2d(p, jnp.asarray(x)))
    got = _to_np(tnn.conv3d(tp, _to_t(x), stride=2))
    np.testing.assert_allclose(got, want, **TOL)
    p, tp = _conv_params(rng, (3, 3, 3), 1, 4, bias=False)
    want = np.asarray(jnn.conv3d_1ch(p, jnp.asarray(x)))
    got = _to_np(tnn.conv3d_1ch(tp, _to_t(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_linear():
    rng = _rng(2)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    p = {"w": rng.normal(size=(16, 12)).astype(np.float32),
         "b": rng.normal(size=(12,)).astype(np.float32)}
    tp = {"w": _convert("x/w", p["w"]), "b": torch.from_numpy(p["b"])}
    np.testing.assert_allclose(tnn.linear(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jnn.linear(p, jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_frozen_bn(eps):
    rng = _rng(3)
    x = rng.normal(size=(2, 4, 5, 6, 7)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 2, 7).astype(np.float32),
         "bias": rng.normal(size=7).astype(np.float32),
         "mean": rng.normal(size=7).astype(np.float32),
         "var": rng.uniform(0.5, 2, 7).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    np.testing.assert_allclose(
        _to_np(tnn.frozen_bn(tp, _to_t(x), eps=eps)),
        np.asarray(jnn.frozen_bn(p, jnp.asarray(x), eps=eps)), **TOL)


def test_instance_norm():
    rng = _rng(4)
    x = (rng.normal(size=(2, 6, 8, 10, 3)) * 3 + 1).astype(np.float32)
    np.testing.assert_allclose(_to_np(tnn.instance_norm(_to_t(x))),
                               np.asarray(jnn.instance_norm(jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("name", ["relu", "leaky_relu", "max_pool",
                                  "upsample_nearest"])
def test_elementwise_and_resampling(name):
    x = _rng(5).normal(size=(2, 4, 6, 8, 3)).astype(np.float32)
    want = np.asarray(getattr(jnn, name)(jnp.asarray(x)))
    got = _to_np(getattr(tnn, name)(_to_t(x)))
    np.testing.assert_array_equal(got, want)


def test_upsample2_conv():
    """The port's phase-decomposed up-conv against the JAX one (equal to
    the last bit here; held to 1e-5), and the port's explicit upsample +
    conv against it (the folded taps reassociate: 3.8e-6 at most here,
    outputs up to ~7)."""
    rng = _rng(6)
    x = rng.normal(size=(2, 4, 5, 6, 3)).astype(np.float32)
    p, tp = _conv_params(rng, (3, 3, 3), 3, 4, bias=False)
    want = np.asarray(jnn.upsample2_conv(p, jnp.asarray(x)))
    got = _to_np(tnn.upsample2_conv(tp, _to_t(x)))
    np.testing.assert_allclose(got, want, **TOL)
    explicit = _to_np(tnn.upsample2_conv_explicit(tp, _to_t(x)))
    np.testing.assert_allclose(explicit, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("bias", [False, True])
def test_upsample2_conv_bias_and_layout(bias):
    """With a bias, odd sizes and C_in != C_out: phase against the JAX
    phase form and the port's explicit form, to 1e-5."""
    rng = _rng(7)
    x = rng.normal(size=(1, 3, 7, 2, 5)).astype(np.float32)
    p, tp = _conv_params(rng, (3, 3, 3), 5, 2, bias=bias)
    want = np.asarray(jnn.upsample2_conv(p, jnp.asarray(x)))
    got = tnn.upsample2_conv(tp, _to_t(x))
    assert tuple(got.shape) == (1, 2, 6, 14, 4)
    np.testing.assert_allclose(_to_np(got), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), tnn.upsample2_conv_explicit(tp, _to_t(x)).numpy(),
        **TOL)


def test_upsample2_conv_residual():
    """The finetune head's phase form (residual folded into the centre
    tap, 6-tap composed kernel, strided phase slices) against the JAX one
    (equal to the last bit here) and the explicit ``up + conv(up)``
    (6.2e-6 at most here, outputs up to ~9), to 1e-5; another kernel size
    raises, as in the JAX package."""
    rng = _rng(8)
    x = rng.normal(size=(2, 4, 5, 6, 3)).astype(np.float32)
    p, tp = _conv_params(rng, (5, 5, 5), 3, 3, bias=False)
    p["w"] *= 0.5
    tp["w"] *= 0.5
    want = np.asarray(jnn.upsample2_conv_residual(p, jnp.asarray(x)))
    got = tnn.upsample2_conv_residual(tp, _to_t(x))
    np.testing.assert_allclose(_to_np(got), want, **TOL)
    explicit = tnn.upsample2_conv_residual_explicit(tp, _to_t(x))
    np.testing.assert_allclose(got.numpy(), explicit.numpy(), **TOL)
    _, tp3 = _conv_params(rng, (3, 3, 3), 3, 3, bias=False)
    with pytest.raises(ValueError, match="k=5"):
        tnn.upsample2_conv_residual(tp3, _to_t(x))


@pytest.mark.parametrize("k", [3, 5])
def test_phase_kernel_made_once_per_leaf(k):
    """The phase kernel of a weight leaf is composed at its first use and
    kept per dtype; an in-place change to the leaf makes it anew (the
    output follows the JAX form on the new weights); a leaf that autograd
    tracks is composed on each call, gets its gradient, and is not kept."""
    up = {3: (tnn.upsample2_conv, jnn.upsample2_conv),
          5: (tnn.upsample2_conv_residual, jnn.upsample2_conv_residual)}
    port_fn, jax_fn = up[k]
    rng = _rng(10 + k)
    x = rng.normal(size=(1, 4, 3, 5, 3)).astype(np.float32)
    # the 5^3 head has no bias (the JAX form takes none)
    p, tp = _conv_params(rng, (k, k, k), 3, 3, bias=k == 3)
    port_fn(tp, _to_t(x))
    kept = tnn._phase_kernels[tp["w"]][torch.float32]
    port_fn(tp, _to_t(x))
    assert tnn._phase_kernels[tp["w"]][torch.float32][1] is kept[1]
    port_fn(tp, _to_t(x), dtype=torch.bfloat16)
    assert set(tnn._phase_kernels[tp["w"]]) == {torch.float32,
                                                 torch.bfloat16}
    p["w"] *= 0.5
    tp["w"].mul_(0.5)
    got = port_fn(tp, _to_t(x))
    assert tnn._phase_kernels[tp["w"]][torch.float32][1] is not kept[1]
    np.testing.assert_allclose(_to_np(got),
                               np.asarray(jax_fn(p, jnp.asarray(x))), **TOL)
    w = tp["w"].clone().requires_grad_(True)
    port_fn({**tp, "w": w}, _to_t(x)).sum().backward()
    assert w.grad is not None and float(w.grad.abs().sum()) > 0
    assert w not in tnn._phase_kernels


def test_depth_to_space_matches_jax_reshape():
    """The NCDHW depth-to-space against the JAX NDHWC reshape
    (``cfun_tpu/nn.py:318-322``) on phase-major channels."""
    n, d, h, w, co = 2, 3, 4, 5, 3
    y = _rng(9).normal(size=(n, d, h, w, 8 * co)).astype(np.float32)
    want = y.reshape(n, d, h, w, 2, 2, 2, co).transpose(
        0, 1, 4, 2, 5, 3, 6, 7).reshape(n, 2 * d, 2 * h, 2 * w, co)
    got = tnn._depth_to_space(_to_t(y), co)
    np.testing.assert_array_equal(_to_np(got), want)


def _boxes(seed, n):
    rng = _rng(seed)
    lo = rng.uniform(0, 50, size=(n, 3))
    return np.concatenate([lo, lo + rng.uniform(1, 30, size=(n, 3))],
                          1).astype(np.float32)


def test_pairwise_iou_bitwise():
    a, b = _boxes(7, 30), _boxes(8, 20)
    b[:5] = a[:5]
    want = np.asarray(jboxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    got = tboxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_box_deltas_clip_and_normalize():
    a = _boxes(9, 25)
    d = (_rng(10).normal(size=(25, 6)) * 0.3).astype(np.float32)
    win = [0.0, 0.0, 0.0, 40.0, 48.0, 56.0]
    ja = jboxes.apply_box_deltas(jnp.asarray(a), jnp.asarray(d))
    ta = tboxes.apply_box_deltas(torch.from_numpy(a), torch.from_numpy(d))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    jc = jboxes.clip_boxes(ja, win)
    tc = tboxes.clip_boxes(torch.from_numpy(np.array(ja)), win)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    shape = (40, 48, 56)
    jn = jboxes.normalize_boxes(jc, shape)
    tn = tboxes.normalize_boxes(tc, shape)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(
        tboxes.denormalize_boxes(tn, shape).numpy(),
        np.asarray(jboxes.denormalize_boxes(jn, shape)))


@pytest.mark.parametrize("make", [tiny_config, heart_inference_config])
def test_anchors(make):
    jcfg = make()
    pcfg = getattr(pconfig, make.__name__)()
    np.testing.assert_array_equal(port_anchors(pcfg), jax_anchors(jcfg))


@pytest.mark.parametrize("out_shape", [(4, 4, 4), (6, 5, 3)])
def test_roi_align(out_shape):
    rng = _rng(11)
    vol = rng.normal(size=(10, 12, 14, 3)).astype(np.float32)
    lo = rng.uniform(0, 0.6, size=(7, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, size=(7, 3))],
                           1).astype(np.float32)
    boxes[0] = [0, 0, 0, 1, 1, 1]
    boxes[1] = [0.5, 0.5, 0.5, 0.5, 0.5, 0.5]  # degenerate
    want = np.asarray(jsample.roi_align(jnp.asarray(vol), jnp.asarray(boxes),
                                        out_shape))
    tvol = torch.from_numpy(np.ascontiguousarray(np.moveaxis(vol, -1, 0)))
    got = tsample.roi_align(tvol, torch.from_numpy(boxes), out_shape)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, **TOL)
    one = tsample.crop_resize_align_corners(tvol, torch.from_numpy(boxes[2]),
                                            out_shape)
    np.testing.assert_allclose(np.moveaxis(one.numpy(), 0, -1), want[2],
                               **TOL)


def test_separable_trilinear():
    rng = _rng(12)
    vol = rng.normal(size=(6, 7, 8, 2)).astype(np.float32)
    zc = np.linspace(-0.5, 5.5, 5).astype(np.float32)
    yc = np.linspace(0.2, 6.9, 4).astype(np.float32)
    xc = np.linspace(1.0, 7.5, 3).astype(np.float32)
    want = np.asarray(jsample.separable_trilinear(
        jnp.asarray(vol), jnp.asarray(zc), jnp.asarray(yc), jnp.asarray(xc)))
    got = tsample.separable_trilinear(
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(vol, -1, 0))),
        torch.from_numpy(zc), torch.from_numpy(yc), torch.from_numpy(xc))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 0, -1), want, **TOL)
