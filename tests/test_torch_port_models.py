"""Port models against the JAX package on tiny_config (float32), on the CPU,
with shared weights: the JAX package's ``cfun.init_params`` tree filled
from a numpy seed (tests/torch_port_params.py) and converted by
``weights.params_from_numpy``.

Tolerances: the trunk's RPN outputs and the classifier agree to
rtol 1e-4 / atol 1e-4 (float32 convs summed in different orders through
~20 layers); the U-Net, whose instance norms divide by small variances,
to atol 2e-4 on logits of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfun_tpu.config import tiny_config
from cfun_tpu.models import cfun as jcfun
from cfun_tpu.models.heads import apply_classifier as jax_classifier
from cfun_tpu.models.unet3d import apply_unet as jax_unet
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch.models import cfun as tcfun
from cfun_tpu_torch.models.heads import apply_classifier, apply_mask_head
from cfun_tpu_torch.models.unet3d import apply_unet
from cfun_tpu_torch.ops.sorted_nms import sorted_nms_reference
from cfun_tpu_torch.weights import params_from_numpy
from torch_port_params import jax_params

TRUNK_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def shared():
    jcfg = tiny_config(approx_topk=False, nms_backend="scan")
    jp = jax_params(jcfg, 0)
    pcfg = pconfig.tiny_config(approx_topk=False, nms_backend="scan")
    return jcfg, pcfg, jp, params_from_numpy(jp, pcfg)


def _ncdhw(x):
    return np.moveaxis(np.asarray(x), -1, 1)


@pytest.fixture(scope="module")
def trunks(shared):
    jcfg, pcfg, jp, tp = shared
    d, h, w = jcfg.image_shape
    img = np.random.default_rng(0).normal(size=(1, d, h, w, 1))
    img = img.astype(np.float32)
    jt = jax.jit(lambda p, x: jcfun.apply_trunk(p, x, jcfg))(
        jp, jnp.asarray(img))
    tt = tcfun.apply_trunk(tp, torch.from_numpy(_ncdhw(img).copy()), pcfg)
    return jt, tt


@pytest.mark.parametrize("field", ["p2", "p3", "rpn_logits", "rpn_deltas"])
def test_trunk(trunks, field):
    jt, tt = trunks
    want = np.asarray(getattr(jt, field))
    if field in ("p2", "p3"):
        want = _ncdhw(want)
    got = getattr(tt, field).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TRUNK_TOL)


def test_propose_and_pyramid_roi_align(shared, trunks):
    jcfg, pcfg, _, _ = shared
    jt, _ = trunks
    from cfun_tpu.ops.anchors import config_anchors

    anchors = config_anchors(jcfg)
    # the same RPN outputs into both, so the proposal step is held alone
    logits, deltas = np.array(jt.rpn_logits[0]), np.array(jt.rpn_deltas[0])
    jprop, jvalid = jax.jit(lambda *a: jcfun.propose(*a, jcfg, 8))(
        jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(anchors))
    tprop, tvalid = tcfun.propose(torch.from_numpy(logits),
                                  torch.from_numpy(deltas),
                                  torch.from_numpy(anchors), pcfg, 8,
                                  nms=sorted_nms_reference)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tprop.numpy(), np.asarray(jprop),
                               rtol=1e-6, atol=1e-7)

    p2, p3 = np.asarray(jt.p2[0]), np.asarray(jt.p3[0])
    jpool = jax.jit(lambda *a: jcfun.pyramid_roi_align(
        *a, jcfg.pool_size, chunk=8))(jprop, jnp.asarray(p2), jnp.asarray(p3))
    tpool = tcfun.pyramid_roi_align(
        torch.from_numpy(np.asarray(jprop).copy()),
        torch.from_numpy(np.moveaxis(p2, -1, 0).copy()),
        torch.from_numpy(np.moveaxis(p3, -1, 0).copy()), pcfg.pool_size)
    np.testing.assert_allclose(tpool.numpy(), _ncdhw(jpool),
                               rtol=1e-5, atol=1e-5)


def test_classifier_and_refine(shared):
    jcfg, pcfg, jp, tp = shared
    rng = np.random.default_rng(1)
    pooled = rng.normal(size=(8, *jcfg.pool_size,
                              jcfg.fpn_channels)).astype(np.float32)
    jl, jd = jax.jit(jax_classifier)(jp["classifier"], jnp.asarray(pooled))
    tl, td = apply_classifier(tp["classifier"],
                              torch.from_numpy(_ncdhw(pooled).copy()))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TRUNK_TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TRUNK_TOL)

    # refine_detections on shared, confident inputs
    lo = rng.uniform(0, 0.6, size=(8, 3))
    rois = np.concatenate([lo, lo + rng.uniform(0.1, 0.4, size=(8, 3))],
                          1).astype(np.float32)
    probs = np.stack([np.full(8, 0.1), np.full(8, 0.9)], 1)
    probs[:, 1] -= np.arange(8) * 0.01
    probs[:, 0] = 1 - probs[:, 1]
    probs = probs.astype(np.float32)
    deltas = (rng.normal(size=(8, 2, 6)) * 0.2).astype(np.float32)
    valid = np.ones(8, bool)
    valid[3] = False
    d, h, w = jcfg.image_shape
    win = np.array([0, 0, 0, d, h, w], np.float32)
    jdet, jkept = jax.jit(lambda *a: jcfun.refine_detections(*a, jcfg))(
        jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(probs),
        jnp.asarray(deltas), jnp.asarray(win))
    tdet, tkept = tcfun.refine_detections(
        torch.from_numpy(rois), torch.from_numpy(valid),
        torch.from_numpy(probs), torch.from_numpy(deltas),
        torch.from_numpy(win), pcfg, nms=sorted_nms_reference)
    np.testing.assert_array_equal(tkept.numpy(), np.asarray(jkept))
    np.testing.assert_array_equal(tdet.numpy(), np.asarray(jdet))


def test_unet_beginning(shared):
    """apply_unet at 'beginning' in its inference form (no dropout,
    up_impl='phase' as apply_mask_head passes)."""
    jcfg, _, jp, tp = shared
    crops = np.random.default_rng(2).normal(
        size=(2, *jcfg.mask_shape, 1)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_unet(p, x, stage="beginning",
                                         up_impl="phase"))(
        jp["mask"]["unet"], jnp.asarray(crops))
    got = apply_unet(tp["mask"]["unet"], torch.from_numpy(_ncdhw(crops).copy()),
                     stage="beginning")
    np.testing.assert_allclose(got.numpy(), _ncdhw(want), rtol=1e-4,
                               atol=2e-4)
    head = apply_mask_head(tp["mask"], torch.from_numpy(_ncdhw(crops).copy()),
                           stage="beginning")
    np.testing.assert_array_equal(head.numpy(), got.numpy())


def test_unet_finetune_is_not_ported(shared):
    """The finetune stage, ported since this test's name was given: the
    dense U-Net ends in the 2x upscale head (``upsample2_conv_residual``,
    explicit form here, the phase form on the JAX side as
    ``apply_mask_head`` passes it), so a 16^3 crop gives 32^3 logits.
    Same tolerance as the 'beginning' U-Net."""
    jcfg, _, jp, tp = shared
    crops = np.random.default_rng(3).normal(
        size=(1, *jcfg.mask_shape, 1)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_unet(p, x, stage="finetune",
                                         head_impl="phase",
                                         up_impl="phase"))(
        jp["mask"]["unet"], jnp.asarray(crops))
    got = apply_unet(tp["mask"]["unet"],
                     torch.from_numpy(_ncdhw(crops).copy()), stage="finetune")
    assert tuple(got.shape) == (1, jcfg.num_classes, 32, 32, 32)
    np.testing.assert_allclose(got.numpy(), _ncdhw(want), rtol=1e-4,
                               atol=2e-4)


@pytest.mark.parametrize("stage", ["beginning", "finetune"])
def test_unet_phase_forms_at_32(shared, monkeypatch, stage):
    """apply_unet at a 32^3 crop, where exactly one decoder up-conv (l3,
    16^3 in) passes the ``nsp >= 2048`` gate: the phase forms against the
    JAX U-Net with ``up_impl='phase', head_impl='phase'``, and against the
    port's explicit forms, at the 'beginning' U-Net's tolerance."""
    from cfun_tpu_torch import nn as tnn

    jcfg, _, jp, tp = shared
    crops = np.random.default_rng(4).normal(
        size=(1, 32, 32, 32, 1)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_unet(p, x, stage=stage,
                                         up_impl="phase",
                                         head_impl="phase"))(
        jp["mask"]["unet"], jnp.asarray(crops))
    calls = []
    phase = tnn.upsample2_conv

    def counted(p, v, **kw):
        calls.append(tuple(v.shape[2:]))
        return phase(p, v, **kw)

    monkeypatch.setattr(tnn, "upsample2_conv", counted)
    x = torch.from_numpy(_ncdhw(crops).copy())
    got = apply_unet(tp["mask"]["unet"], x, stage=stage, up_impl="phase",
                     head_impl="phase")
    assert calls == [(16, 16, 16)]
    side = 64 if stage == "finetune" else 32
    assert tuple(got.shape) == (1, jcfg.num_classes, side, side, side)
    np.testing.assert_allclose(got.numpy(), _ncdhw(want), rtol=1e-4,
                               atol=2e-4)
    explicit = apply_unet(tp["mask"]["unet"], x, stage=stage)
    np.testing.assert_allclose(got.numpy(), explicit.numpy(), rtol=1e-4,
                               atol=2e-4)
    head = apply_mask_head(tp["mask"], x, stage=stage)
    np.testing.assert_array_equal(head.numpy(), got.numpy())
