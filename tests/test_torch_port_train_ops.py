"""The port's training pieces below the step against the JAX package, on
the CPU: the new box and sampling ops, the six losses (values and input
gradients, heart and LiTS forms), the RPN targets, the detection-target
layer, channel dropout, the feeder's GT box, and the gradients of the two
1-channel convs against the JAX package's TPU forms of them
(``conv3d_stem_s2d``, the ``_conv1ch_s1`` custom VJP).

Same seeded numpy inputs on both sides (the port channel-first).
Tolerances: exact where the op is indexing, comparisons or NumPy on both
sides (``build_rpn_targets``, ``np_mask_to_extended_bbox``, nearest
crops, the sampler's choice); float32 elementwise and reductions rtol 1e-5
/ atol 1e-6; loss gradients rtol 1e-5 / atol 1e-7 (1e-6 for the edge
loss, whose Sobel convs sum in another order); the convs' outputs and
gradients rtol 1e-4 / atol 1e-6 of the largest magnitude (the s2d and
shifted-slice forms sum thousands of products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfun_tpu import nn as jnn
from cfun_tpu.config import heart_config, lits_config, tiny_config
from cfun_tpu.data.feeder import np_mask_to_extended_bbox as jax_bbox
from cfun_tpu.ops import boxes as jboxes
from cfun_tpu.ops import sample3d as jsample
from cfun_tpu.ops.anchors import config_anchors as jax_anchors
from cfun_tpu.train import losses as JL
from cfun_tpu.train import targets as jtargets
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import nn as tnn
from cfun_tpu_torch import weights
from cfun_tpu_torch.data.feeder import np_mask_to_extended_bbox
from cfun_tpu_torch.ops import boxes as tboxes
from cfun_tpu_torch.ops import sample3d as tsample
from cfun_tpu_torch.ops.anchors import config_anchors as port_anchors
from cfun_tpu_torch.train import losses as TL
from cfun_tpu_torch.train import targets as ttargets
from cfun_tpu_torch.data.batch import pack_labels_w, unpack_labels_w
from torch_port_params import jax_params

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _first(x):
    """[N, ..., C] -> [N, C, ...] (channels first)."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))


# ---- boxes ------------------------------------------------------------------

def _boxes(rng, n, span=60.0):
    lo = rng.uniform(0, span, size=(n, 3))
    return np.concatenate([lo, lo + rng.uniform(0.5, 20, size=(n, 3))],
                          1).astype(np.float32)


def test_box_refinement_and_extend_box():
    rng = np.random.default_rng(0)
    b, g = _boxes(rng, 16), _boxes(rng, 16)
    b[3, 3:] = b[3, :3]  # a zero-size (padded) row
    np.testing.assert_allclose(
        tboxes.box_refinement(_t(b), _t(g)).numpy(),
        np.asarray(jboxes.box_refinement(jnp.asarray(b), jnp.asarray(g))),
        **TOL)
    shape = (32, 64, 64)
    for box in list(b[:6]) + [np.array([0, 0, 0, 32, 64, 64], np.float32),
                              np.array([-3, 5, 60, 31, 70, 64], np.float32)]:
        np.testing.assert_array_equal(
            tboxes.extend_box(_t(box), shape).numpy(),
            np.asarray(jboxes.extend_box(jnp.asarray(box), shape)))


@pytest.mark.parametrize("case", ["block", "face", "voxel", "empty"])
def test_mask_to_bbox(case):
    mask = np.zeros((12, 20, 16), np.int32)
    if case == "block":
        mask[2:7, 3:15, 4:9] = 2
    elif case == "face":
        mask[9:, 0:4, 10:] = 1  # on three faces of the volume
    elif case == "voxel":
        mask[5, 6, 7] = 3
    got = tboxes.mask_to_bbox(_t(mask)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jboxes.mask_to_bbox(mask)))
    np.testing.assert_array_equal(
        np_mask_to_extended_bbox(mask), jax_bbox(mask))


# ---- sampling ---------------------------------------------------------------

def test_point_samplers():
    rng = np.random.default_rng(1)
    vol = rng.normal(size=(7, 9, 11, 3)).astype(np.float32)
    z = rng.uniform(-2, 9, size=(5, 6)).astype(np.float32)
    y = rng.uniform(-2, 11, size=(5, 6)).astype(np.float32)
    x = rng.uniform(-2, 13, size=(5, 6)).astype(np.float32)
    z[0, :3] = [2.5, 3.5, -0.5]  # halves round up, as floor(c + 0.5)
    tv = _t(np.moveaxis(vol, -1, 0))
    for jf, tf, tol in ((jsample.trilinear_sample, tsample.trilinear_sample,
                         TOL), (jsample.nearest_sample,
                                tsample.nearest_sample, dict(rtol=0, atol=0))):
        want = np.moveaxis(np.asarray(jf(jnp.asarray(vol), jnp.asarray(z),
                                         jnp.asarray(y), jnp.asarray(x))),
                           -1, 0)
        np.testing.assert_allclose(tf(tv, _t(z), _t(y), _t(x)).numpy(), want,
                                   **tol)


_CROPS = {
    "seeded": np.array([2.7, 5.2, 1.1, 9.9, 17.6, 12.3], np.float32),
    "face": np.array([0.0, 0.0, 4.0, 12.0, 20.0, 16.0], np.float32),
    "beyond": np.array([8.0, -3.0, 10.0, 15.0, 24.0, 19.0], np.float32),
    "zero_size": np.array([4.0, 6.0, 3.0, 4.0, 6.0, 3.0], np.float32),
}


@pytest.mark.parametrize("method", ["nearest", "trilinear"])
@pytest.mark.parametrize("box", sorted(_CROPS))
def test_crop_resize_halfpix(method, box):
    rng = np.random.default_rng(2)
    vol = rng.normal(size=(12, 20, 16, 2)).astype(np.float32)
    if method == "nearest":
        vol = rng.integers(0, 5, size=vol.shape).astype(np.int32)
    want = np.asarray(jsample.crop_resize_halfpix(
        jnp.asarray(vol), jnp.asarray(_CROPS[box]), (5, 7, 6), method))
    got = tsample.crop_resize_halfpix(_t(np.moveaxis(vol, -1, 0)),
                                      _t(_CROPS[box]), (5, 7, 6), method)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 0), **TOL)


def test_resize_trilinear():
    vol = np.random.default_rng(3).normal(size=(6, 10, 8, 2)).astype(
        np.float32)
    want = np.asarray(jsample.resize_trilinear(jnp.asarray(vol), (9, 5, 12)))
    got = tsample.resize_trilinear(_t(np.moveaxis(vol, -1, 0)), (9, 5, 12))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 0), **TOL)


def test_one_hot_crop_single_and_batched():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 4, size=(16, 24, 20)).astype(np.int32)
    boxes = np.stack([_CROPS[k] / np.array([12, 20, 16, 12, 20, 16],
                                           np.float32)
                      for k in sorted(_CROPS)]).astype(np.float32)
    got = tsample.one_hot_crop(_t(labels), _t(boxes), (6, 5, 7), 4)
    assert got.shape == (len(boxes), 4, 6, 5, 7)
    for i, b in enumerate(boxes):
        want = np.asarray(jsample.one_hot_crop(jnp.asarray(labels),
                                               jnp.asarray(b), (6, 5, 7), 4))
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.moveaxis(want, -1, 0))
        np.testing.assert_array_equal(
            tsample.one_hot_crop(_t(labels), _t(b), (6, 5, 7), 4).numpy(),
            got[i].numpy())


# ---- losses -----------------------------------------------------------------

def _grad_pair(jf, tf, args, diff, tol=dict(rtol=1e-5, atol=1e-7)):
    """Value and the gradient w.r.t. argument ``diff`` of a JAX loss
    ``jf(*args)`` (channels last) and the port's ``tf`` (channels first
    where ``args`` says so: a tuple (array, True))."""
    jargs = [jnp.asarray(a) for a, _ in args]
    targs = [_t(_first(a)) if cf else _t(a) for a, cf in args]
    jv, jg = jax.value_and_grad(lambda v: jf(*jargs[:diff], v,
                                             *jargs[diff + 1:]))(jargs[diff])
    targs[diff].requires_grad_(True)
    tv = tf(*targs)
    (tg,) = torch.autograd.grad(tv, targs[diff])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    want = _first(jg) if args[diff][1] else np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), want, **tol)
    return float(tv.detach())


def test_rpn_and_mrcnn_losses():
    rng = np.random.default_rng(5)
    a = 40
    match = rng.choice([-1, 0, 1], size=a).astype(np.int8)
    logits = rng.normal(size=(a, 2)).astype(np.float32)
    tgt = rng.normal(size=(a, 6)).astype(np.float32)
    pred = (tgt + rng.normal(0, 1.2, size=(a, 6))).astype(np.float32)
    _grad_pair(JL.rpn_class_loss, TL.rpn_class_loss,
               [(match, False), (logits, False)], 1)
    _grad_pair(JL.rpn_bbox_loss, TL.rpn_bbox_loss,
               [(match, False), (tgt, False), (pred, False)], 2)
    r = 9
    ids = rng.integers(0, 2, size=r).astype(np.int32)
    valid = rng.uniform(size=r) > 0.3
    _grad_pair(JL.mrcnn_class_loss, TL.mrcnn_class_loss,
               [(ids, False), (valid, False), (logits[:r], False)], 2)
    pred3 = rng.normal(size=(r, 2, 6)).astype(np.float32)
    _grad_pair(JL.mrcnn_bbox_loss, TL.mrcnn_bbox_loss,
               [(tgt[:r], False), (ids, False), (valid, False),
                (pred3, False)], 3)
    # an empty selection gives 0
    none = np.zeros(a, np.int8)
    assert _grad_pair(JL.rpn_class_loss, TL.rpn_class_loss,
                      [(none, False), (logits, False)], 1) == 0.0


def _mask_inputs(seed, p, c, m):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, c, size=(p, m, m, m))
    lab[:, 2:-2, 2:-2, 2:-2] = 1
    onehot = np.eye(c, dtype=np.float32)[lab]
    logits = rng.normal(size=(p, m, m, m, c)).astype(np.float32)
    valid = np.array([True, False, True][:p])
    return onehot, valid, logits


@pytest.mark.parametrize("variant", ["heart", "lits"])
def test_mask_and_edge_losses(variant):
    if variant == "heart":
        jcfg, pcfg, c = tiny_config(), pconfig.tiny_config(), 4
    else:
        jcfg, pcfg, c = lits_config(), pconfig.lits_config(), 3
    onehot, valid, logits = _mask_inputs(6, 3, c, 8)
    _grad_pair(lambda t, v, lg: JL.mask_loss(t, v, lg, jcfg),
               lambda t, v, lg: TL.mask_loss(t, v, lg, pcfg),
               [(onehot, True), (valid, False), (logits, True)], 2)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    per_class = variant == "lits"
    _grad_pair(lambda t, v, q: JL.mask_edge_loss(t, v, q, jcfg,
                                                 per_class=per_class),
               lambda t, v, q: TL.mask_edge_loss(t, v, q, pcfg,
                                                 per_class=per_class),
               [(onehot, True), (valid, False), (probs, True)], 2,
               tol=dict(rtol=1e-5, atol=1e-6))


def test_weighted_total():
    parts = {k: np.float32(v) for k, v in zip(
        dict(lits_config().loss_weights), (0.7, 1.3, 0.2, 0.05, 2.5, 40.0))}
    want = float(JL.weighted_total({k: jnp.asarray(v)
                                    for k, v in parts.items()},
                                   lits_config()))
    got = float(TL.weighted_total({k: torch.tensor(v)
                                   for k, v in parts.items()},
                                  pconfig.lits_config()))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---- targets ----------------------------------------------------------------

@pytest.mark.parametrize("preset", ["tiny", "heart", "lits"])
def test_build_rpn_targets_bit_equal(preset):
    jcfg, pcfg = {"tiny": (tiny_config(), pconfig.tiny_config()),
                  "heart": (heart_config(), pconfig.heart_config()),
                  "lits": (lits_config(), pconfig.lits_config())}[preset]
    anchors = port_anchors(pcfg)
    np.testing.assert_array_equal(anchors, jax_anchors(jcfg))
    d, h, w = pcfg.image_shape
    for seed, gt in enumerate([
            np.array([0.2 * d, 0.3 * h, 0.25 * w, 0.7 * d, 0.8 * h, 0.7 * w]),
            np.array([0, 0, 0, d, h, w]),
            np.array([0.1 * d, 0.1 * h, 0.1 * w, 0.2 * d, 0.2 * h,
                      0.15 * w])]):
        gt = np.floor(gt).astype(np.float32)
        jm, jd = jtargets.build_rpn_targets(anchors, gt, jcfg,
                                            np.random.default_rng(seed))
        tm, td = ttargets.build_rpn_targets(anchors, gt, pcfg,
                                            np.random.default_rng(seed))
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(td, jd)
        assert tm.dtype == jm.dtype and td.dtype == jd.dtype


def _proposals(seed):
    """tests/test_train_step.py:62-73's proposals: ten near the GT, ten
    away from it."""
    rng = np.random.default_rng(seed)
    good = np.tile(np.array([0.26, 0.24, 0.25, 0.74, 0.73, 0.76]), (10, 1))
    good += rng.normal(0, 0.01, good.shape)
    bad = np.tile(np.array([0.0, 0.0, 0.0, 0.2, 0.2, 0.2]), (10, 1))
    bad += np.abs(rng.normal(0, 0.01, bad.shape))
    return np.concatenate([good, bad]).astype(np.float32)


def _key_uniforms(key, n):
    k_pos, k_neg = jax.random.split(key)
    return ttargets.TargetDraws(*(
        _t(np.asarray(jax.random.uniform(k, (n,)))) for k in (k_pos, k_neg)))


@pytest.mark.parametrize("stage,rois", [("beginning", 9), ("together", 9),
                                        ("beginning", 80)])
def test_detection_targets_equal_given_uniforms(stage, rois):
    """At 80 ROIs, 26 positives: the negative quota 26 / 0.33 - 26 =
    52.79 truncates to 52 (rounding would give 53)."""
    jcfg = tiny_config().replace(name="lits", num_classes=3, stage=stage,
                                 train_rois_per_image=rois)
    pcfg = pconfig.tiny_config().replace(name="lits", num_classes=3,
                                         stage=stage,
                                         train_rois_per_image=rois)
    props = _proposals(1)
    if rois > 9:  # 30 near the GT, 60 away from it
        props = np.concatenate([props[:10]] * 3 + [props[10:]] * 6)
    n = len(props)
    valid = np.ones(n, bool)
    valid[[2, 13]] = False
    gt = np.array([0.25, 0.25, 0.25, 0.75, 0.75, 0.75], np.float32)
    labels = np.zeros((32, 64, 64), np.int32)
    labels[8:24, 16:48, 16:48] = 1
    labels[12:20, 24:40, 24:40] = 2
    key = jax.random.PRNGKey(7)
    want = jtargets.detection_targets(key, jnp.asarray(props),
                                      jnp.asarray(valid), jnp.asarray(gt),
                                      jnp.asarray(labels), jcfg)
    got = ttargets.detection_targets(_t(props), _t(valid), _t(gt),
                                     _t(labels), pcfg,
                                     _key_uniforms(key, n))
    for name in ("rois", "roi_valid", "class_ids", "pos_rois", "pos_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(got.deltas.numpy(), np.asarray(want.deltas),
                               **TOL)
    np.testing.assert_array_equal(got.masks.numpy(), _first(want.masks))
    assert int(got.pos_valid.sum()) >= 1
    if rois > 9:
        assert int(got.pos_valid.sum()) == 26
        assert int(got.roi_valid.sum()) == 26 + 52


def test_detection_targets_invariants_under_a_generator():
    """tests/test_train_step.py:59-101 on the port, the draws from a
    torch.Generator."""
    cfg = pconfig.tiny_config()
    gt = torch.tensor([0.25, 0.25, 0.25, 0.75, 0.75, 0.75])
    labels = torch.zeros((32, 64, 64), dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    tgt = ttargets.detection_targets(
        _t(_proposals(1)), torch.ones(20, dtype=torch.bool), gt, labels, cfg,
        ttargets.draw_targets(20, gen, "cpu"))
    p_cap = cfg.num_positive_rois
    assert tgt.rois.shape == (cfg.train_rois_per_image, 6)
    assert tgt.pos_rois.shape == (p_cap, 6)
    assert tgt.masks.shape == (p_cap, cfg.num_classes, *cfg.mask_shape)
    n_pos = int(tgt.pos_valid.sum())
    assert n_pos == min(10, p_cap)
    want_neg = int(n_pos / cfg.roi_positive_ratio) - n_pos
    assert int(tgt.roi_valid.sum()) - n_pos == min(
        want_neg, cfg.train_rois_per_image - p_cap)
    ids = tgt.class_ids.numpy()
    assert np.all(ids[:p_cap][tgt.pos_valid.numpy()] == 1)
    assert np.all(ids[p_cap:] == 0)
    # the same generator state draws the same sample
    again = ttargets.detection_targets(
        _t(_proposals(1)), torch.ones(20, dtype=torch.bool), gt, labels, cfg,
        ttargets.draw_targets(20, torch.Generator().manual_seed(0), "cpu"))
    assert torch.equal(again.rois, tgt.rois)

    # no positives -> no negatives either (reference model.py:501)
    far = torch.tensor([0.4, 0.4, 0.4, 0.6, 0.6, 0.6])
    props = torch.tensor([[0.0, 0.0, 0.0, 0.1, 0.1, 0.1]]).repeat(8, 1)
    none = ttargets.detection_targets(props, torch.ones(8, dtype=torch.bool),
                                      far, labels, cfg,
                                      ttargets.draw_targets(8, gen, "cpu"))
    assert int(none.pos_valid.sum()) == 0 and int(none.roi_valid.sum()) == 0


# ---- dropout, labels, parameters ---------------------------------------------

@pytest.mark.parametrize("rate", [0.6, 0.25])
def test_channel_dropout_given_the_mask(rate):
    x = np.random.default_rng(8).normal(size=(3, 5, 4, 6, 7)).astype(
        np.float32)  # NDHWC
    key = jax.random.PRNGKey(3)
    want = np.asarray(jnn.channel_dropout(key, jnp.asarray(x), rate, False))
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - rate,
                                           (3, 1, 1, 1, 7)))
    got = tnn.channel_dropout(_t(_first(x)), rate, keep=_t(_first(keep)))
    np.testing.assert_array_equal(got.numpy(), _first(want))
    assert tnn.channel_dropout(_t(_first(x)), 0.0) is not None
    gen = torch.Generator().manual_seed(1)
    drawn = tnn.channel_dropout(_t(_first(x)), rate, generator=gen)
    zeroed = (drawn == 0).flatten(2).all(-1)
    assert 0 < int(zeroed.sum()) < zeroed.numel()


def test_pack_labels_roundtrip():
    labels = np.random.default_rng(9).integers(0, 16, size=(4, 6, 10))
    packed = pack_labels_w(labels)
    assert packed.shape == (4, 6, 5) and packed.dtype == np.uint8
    np.testing.assert_array_equal(unpack_labels_w(_t(packed)).numpy(),
                                  labels)


def test_params_to_numpy_inverts_params_from_numpy():
    jcfg = tiny_config()
    jp = jax_params(jcfg, 3)
    back = weights._flatten(weights.params_to_numpy(
        weights.params_from_numpy(jp, pconfig.tiny_config())))
    want = weights._flatten(jp)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], k)


# ---- the 1-channel convs' gradients -------------------------------------------

def _conv_grads(jf, tf, w, x):
    """Output and the gradients w.r.t. w and x of sum(out * r)."""
    jout = jf(jnp.asarray(w), jnp.asarray(x))
    r = np.random.default_rng(10).normal(size=jout.shape).astype(np.float32)
    jgw, jgx = jax.grad(lambda a, b: jnp.sum(jf(a, b) * r),
                        argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    tw = _t(w.transpose(4, 3, 0, 1, 2)).requires_grad_(True)
    tx = _t(_first(x)).requires_grad_(True)
    tout = tf(tw, tx)
    tgw, tgx = torch.autograd.grad(torch.sum(tout * _t(_first(r))), (tw, tx))
    for got, want in ((tout.detach().numpy(), _first(jout)),
                      (tgw.numpy(), np.asarray(jgw).transpose(4, 3, 0, 1, 2)),
                      (tgx.numpy(), _first(jgx))):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("kernel", [(3, 7, 7), (5, 7, 7)])
def test_stem_gradient_against_s2d(kernel):
    rng = np.random.default_rng(11)
    w = rng.normal(0, 0.1, size=(*kernel, 1, 6)).astype(np.float32)
    x = rng.normal(size=(1, 16, 24, 20, 1)).astype(np.float32)
    _conv_grads(lambda a, b: jnn.conv3d_stem_s2d({"w": a}, b),
                lambda a, b: tnn.conv3d({"w": a}, b, stride=2), w, x)


def test_unet_entry_conv_gradient_against_custom_vjp():
    rng = np.random.default_rng(12)
    w = rng.normal(0, 0.1, size=(3, 3, 3, 1, 5)).astype(np.float32)
    x = rng.normal(size=(2, 12, 10, 14, 1)).astype(np.float32)
    _conv_grads(lambda a, b: jnn.conv3d_1ch({"w": a}, b),
                lambda a, b: tnn.conv3d_1ch({"w": a}, b), w, x)


# ---- the optimizer chain -----------------------------------------------------

@pytest.mark.parametrize("stage", ["beginning", "together"])
def test_stage_masks_match_jax(stage):
    """trainable_mask and decay_mask pick the JAX package's leaves."""
    from cfun_tpu.train import step as jstep
    from cfun_tpu_torch.train import step as tstep

    jcfg = tiny_config().replace(name="lits", num_classes=3, stage=stage)
    pcfg = pconfig.tiny_config().replace(name="lits", num_classes=3,
                                         stage=stage)
    jp = jax_params(jcfg, 0)
    tp = weights.params_from_numpy(jp, pcfg)
    for jm, tm in ((jstep.trainable_mask(jp, jcfg),
                    tstep.trainable_mask(tp, pcfg)),
                   (jstep.decay_mask(jp), tstep.decay_mask(tp))):
        want = {k: bool(v) for k, v in weights._leaves(jm).items()}
        assert weights._leaves(tm) == want


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_chain_matches_optax(accum):
    """SGDChain against optax's chain (apply_update) over four steps of
    seeded gradients, one of them above the clip norm, with the learning
    rate and the weight decay raised to 0.1 so that the decay and the
    momentum show in every leaf: updated parameters rtol 1e-5 / atol
    1e-6 (float32 updates summed in another order)."""
    from cfun_tpu.train import step as jstep
    from cfun_tpu_torch.train import step as tstep

    over = dict(learning_rate=0.1, weight_decay=0.1, grad_accum_steps=accum)
    jcfg, pcfg = tiny_config(**over), pconfig.tiny_config(**over)
    jp = jax_params(jcfg, 0)
    jstate = jstep.make_train_step(jcfg, jax_anchors(jcfg))[0](
        jax.tree.map(jnp.asarray, jp))
    init, _ = tstep.make_train_step(pcfg, port_anchors(pcfg))
    tstate = init(weights.params_from_numpy(jp, pcfg))
    update = jax.jit(lambda s, g: jstep.apply_update(
        jcfg, s, g, jnp.zeros(()), {})[0])
    rng = np.random.default_rng(13)
    # global norms ~0.7, 1.4, 350 and 2.1: the clip acts on the third
    # step alone (and on the second accumulated mean), so a sum in place
    # of the accumulated mean shows
    for i, scale in enumerate((0.001, 0.002, 0.5, 0.003)):
        gj = jax.tree.map(lambda x: jnp.asarray(
            scale * rng.normal(size=np.shape(x)).astype(np.float32)), jp)
        gt = weights._leaves(weights.params_from_numpy(
            jax.tree.map(np.asarray, gj), pcfg))
        jstate = update(jstate, gj)
        tstate, _ = tstep.apply_update(
            pcfg, tstate, {p: gt[p] for p in tstate.opt_state.paths},
            torch.zeros(()), {})
        want = weights._flatten(jstate.params)
        got = weights._flatten(weights.params_to_numpy(tstate.params))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {i} {k}")


def test_clip_is_optax_clip():
    """The clip is optax's ``g / norm * max_norm`` (no ``+1e-6`` on the
    norm, as ``clip_grad_norm_`` has), shown where it matters: a global
    norm of 5e-7 against a clip of 1e-7, learning rate 1, no decay."""
    from cfun_tpu.train import step as jstep
    from cfun_tpu_torch.train import step as tstep

    over = dict(gradient_clip_norm=1e-7, learning_rate=1.0,
                weight_decay=0.0)
    jcfg, pcfg = tiny_config(**over), pconfig.tiny_config(**over)
    p0 = np.array([1e-7, -2e-7], np.float32)
    g = np.array([3e-7, 4e-7], np.float32)
    tree = {"fpn": {"p2_conv1": {"b": jnp.asarray(p0)}}}
    opt = jstep.make_optimizer(jcfg, tree)
    upd, _ = opt.update({"fpn": {"p2_conv1": {"b": jnp.asarray(g)}}},
                        opt.init(tree), tree)
    want = p0 + np.asarray(upd["fpn"]["p2_conv1"]["b"])
    leaf = torch.from_numpy(p0.copy()).requires_grad_(True)
    chain = tstep.make_optimizer(pcfg, {"fpn": {"p2_conv1": {"b": leaf}}})
    assert chain.update({"fpn/p2_conv1/b": torch.from_numpy(g)})
    np.testing.assert_allclose(leaf.detach().numpy(), want, rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(p0 - want, [6e-8, 8e-8], rtol=1e-5)


def test_fused_mask_head_refuses_dropout():
    """``fused=True`` has no dropout path: with a rate and masks it raises
    (cfun_tpu/models/heads.py:86-90) before any compute."""
    from cfun_tpu_torch.models.heads import apply_mask_head
    from cfun_tpu_torch.models.unet3d import dropout_mask_shapes

    cfg = pconfig.tiny_config()
    params = weights.init_params(cfg, seed=0)
    crops = torch.zeros((1, 1, 16, 16, 16), dtype=torch.bfloat16)
    masks = [torch.ones(s, dtype=torch.bool)
             for s in dropout_mask_shapes(1, cfg.unet_base_channels)]
    with pytest.raises(ValueError, match="dropout"):
        apply_mask_head(params["mask"], crops, stage="beginning",
                        dropout_rate=0.6, dropout_masks=masks,
                        dtype=torch.bfloat16, fused=True)
