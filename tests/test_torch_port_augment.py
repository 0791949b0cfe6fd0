"""The port's device augment (``cfun_tpu_torch/ops/augment.py``) against
the JAX package's (``cfun_tpu/ops/augment.py``), on the CPU: the port's
counterparts of tests/test_device_augment.py.

Criteria: the rotation equal at 0 and 90 degrees and on >= 99.9% of the
voxels at other angles (each package takes its own float32 sine and
cosine, so a voxel at a rounding tie may pick its neighbour, as the JAX
test allows against the float64 host); the GT box exact, empty volume
included; the RPN targets exact given the uniforms JAX draws from its
split keys (deltas to 1e-6); an empty GT neutral and finite; at angle 0
the augmented batch equal to the host feeder's (image to 2e-5, as
tests/test_device_augment.py:258); and one train step on an
``AugTrainBatch`` equal to the JAX step's at tests/torch_port_train.py's
tolerances (loss parts rtol 1e-5, gradients 1e-4 of each leaf's largest
magnitude (5e-4 on the mask U-Net), parameters 1e-6), at -3 degrees.
At +1 and +3 degrees the loss parts, the gradient leaves outside the mask
U-Net and the parameters they update agree at the same tolerances, but
the JAX step's U-Net gradient leaves part from the port's by up to 4.4%
of their largest magnitude.  A float64 evaluation of the U-Net's VJP
(instance-norm statistics and the mask loss in float64 too) on the same
crops settles it: at +1 degree the JAX step's float32 U-Net gradient
sits up to 4.4% from it, the port's within 2.5e-5, and the float64
gradients on the two packages' crops (1-ulp apart, each package's own
float32 re-z-score) agree to 6.7e-6; so the gap is XLA:CPU's float32
evaluation, not the port (ROADMAP.md, section C).  At +1 and +3 degrees
the port's U-Net gradient leaves are therefore held to that float64
evaluation, within 1e-4 of each leaf's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfun_tpu import config as jconfig
from cfun_tpu.ops import augment as jaug
from cfun_tpu.ops.anchors import config_anchors
from cfun_tpu.train.step import apply_update as jax_apply_update
from cfun_tpu.train.step import make_train_step as jax_make_train_step
from cfun_tpu.train.step import pack_labels_w as jax_pack_labels_w
from cfun_tpu.train.step import train_forward_any as jax_forward_any
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.data.datasets import SyntheticDataset
from cfun_tpu_torch.data.feeder import TrainFeeder, np_mask_to_extended_bbox
from cfun_tpu_torch import nn as pnn
from cfun_tpu_torch.models.unet3d import apply_unet
from cfun_tpu_torch.ops import augment as paug
from cfun_tpu_torch.train import step as tstep
from torch_port_params import jax_params
import torch_port_train as T


def _labels_volume(shape=(8, 40, 40), seed=0):
    d, h, w = shape
    rng = np.random.default_rng(seed)
    labels = np.zeros(shape, np.int32)
    zz, yy, xx = np.ogrid[:d, :h, :w]
    cy, cx = rng.integers(14, 26), rng.integers(14, 26)
    ball = (((zz - d / 2) / (d / 3)) ** 2 + ((yy - cy) / 9.0) ** 2
            + ((xx - cx) / 7.0) ** 2) < 1.0
    labels[ball] = 2
    return labels


def jax_augment_draws(key, num_anchors):
    """The uniforms ``rpn_targets_device`` draws from ``key``."""
    k_pos, k_neg = jax.random.split(key)
    return paug.AugmentDraws(*(
        torch.from_numpy(np.array(jax.random.uniform(k, (num_anchors,))))
        for k in (k_pos, k_neg)))


@pytest.mark.parametrize("angle", [0.0, 90.0, 12.0, -33.5, 20.0])
def test_rotate_device_matches_jax(angle):
    rng = np.random.default_rng(1)
    vol = rng.normal(size=(6, 40, 40)).astype(np.float32)
    labels = _labels_volume((6, 40, 40))
    for x, fill in ((vol, -1.5), (labels, 0)):
        want = np.asarray(jaug.rotate_hw_device(jnp.asarray(x), angle, fill))
        got = paug.rotate_hw_device(torch.from_numpy(x), angle, fill).numpy()
        assert got.dtype == want.dtype
        if angle in (0.0, 90.0):
            np.testing.assert_array_equal(got, want)
        else:
            assert np.mean(got == want) >= 0.999, (angle, np.mean(got == want))


def test_rotate_device_fill_value():
    out = paug.rotate_hw_device(torch.ones(2, 16, 16), 45.0, -3.5).numpy()
    assert out[0, 0, 0] == -3.5
    assert np.all(np.isin(out, (1.0, np.float32(-3.5))))


@pytest.mark.parametrize("which", ["organ", "corner", "empty"])
def test_extended_bbox_matches_jax(which):
    labels = _labels_volume()
    if which == "corner":
        labels = np.zeros_like(labels)
        labels[0, 0, 0] = labels[7, 39, 39] = 1
    elif which == "empty":
        labels = np.zeros_like(labels)
    got = paug.extended_bbox(torch.from_numpy(labels)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jaug.extended_bbox(jnp.asarray(labels))))
    np.testing.assert_array_equal(got, np_mask_to_extended_bbox(labels))


@pytest.mark.parametrize("gt", [[8, 16, 16, 24, 48, 48], [2, 3, 5, 9, 20, 14],
                                [0, 0, 0, 32, 64, 64]])
def test_rpn_targets_device_matches_jax(gt):
    cfg = jconfig.tiny_config(approx_topk=False)
    anchors = config_anchors(cfg).astype(np.float32)
    gt = np.array(gt, np.float32)
    key = jax.random.PRNGKey(4)
    jm, jd = jaug.rpn_targets_device(jnp.asarray(anchors), jnp.asarray(gt),
                                     cfg, key)
    pm, pd = paug.rpn_targets_device(
        torch.from_numpy(anchors), torch.from_numpy(gt),
        pconfig.tiny_config(), jax_augment_draws(key, len(anchors)))
    assert pm.dtype == torch.int8
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert int((pm == 1).sum()) >= 1
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_rpn_targets_device_empty_gt_is_neutral_and_finite():
    cfg = pconfig.tiny_config()
    anchors = torch.from_numpy(config_anchors(cfg).astype(np.float32))
    draws = tstep.draw_train(cfg.replace(augment_on_device=True),
                             torch.Generator().manual_seed(0), "cpu").augment
    match, deltas = paug.rpn_targets_device(anchors, torch.zeros(6), cfg,
                                            draws)
    assert torch.all(match == 0)
    assert torch.all(torch.isfinite(deltas)) and torch.all(deltas == 0)


def test_device_augment_angle_zero_reproduces_host_batch():
    """tests/test_device_augment.py:132: at angle 0 the rotation is the
    identity and re-z-scoring is a no-op."""
    cfg = pconfig.tiny_config()
    d, h, w = cfg.image_shape
    rng = np.random.default_rng(3)
    molded = rng.normal(2.0, 4.0, size=(d, h, w)).astype(np.float32)
    labels = _labels_volume((d, h, w))
    m, s = molded.mean(), molded.std()
    y = (molded - m) / s
    aug = paug.AugTrainBatch(image=torch.from_numpy(y)[None, None],
                             labels=torch.from_numpy(jax_pack_labels_w(
                                 labels)),
                             angle=0.0, fill=float(-m / s))
    anchors = torch.from_numpy(config_anchors(cfg).astype(np.float32))
    draws = tstep.draw_train(cfg.replace(augment_on_device=True),
                             torch.Generator().manual_seed(7), "cpu")
    batch = paug.device_augment(aug, anchors, cfg, draws.augment)
    np.testing.assert_allclose(batch.image[0, 0].numpy(), y, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(batch.labels.numpy(), labels)
    norm = np.array([d, h, w, d, h, w], np.float32)
    np.testing.assert_allclose(batch.gt_box_norm.numpy(),
                               np_mask_to_extended_bbox(labels) / norm,
                               atol=1e-6)


def test_device_augment_matches_host_feeder_at_angle_zero():
    """tests/test_device_augment.py:258: the same image, labels and GT box
    reach the forward as the host feeder's at angle 0."""
    cfg = pconfig.tiny_config()
    ds = SyntheticDataset(cfg, n=1, seed=0)
    anchors = config_anchors(cfg)
    acfg = cfg.replace(augment_on_device=True)
    host = TrainFeeder(ds, cfg, anchors, seed=0, num_workers=1)
    aug = TrainFeeder(ds, acfg, anchors, seed=0, num_workers=1)
    try:
        host_item = host.make_item(0, angle=0.0, seed=5)
        aug_item = aug.make_item(0, angle=0.0, seed=5)
    finally:
        host.close()
        aug.close()
    draws = tstep.draw_train(acfg, torch.Generator().manual_seed(42), "cpu")
    batch = paug.device_augment(aug_item, torch.from_numpy(anchors), acfg,
                                draws.augment)
    np.testing.assert_allclose(batch.image.numpy(), host_item.image.numpy(),
                               atol=2e-5)
    np.testing.assert_array_equal(
        batch.labels.numpy(), tstep.unpack_labels_w(host_item.labels).numpy())
    np.testing.assert_allclose(batch.gt_box_norm.numpy(),
                               host_item.gt_box_norm.numpy(), atol=1e-6)


AUG = dict(nms_backend="scan", approx_topk=False, augment_on_device=True)


@pytest.fixture(scope="module")
def aug_jax_step():
    """The JAX step on an ``AugTrainBatch`` taken apart (total, parts,
    gradients, parameters after one update), jitted once for every
    angle."""
    jcfg = jconfig.tiny_config(**AUG)
    janchors = jnp.asarray(config_anchors(jcfg))
    init_state, _ = jax_make_train_step(jcfg, config_anchors(jcfg))

    def f(params, batch, key):
        (total, parts), grads = jax.value_and_grad(
            jax_forward_any, has_aux=True)(params, batch, janchors, jcfg, key)
        state, _ = jax_apply_update(jcfg, init_state(params), grads, total,
                                    parts)
        return total, parts, grads, state.params

    return jax.jit(f)


def _aug_step_ab(jax_step, angle, record=None):
    """One JAX step and one port step on the same ``AugTrainBatch`` (an
    organ on one of the port's proposals, rotated by ``angle`` degrees),
    weights and draws.  ``record``: a dict that gets the port step's mask
    crops, targets and draws."""
    jcfg, pcfg = jconfig.tiny_config(**AUG), pconfig.tiny_config(**AUG)
    jp = jax_params(jcfg, 0)
    b = T.organ_batch(pcfg, weights.params_from_numpy(jp, pcfg), 0)
    m, s = float(b["image"].mean()), float(b["image"].std())
    y = ((b["image"] - m) / s).astype(np.float32)
    packed = jax_pack_labels_w(b["labels"])
    fill = np.float32(-m / s)
    key = jax.random.PRNGKey(3)
    jbatch = jaug.AugTrainBatch(image=jnp.asarray(y)[None, ..., None],
                                labels=jnp.asarray(packed),
                                angle=jnp.float32(angle),
                                fill=jnp.float32(fill))
    jt, jparts, jgrads, jnew = jax_step(jax.tree.map(jnp.asarray, jp),
                                        jbatch, key)
    k_aug, k_rest = jax.random.split(key)
    draws = T.jax_draws(k_rest, jcfg, pcfg)._replace(
        augment=jax_augment_draws(k_aug, pcfg.num_anchors))
    init, _ = tstep.make_train_step(pcfg, config_anchors(jcfg))
    state = init(weights.params_from_numpy(jp, pcfg))
    pbatch = paug.AugTrainBatch(image=torch.from_numpy(y)[None, None],
                                labels=torch.from_numpy(packed),
                                angle=angle, fill=float(fill))
    mp = pytest.MonkeyPatch()
    if record is not None:
        def roi(*args, **kw):
            record["crops"] = roi_align(*args, **kw)
            return record["crops"]

        def targets(*args, **kw):
            record["targets"] = detection_targets(*args, **kw)
            return record["targets"]

        roi_align, detection_targets = tstep.roi_align, tstep.detection_targets
        mp.setattr(tstep, "roi_align", roi)
        mp.setattr(tstep, "detection_targets", targets)
        record["draws"] = draws
    try:
        total, parts, grads = tstep.loss_and_grads(
            state.params, pbatch, torch.from_numpy(config_anchors(jcfg)),
            pcfg, draws)
    finally:
        mp.undo()
    state, _ = tstep.apply_update(pcfg, state, grads, total, parts)
    return dict(jp=jp, jparts=jparts, jgrads=jgrads, jnew=jnew, parts=parts,
                grads=grads, state=state, pcfg=pcfg)


@pytest.fixture(scope="module")
def aug_step_ab(aug_jax_step):
    return _aug_step_ab(aug_jax_step, -3.0)


def test_aug_step_loss_parts_match_jax(aug_step_ab):
    parts, jparts = aug_step_ab["parts"], aug_step_ab["jparts"]
    assert sorted(parts) == sorted(jparts)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=T.PARTS_RTOL, err_msg=k)
    assert float(parts["mrcnn_mask_loss"]) > 0  # the mask branch ran


def test_aug_step_gradients_and_params_match_jax(aug_step_ab):
    jg = T.flat_numpy(aug_step_ab["jgrads"])
    tg = T.flat_numpy(weights.params_to_numpy(
        weights._unflatten(aug_step_ab["grads"])))
    for k in sorted(tg):
        T.assert_grad_close(tg[k], jg[k], k)
    jn = T.flat_numpy(aug_step_ab["jnew"])
    tn = T.flat_numpy(weights.params_to_numpy(aug_step_ab["state"].params))
    for k in jn:
        np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=T.PARAM_ATOL,
                                   err_msg=k)


def _unet_grads_float64(params, record, cfg):
    """The mask loss's gradient with respect to the U-Net's leaves, every
    operation in float64 (the instance-norm statistics and the loss too),
    on the crops, targets and dropout masks the port's step used."""
    def inorm64(x, eps=1e-5):
        dims = tuple(range(2, x.dim()))
        diff = x - x.mean(dim=dims, keepdim=True)
        return diff * torch.rsqrt(torch.mean(diff * diff, dim=dims,
                                             keepdim=True) + eps)

    unet = {k: v.detach().double().requires_grad_(True)
            for k, v in weights._leaves(params["mask"]["unet"]).items()}
    tgt = record["targets"]
    mp = pytest.MonkeyPatch()
    mp.setattr(pnn, "instance_norm", inorm64)
    try:
        logits = apply_unet(weights._unflatten(unet),
                            record["crops"].detach().double(),
                            stage=cfg.stage,
                            dropout_rate=cfg.unet_dropout_rate,
                            dropout_masks=record["draws"].dropout_masks,
                            dtype=torch.float64)
    finally:
        mp.undo()
    t = tgt.masks.double()
    ce = torch.logsumexp(logits, dim=1) - torch.sum(logits * t, dim=1)
    valid = tgt.pos_valid[:, None, None, None].double().expand(ce.shape)
    loss = cfg.loss_weight_dict["mrcnn_mask_loss"] * torch.sum(ce * valid) \
        / torch.clamp(torch.sum(valid), min=1.0)
    grads = torch.autograd.grad(loss, list(unet.values()), allow_unused=True)
    return {f"mask/unet/{k}": np.zeros(v.shape) if g is None else g.numpy()
            for (k, v), g in zip(unet.items(), grads)}


@pytest.mark.parametrize("angle", [1.0, 3.0])
def test_aug_step_at_positive_angles(aug_jax_step, angle):
    """At +1 and +3 degrees: the loss parts, every gradient leaf outside
    the mask U-Net and the parameters those update equal the JAX step's at
    the step tests' tolerances; the U-Net's gradient leaves, where the JAX
    step's float32 evaluation parts from the float64 one (module
    docstring), are held to the float64 evaluation on the port's own crops
    within 1e-4 of each leaf's largest magnitude."""
    record = {}
    ab = _aug_step_ab(aug_jax_step, angle, record)
    for k in ab["parts"]:
        np.testing.assert_allclose(float(ab["parts"][k]),
                                   float(ab["jparts"][k]),
                                   rtol=T.PARTS_RTOL, err_msg=k)
    assert float(ab["parts"]["mrcnn_mask_loss"]) > 0
    jg = T.flat_numpy(ab["jgrads"])
    tg = T.flat_numpy(weights.params_to_numpy(
        weights._unflatten(ab["grads"])))
    jn = T.flat_numpy(ab["jnew"])
    tn = T.flat_numpy(weights.params_to_numpy(ab["state"].params))
    f64 = _unet_grads_float64(weights.params_from_numpy(ab["jp"], ab["pcfg"]),
                              record, ab["pcfg"])
    for k in sorted(tg):
        if k.startswith("mask/unet/"):
            want = weights.params_to_numpy(weights._unflatten(
                {k: torch.from_numpy(f64[k])}))
            want = T.flat_numpy(want)[k]
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(tg[k] - want).max())
            assert err <= T.GRAD_REL * scale, (k, err, scale)
        else:
            T.assert_grad_close(tg[k], jg[k], k)
            np.testing.assert_allclose(tn[k], jn[k], rtol=0,
                                       atol=T.PARAM_ATOL, err_msg=k)
