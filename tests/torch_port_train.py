"""Shared pieces of the port's training A/Bs (tests/test_torch_port_train_*):
one JAX train step compiled per configuration, the JAX step's own random
draws rebuilt for the port, and a tiny batch whose organ sits on one of the
proposals, so that the ROI sample has positives and the mask branch runs.

The JAX step splits its key as ``train/step.py:130`` (k_tgt, k_drop),
``targets.py:121`` (k_pos, k_neg) and ``nn.key_iter`` (one dropout key per
site) do; ``jax_draws`` makes the same draws from the same key and hands
them to the port as ``TrainDraws``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cfun_tpu import nn as jnn
from cfun_tpu.ops.anchors import config_anchors
from cfun_tpu.train.step import TrainBatch as JaxBatch
from cfun_tpu.train.step import apply_update as jax_apply_update
from cfun_tpu.train.step import make_train_step as jax_make_train_step
from cfun_tpu.train.step import train_forward as jax_train_forward
from cfun_tpu_torch import weights
from cfun_tpu_torch.data.batch import TrainBatch
from cfun_tpu_torch.data.feeder import np_mask_to_extended_bbox
from cfun_tpu_torch.models import cfun as tcfun
from cfun_tpu_torch.models.unet3d import dropout_mask_shapes
from cfun_tpu_torch.train.step import TrainDraws, stage_flags
from cfun_tpu_torch.train.targets import TargetDraws, build_rpn_targets

# A/B tolerances (float32 on both sides; convolutions and reductions sum
# in different orders): loss parts, each gradient leaf against its largest
# magnitude, updated parameters in absolute terms
PARTS_RTOL = 1e-5
LOSS_KEYS = ("rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss",
             "mrcnn_bbox_loss", "mrcnn_mask_loss", "mrcnn_mask_edge_loss")
GRAD_REL = 1e-4
PARAM_ATOL = 1e-6


def jax_step(jcfg):
    """jit of (params, batch, key) -> (total, parts, grads, params after one
    step from a fresh optimizer state), the JAX package's step taken apart
    so its gradients show."""
    anchors = jnp.asarray(config_anchors(jcfg))
    init_state, _ = jax_make_train_step(jcfg, config_anchors(jcfg))

    def f(params, batch, key):
        (total, parts), grads = jax.value_and_grad(
            jax_train_forward, has_aux=True)(params, batch, anchors, jcfg,
                                             key)
        state, _ = jax_apply_update(jcfg, init_state(params), grads, total,
                                    parts)
        return total, parts, grads, state.params

    return jax.jit(f)


def jax_draws(key, jcfg, pcfg, device="cpu") -> TrainDraws:
    """The JAX step's draws for ``key`` as the port's TrainDraws."""
    k_tgt, k_drop = jax.random.split(key)
    k_pos, k_neg = jax.random.split(k_tgt)
    n = jcfg.post_nms_rois_training
    u = [torch.from_numpy(np.asarray(jax.random.uniform(k, (n,))).copy())
         for k in (k_pos, k_neg)]
    masks = None
    if stage_flags(pcfg)[1] and jcfg.unet_dropout_rate > 0.0:
        keys = jnn.key_iter(k_drop)
        masks = []
        for b, c, *_ in dropout_mask_shapes(jcfg.num_positive_rois,
                                            jcfg.unet_base_channels):
            keep = jax.random.bernoulli(next(keys),
                                        1.0 - jcfg.unet_dropout_rate,
                                        (b, 1, 1, 1, c))
            masks.append(torch.from_numpy(
                np.asarray(keep).transpose(0, 4, 1, 2, 3).copy()).to(device))
    return TrainDraws(TargetDraws(u[0].to(device), u[1].to(device)), masks)


def organ_batch(pcfg, tparams, seed, pick=0):
    """A tiny batch (numpy): a noise image, and nested class boxes inside
    the port's ``pick``-th proposal for that image (classes 1.. C-1), the
    GT box from them as the feeder makes it, RPN targets from
    ``build_rpn_targets`` at ``seed``.  Returns a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    d, h, w = pcfg.image_shape
    image = rng.normal(size=(d, h, w)).astype(np.float32)
    anchors = config_anchors(pcfg)
    with torch.no_grad():
        trunk = tcfun.apply_trunk(tparams, torch.from_numpy(image)[None, None],
                                  pcfg)
        props, valid = tcfun.propose(trunk.rpn_logits[0], trunk.rpn_deltas[0],
                                     torch.from_numpy(anchors), pcfg,
                                     pcfg.post_nms_rois_training)
    assert bool(valid[pick])
    box = props[pick].numpy() * np.array([d, h, w, d, h, w], np.float32)
    lo = np.ceil(box[:3]).astype(int)
    hi = np.maximum(np.floor(box[3:]).astype(int), lo + 2)
    labels = np.zeros((d, h, w), np.int32)
    for cls in range(1, pcfg.num_classes):
        f = (cls - 1) / (2 * pcfg.num_classes)
        a = lo + np.floor(f * (hi - lo)).astype(int)
        b = hi - np.floor(f * (hi - lo)).astype(int)
        labels[a[0]:b[0], a[1]:b[1], a[2]:b[2]] = cls
    gt_box = np_mask_to_extended_bbox(labels)
    match, deltas = build_rpn_targets(anchors, gt_box, pcfg,
                                      np.random.default_rng(seed))
    norm = np.array([d, h, w, d, h, w], np.float32)
    return dict(image=image, rpn_match=match, rpn_deltas=deltas,
                gt_box_norm=gt_box / norm, labels=labels)


def jax_batch(b):
    return JaxBatch(image=jnp.asarray(b["image"])[None, ..., None],
                    rpn_match=jnp.asarray(b["rpn_match"]),
                    rpn_deltas=jnp.asarray(b["rpn_deltas"]),
                    gt_box_norm=jnp.asarray(b["gt_box_norm"]),
                    labels=jnp.asarray(b["labels"]))


def port_batch(b, device="cpu"):
    return TrainBatch(image=torch.from_numpy(b["image"])[None, None],
                      rpn_match=torch.from_numpy(b["rpn_match"]),
                      rpn_deltas=torch.from_numpy(b["rpn_deltas"]),
                      gt_box_norm=torch.from_numpy(b["gt_box_norm"]),
                      labels=torch.from_numpy(b["labels"])).to(device)


def flat_numpy(tree):
    """A JAX tree (or port tree through ``weights.params_to_numpy``) as
    {tree path: numpy}, list indices as plain numbers."""
    return weights._flatten(tree)


def jax_total(jparts, pcfg):
    """The weighted total of the JAX step's parts, as the port weighs."""
    w = pcfg.loss_weight_dict
    return sum(w[k] * float(jparts[k]) for k in w)


def assert_grad_close(got, want, path):
    """One gradient leaf: within GRAD_REL of its largest magnitude (5x that
    on the mask U-Net's leaves, see the step tests' docstrings)."""
    rel = 5 * GRAD_REL if path.startswith("mask/unet/") else GRAD_REL
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (f"{path}: max error {err:.3g} > {rel:g} x "
                                f"max magnitude {scale:.3g}")


def precision_probe(crop=32):
    """Where the mask U-Net's gradient differences come from (run as
    ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_port_train.py``): one heart
    'beginning' step of tiny_config with ``crop``^3 RoI crops through the
    JAX package and the port in float32, and the port once more with its
    convolutions, matmuls and activations in float64 (its instance-norm
    statistics and loss casts stay float32).  Prints each side's largest
    U-Net gradient error against the float64 run and against each other,
    relative to each leaf's largest magnitude.  Not at the tests' 16^3
    crops: there the deepest level is one voxel, whose float32 mean
    differs from a float64 activation, so that run is no reference."""
    import cfun_tpu_torch.models.cfun as tcfun_mod
    from cfun_tpu.config import tiny_config
    from cfun_tpu_torch import config as pconfig
    from cfun_tpu_torch.ops.sorted_nms import sorted_nms_reference
    from cfun_tpu_torch.train import step as tstep
    from torch_port_params import jax_params

    ov = dict(nms_backend="scan", approx_topk=False,
              mask_pool_size=(crop,) * 3, mask_shape_override=(crop,) * 3)
    jcfg, pcfg = tiny_config(**ov), pconfig.tiny_config(**ov)
    jp = jax_params(jcfg, 0)
    b = organ_batch(pcfg, weights.params_from_numpy(jp, pcfg), 0)
    key = jax.random.PRNGKey(3)
    _, _, jgrads, _ = jax_step(jcfg)(jax.tree.map(jnp.asarray, jp),
                                     jax_batch(b), key)
    draws = jax_draws(key, jcfg, pcfg)
    anchors = torch.from_numpy(config_anchors(jcfg))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        params = weights._unflatten({
            k: v.to(dtype) for k, v in
            weights._leaves(weights.params_from_numpy(jp, pcfg)).items()})
        batch = port_batch(b)
        batch = batch._replace(image=batch.image.to(dtype),
                               rpn_deltas=batch.rpn_deltas.to(dtype),
                               gt_box_norm=batch.gt_box_norm.to(dtype))
        d = draws._replace(targets=TargetDraws(
            *(u.to(dtype) for u in draws.targets)))
        init, _ = tstep.make_train_step(pcfg, config_anchors(jcfg))
        # the config's 'float32' compute dtype read as ``dtype``
        tcfun_mod._DTYPES["float32"] = dtype
        try:
            _, _, g = tstep.loss_and_grads(
                init(params).params, batch, anchors.to(dtype), pcfg, d,
                nms=lambda bx, v, t, k: sorted_nms_reference(bx.float(), v,
                                                             t, k))
        finally:
            tcfun_mod._DTYPES["float32"] = torch.float32
        grads[dtype] = flat_numpy(weights.params_to_numpy(
            weights._unflatten(g)))
    jg = flat_numpy(jgrads)

    def worst(a, ref):
        return max((float(np.abs(a[k] - ref[k]).max()
                          / np.abs(ref[k]).max()), k)
                   for k in ref if k.startswith("mask/unet/")
                   and np.abs(ref[k]).max() > 0)

    ref = grads[torch.float64]
    print(f"{crop}^3 crops, largest U-Net gradient error over the leaf's "
          f"largest magnitude:")
    print(f"  JAX float32 vs port float64:  {worst(jg, ref)}")
    print(f"  port float32 vs port float64: "
          f"{worst(grads[torch.float32], ref)}")
    print(f"  port float32 vs JAX float32:  {worst(grads[torch.float32], jg)}")


if __name__ == "__main__":
    precision_probe()
