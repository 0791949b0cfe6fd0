"""One training step of the port against the JAX package's, LiTS family,
on the CPU: a tiny LiTS configuration (P3D35, the (5, 7, 7) stem, three
classes with the mask loss's class weights (1, 1, 100), no dropout) at its
three stages: 'beginning' (detection only, the mask branch skipped, the
trunk checkpointed block by block as ``lits_config`` does), 'together' and
'finetune' (the mask branch only, with the per-class edge loss; the
trunk, RPN and classifier frozen).  Float32, shared weights, the JAX
step's own draws, as tests/test_torch_port_train_heart.py.

Criteria as there (tests/torch_port_train.py): loss parts rtol 1e-5,
gradient leaves within 1e-4 of their largest magnitude (the mask U-Net's
5e-4), updated parameters within 1e-6; and the leaves a stage freezes
bit-unchanged, with no gradient taken for them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfun_tpu import config as jconfig
from cfun_tpu.ops.anchors import config_anchors
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.train import step as tstep
from torch_port_params import jax_params
import torch_port_train as T

DETECTION = ("backbone", "fpn", "rpn", "classifier")


def _tiny_lits(mod, stage):
    """tests/test_lits_variant.py's ``_tiny_lits`` with the LiTS stem,
    exact top-k and the scan NMS; at 'finetune' the GT crops are 32^3, the
    size of the upscale head's output."""
    return mod.tiny_config(stage).replace(
        name="lits", num_classes=3, backbone="P3D35",
        backbone_stem_kernel=(5, 7, 7), intensity_norm="hu_window",
        pad_shape=(64, 128, 128), mask_class_weights=(1.0, 1.0, 100.0),
        unet_dropout_rate=0.0, mask_pool_size=(16, 16, 16),
        mask_shape_override=(32, 32, 32) if stage == "finetune"
        else (16, 16, 16),
        remat_trunk=(stage == "beginning"), nms_backend="scan",
        approx_topk=False)


@pytest.fixture(scope="module", params=["beginning", "together", "finetune"])
def step_ab(request):
    stage = request.param
    jcfg, pcfg = _tiny_lits(jconfig, stage), _tiny_lits(pconfig, stage)
    jp = jax_params(jcfg, 1)
    b = T.organ_batch(pcfg, weights.params_from_numpy(jp, pcfg), 1)
    key = jax.random.PRNGKey(5)
    _, jparts, jgrads, jnew = T.jax_step(jcfg)(
        jax.tree.map(jnp.asarray, jp), T.jax_batch(b), key)
    init, _ = tstep.make_train_step(pcfg, config_anchors(jcfg))
    state = init(weights.params_from_numpy(jp, pcfg))
    draws = T.jax_draws(key, jcfg, pcfg)
    assert draws.dropout_masks is None
    total, parts, grads = tstep.loss_and_grads(
        state.params, T.port_batch(b), torch.from_numpy(config_anchors(jcfg)),
        pcfg, draws)
    state, _ = tstep.apply_update(pcfg, state, grads, total, parts)
    return dict(stage=stage, jp=jp, jparts=jparts, jgrads=jgrads, jnew=jnew,
                parts=parts, grads=grads, state=state, pcfg=pcfg)


def test_loss_parts_match_jax(step_ab):
    parts, jparts = step_ab["parts"], step_ab["jparts"]
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=T.PARTS_RTOL, err_msg=k)
    det, mask, edge = tstep.stage_flags(step_ab["pcfg"])
    for k, v in parts.items():
        on = (det and not k.startswith("mrcnn_mask")) or \
            (mask and k == "mrcnn_mask_loss") or \
            (edge and k == "mrcnn_mask_edge_loss")
        assert (float(v) > 0) if on else (float(v) == 0.0), k


def test_gradients_match_jax(step_ab):
    jg = T.flat_numpy(step_ab["jgrads"])
    tg = T.flat_numpy(weights.params_to_numpy(
        weights._unflatten(step_ab["grads"])))
    det = step_ab["stage"] == "beginning"
    want = {k for k in jg if not k.endswith(("/mean", "/var"))
            and (k.split("/")[0] in DETECTION) == det}
    assert set(tg) == want
    for k in sorted(tg):
        T.assert_grad_close(tg[k], jg[k], k)


def test_updated_params_match_jax_frozen_unchanged(step_ab):
    jn, j0 = T.flat_numpy(step_ab["jnew"]), T.flat_numpy(step_ab["jp"])
    tn = T.flat_numpy(weights.params_to_numpy(step_ab["state"].params))
    det = step_ab["stage"] == "beginning"
    for k in jn:
        np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=T.PARAM_ATOL,
                                   err_msg=k)
        frozen = k.endswith(("/mean", "/var")) or \
            (k.split("/")[0] in DETECTION) != det
        assert np.array_equal(tn[k], j0[k]) == frozen, k
