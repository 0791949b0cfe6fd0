"""One training step of the port against the JAX package's, heart family,
on the CPU: tiny_config at stages 'beginning' and 'finetune' (the latter
with ``remat_unet``, dropout 0.6 and the edge loss), float32, shared
weights (tests/torch_port_params.py), the JAX step's own random draws fed
to the port (tests/torch_port_train.py), K1's plain version on the port's
side and the scan NMS on JAX's.  The batch's organ sits on one of the
proposals, so the ROI sample has positives and the mask branch runs.

Criteria (tests/torch_port_train.py): the six loss parts to rtol 1e-5;
every trainable gradient leaf within 1e-4 of the leaf's largest magnitude,
but the mask U-Net's leaves within 5e-4: there the JAX step's own float32
evaluation on XLA:CPU sits up to 4.8e-4 from a float64 evaluation of the
same graph (at 32^3 crops), while the port's stays within 4e-5
(``precision_probe`` in tests/torch_port_train.py prints both); every
updated parameter within 1e-6; frozen leaves bit-unchanged.  Then the
port's counterparts of tests/test_train_step.py's step tests (gradient
accumulation, frozen BN statistics, packed labels, the int8 wire) with
that file's tolerances, and the exactness of the checkpointed U-Net with
dropout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfun_tpu.config import tiny_config
from cfun_tpu.ops.anchors import config_anchors
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.train import step as tstep
from torch_port_params import jax_params
import torch_port_train as T

STAGES = {"beginning": dict(), "finetune": dict(remat_unet=True)}


def _cfgs(stage, **extra):
    ov = dict(nms_backend="scan", approx_topk=False, **STAGES[stage],
              **extra)
    return tiny_config(stage, **ov), pconfig.tiny_config(stage, **ov)


@pytest.fixture(scope="module", params=sorted(STAGES))
def step_ab(request):
    """One JAX step and one port step from the same weights, batch and
    draws."""
    stage = request.param
    jcfg, pcfg = _cfgs(stage)
    jp = jax_params(jcfg, 0)
    b = T.organ_batch(pcfg, weights.params_from_numpy(jp, pcfg), 0)
    key = jax.random.PRNGKey(3)
    jt, jparts, jgrads, jnew = T.jax_step(jcfg)(
        jax.tree.map(jnp.asarray, jp), T.jax_batch(b), key)
    init, _ = tstep.make_train_step(pcfg, config_anchors(jcfg))
    state = init(weights.params_from_numpy(jp, pcfg))
    draws = T.jax_draws(key, jcfg, pcfg)
    anchors = torch.from_numpy(config_anchors(jcfg))
    total, parts, grads = tstep.loss_and_grads(
        state.params, T.port_batch(b), anchors, pcfg, draws)
    state, metrics = tstep.apply_update(pcfg, state, grads, total, parts)
    return dict(stage=stage, jp=jp, jparts=jparts, jgrads=jgrads, jnew=jnew,
                parts=parts, grads=grads, state=state, metrics=metrics,
                pcfg=pcfg)


def test_loss_parts_match_jax(step_ab):
    parts, jparts = step_ab["parts"], step_ab["jparts"]
    assert sorted(parts) == sorted(jparts)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=T.PARTS_RTOL, err_msg=k)
    assert float(parts["mrcnn_mask_loss"]) > 0  # positives: the mask ran
    edge = float(parts["mrcnn_mask_edge_loss"])
    assert edge > 0 if step_ab["stage"] == "finetune" else edge == 0
    total = float(step_ab["metrics"]["total_loss"])
    np.testing.assert_allclose(total, float(T.jax_total(jparts,
                                                        step_ab["pcfg"])),
                               rtol=T.PARTS_RTOL)


def test_gradients_match_jax(step_ab):
    jg = T.flat_numpy(step_ab["jgrads"])
    tg = T.flat_numpy(weights.params_to_numpy(
        weights._unflatten(step_ab["grads"])))
    trainable = {k for k in jg if not k.endswith(("/mean", "/var"))}
    assert set(tg) == trainable
    for k in sorted(tg):
        T.assert_grad_close(tg[k], jg[k], k)


def test_updated_params_match_jax(step_ab):
    jn, j0 = T.flat_numpy(step_ab["jnew"]), T.flat_numpy(step_ab["jp"])
    tn = T.flat_numpy(weights.params_to_numpy(step_ab["state"].params))
    assert sorted(tn) == sorted(jn)
    moved = 0
    for k in jn:
        np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=T.PARAM_ATOL,
                                   err_msg=k)
        if k.endswith(("/mean", "/var")):
            np.testing.assert_array_equal(tn[k], j0[k], k)
        moved += not np.array_equal(tn[k], j0[k])
    assert moved == len([k for k in jn if not k.endswith(("/mean", "/var"))])


# ---- the port's counterparts of tests/test_train_step.py ---------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg, pcfg = _cfgs("beginning")
    jp = jax_params(jcfg, 0)
    batches = [T.organ_batch(pcfg, weights.params_from_numpy(jp, pcfg), s,
                             pick=p) for s, p in ((0, 0), (3, 1))]
    return dict(jp=jp, pcfg=pcfg, batches=batches,
                anchors=torch.from_numpy(config_anchors(jcfg)))


def _draws(cfg, seed):
    return tstep.draw_train(cfg, torch.Generator().manual_seed(seed), "cpu")


def test_train_step_updates_params_but_not_bn_stats(tiny):
    cfg = tiny["pcfg"]
    init, step = tstep.make_train_step(cfg, tiny["anchors"].numpy())
    params = weights.params_from_numpy(tiny["jp"], cfg)
    before = {k: v.clone() for k, v in weights._leaves(params).items()}
    state, metrics = step(init(params), T.port_batch(tiny["batches"][0]),
                          generator=torch.Generator().manual_seed(2))
    assert state.step == 1 and np.isfinite(float(metrics["total_loss"]))
    after = weights._leaves(state.params)
    assert not torch.equal(after["backbone/stem_conv/w"],
                           before["backbone/stem_conv/w"])
    for k, v in after.items():
        if k.endswith(("/mean", "/var")):
            assert torch.equal(v, before[k]) and not v.requires_grad, k


def test_grad_accum_matches_mean_gradient_step(tiny):
    """grad_accum_steps=2: the parameters stay exactly unchanged after the
    first micro-step, and after the second equal one accum=1 update with
    the mean of the two micro-gradients taken at the original
    parameters."""
    cfg2 = tiny["pcfg"].replace(grad_accum_steps=2)
    cfg1 = tiny["pcfg"].replace(grad_accum_steps=1)
    batches = [T.port_batch(b) for b in tiny["batches"]]
    draws = [_draws(cfg2, 11), _draws(cfg2, 12)]
    init2, step2 = tstep.make_train_step(cfg2, tiny["anchors"].numpy())
    state = init2(weights.params_from_numpy(tiny["jp"], cfg2))
    p0 = {k: v.detach().clone()
          for k, v in weights._leaves(state.params).items()}
    state, _ = step2(state, batches[0], draws[0])
    for k, v in weights._leaves(state.params).items():
        assert torch.equal(v, p0[k]), k
    state, _ = step2(state, batches[1], draws[1])

    ref_params = weights.params_from_numpy(tiny["jp"], cfg1)
    init1, _ = tstep.make_train_step(cfg1, tiny["anchors"].numpy())
    ref = init1(ref_params)
    total, parts, g_a = tstep.loss_and_grads(ref.params, batches[0],
                                             tiny["anchors"], cfg1, draws[0])
    _, _, g_b = tstep.loss_and_grads(ref.params, batches[1], tiny["anchors"],
                                     cfg1, draws[1])
    g_mean = {k: (g_a[k] + g_b[k]) / 2.0 for k in g_a}
    ref, _ = tstep.apply_update(cfg1, ref, g_mean, total, parts)
    want = weights._leaves(ref.params)
    for k, v in weights._leaves(state.params).items():
        np.testing.assert_allclose(v.detach().numpy(),
                                   want[k].detach().numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_packed_labels_equivalent(tiny):
    cfg = tiny["pcfg"]
    b = T.port_batch(tiny["batches"][0])
    packed = b._replace(labels=torch.from_numpy(
        tstep.pack_labels_w(tiny["batches"][0]["labels"])))
    assert packed.labels.shape[-1] == cfg.image_shape[2] // 2
    params = weights.params_from_numpy(tiny["jp"], cfg)
    draws = _draws(cfg, 4)
    t1, m1 = tstep.train_forward(params, b, tiny["anchors"], cfg, draws)
    t2, m2 = tstep.train_forward(params, packed, tiny["anchors"], cfg, draws)
    np.testing.assert_allclose(float(t1), float(t2), rtol=1e-6)
    for k in m1:
        np.testing.assert_allclose(float(m1[k]), float(m2[k]), rtol=1e-6)


def test_train_wire_int8_close_to_float(tiny):
    cfg = tiny["pcfg"]
    params = weights.params_from_numpy(tiny["jp"], cfg)
    b = T.port_batch(tiny["batches"][1])
    draws = _draws(cfg, 9)
    total_f, parts_f = tstep.train_forward(params, b, tiny["anchors"], cfg,
                                           draws)
    q = np.clip(tiny["batches"][1]["image"], -5.0, 5.0)
    bq = b._replace(image=torch.from_numpy(
        (q * cfg.wire_int8_scale).astype(np.int8))[None, None])
    total_q, parts_q = tstep.train_forward(
        params, bq, tiny["anchors"], cfg.replace(train_wire_int8=True),
        draws)
    np.testing.assert_allclose(float(total_q), float(total_f), rtol=0.05)
    for k in parts_f:
        np.testing.assert_allclose(float(parts_q[k]), float(parts_f[k]),
                                   rtol=0.1, atol=5e-3)


def test_checkpointed_unet_with_dropout_is_exact(tiny):
    """remat_unet with dropout 0.6: the masks are drawn before the graph,
    so the backward pass's recomputation sees the same ones; the gradients
    equal those without the checkpoint.  And a generator drawn twice from
    one seed gives one loss."""
    jcfg, cfg = _cfgs("finetune")
    jp = jax_params(jcfg, 0)
    b = T.port_batch(T.organ_batch(cfg, weights.params_from_numpy(jp, cfg),
                                   0))
    draws = _draws(cfg, 5)
    assert draws.dropout_masks is not None and len(draws.dropout_masks) == 5
    out = {}
    for remat in (True, False):
        c = cfg.replace(remat_unet=remat)
        init, _ = tstep.make_train_step(c, tiny["anchors"].numpy())
        state = init(weights.params_from_numpy(jp, c))
        out[remat] = tstep.loss_and_grads(state.params, b, tiny["anchors"],
                                          c, draws)
    assert float(out[True][0]) == float(out[False][0])
    for k, g in out[True][2].items():
        np.testing.assert_allclose(g.numpy(), out[False][2][k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    params = weights.params_from_numpy(jp, cfg)
    t1, _ = tstep.train_forward(params, b, tiny["anchors"], cfg,
                                generator=torch.Generator().manual_seed(8))
    t2, _ = tstep.train_forward(params, b, tiny["anchors"], cfg,
                                generator=torch.Generator().manual_seed(8))
    assert float(t1) == float(t2)
    with pytest.raises(ValueError):
        tstep.train_forward(params, b, tiny["anchors"], cfg)
