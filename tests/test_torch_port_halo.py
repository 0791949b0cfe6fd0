"""The port's halo primitives, sharded U-Net and sharded mask losses
(``cfun_tpu_torch/parallel/halo.py``) against the JAX package's
(``cfun_tpu/parallel/halo.py`` under ``jax.shard_map``, tests/
test_halo.py) and against the port's own dense graph, on the CPU.

The port's side runs in one launch of four gloo ranks on the CPU
(``parallel/launch.py``, the rank functions in tests/torch_port_ranks.py):
the primitives over a (1, 4) mesh and a (2, 2) mesh (space 4 and 2), and
on the (2, 2) mesh the sharded U-Net (row 0) and the sharded mask losses
(row 1).  Each rank backpropagates its share of sum(output * cotangent);
the shards of the input gradients are gathered and the weight gradients
summed over the space ranks, against the dense graph's autograd.

Criteria: the halo exchange exactly JAX's; the convs and the instance
norm to rtol / atol 1e-5 of JAX's forward (test_halo.py's), their
gradients to 1e-5 of the largest magnitude of the dense ones; the
sharded U-Net's logits against JAX's ``shard_map_unet`` at the port's
U-Net tolerances (rtol 1e-4, atol 2e-4, tests/test_torch_port_models.py),
its logits and parameter gradients within 1e-5 of the largest magnitude
of the port's dense ones; the mask losses to rtol 1e-5 of the dense ones
and their logit gradients to rtol 1e-4 / atol 1e-6
(tests/test_halo.py:156-206).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, PartitionSpec as P

from cfun_tpu.models.unet3d import init_unet
from cfun_tpu.parallel import halo as jhalo
from cfun_tpu.parallel import make_mesh as jax_make_mesh
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import nn as pnn
from cfun_tpu_torch import weights
from cfun_tpu_torch.models.unet3d import apply_unet
from cfun_tpu_torch.parallel import halo
from cfun_tpu_torch.parallel.launch import launch
from cfun_tpu_torch.train import losses as L
import torch_port_ranks as R

X_SHAPE = (2, 3, 16, 6, 5)  # [N, C, D, H, W]
CONVS = {"k3s1": (3, 1), "k3s2": (3, 2), "k5s1": (5, 1), "k5s2": (5, 2)}
STAGES = ("beginning", "finetune")


def _exchange_dense(x, halo_n, shards):
    """The gathered result of ``exchange_halo`` from the whole volume:
    each shard with ``halo_n`` planes of zero-padded neighbours."""
    xp = F.pad(x, [0, 0, 0, 0, halo_n, halo_n])
    local = x.shape[2] // shards
    return torch.cat([xp[:, :, s * local:s * local + local + 2 * halo_n]
                      for s in range(shards)], dim=2)


def _dense_fns(shards):
    fns = {f"halo{h}": (lambda v, h=h: _exchange_dense(v, h, shards), None)
           for h in (1, 2)}
    fns["inorm"] = (pnn.instance_norm, None)
    for name, (k, s) in CONVS.items():
        fns[name] = (lambda v, w, s=s: pnn.conv3d({"w": w}, v, stride=s),
                     name)
    return fns


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=X_SHAPE).astype(np.float32)
    conv_w = {k: (0.3 * rng.normal(size=(4, 3, k, k, k))).astype(np.float32)
              for k in (3, 5)}
    cots = {}
    for shards in (4, 2):
        cots[shards] = {}
        for name, (fn, w) in _dense_fns(shards).items():
            args = [torch.from_numpy(x)] + (
                [torch.from_numpy(conv_w[CONVS[w][0]])] if w else [])
            shape = fn(*args).shape
            cots[shards][name] = rng.normal(size=shape).astype(np.float32)
    params = jax.tree.map(np.asarray, init_unet(jax.random.PRNGKey(0), 1, 4,
                                                4))
    crops = rng.normal(size=(2, 1, 32, 32, 32)).astype(np.float32)
    unet_cots = {"beginning": rng.normal(size=(2, 4, 32, 32, 32)),
                 "finetune": rng.normal(size=(2, 4, 64, 64, 64))}
    unet_cots = {k: v.astype(np.float32) for k, v in unet_cots.items()}
    labels = rng.integers(0, 3, size=(2, 16, 8, 8))
    masks = np.eye(3, dtype=np.float32)[labels].transpose(0, 4, 1, 2, 3)
    logits = rng.normal(size=(2, 3, 16, 8, 8)).astype(np.float32)
    pos_valid = np.array([True, False])
    loss_cfgs = {"heart": pconfig.tiny_config(),
                 "lits": pconfig.tiny_config().replace(
                     name="lits", stage="finetune",
                     mask_class_weights=(1.0, 1.0, 100.0))}
    return dict(x=x, weights=conv_w, cots=cots, unet=params,
                crops=np.ascontiguousarray(crops), unet_cots=unet_cots,
                masks=np.ascontiguousarray(masks), logits=logits,
                pos_valid=pos_valid, loss_cfgs=loss_cfgs)


@pytest.fixture(scope="module")
def ranks(inputs):
    convs = [(name, inputs["weights"][k], s) for name, (k, s) in CONVS.items()]
    return launch(R.halo_suite, 1, 4, devices="cpu", args=(
        inputs["x"], inputs["cots"][4], inputs["cots"][2], convs,
        (inputs["unet"], inputs["crops"], inputs["unet_cots"]),
        (inputs["masks"], inputs["pos_valid"], inputs["logits"],
         inputs["loss_cfgs"])))


def _gathered(parts):
    return np.concatenate(parts, axis=2)


def _close_to_largest(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3g} > {rel:g} x {scale:.3g}"


def _row(ranks, shards):
    """The primitives' results of the space group of ``shards`` ranks
    (space 4: the four ranks; space 2: row 0 of the (2, 2) mesh)."""
    if shards == 4:
        return [r["space4"] for r in ranks]
    return [r["space2"] for r in ranks[:2]]


def _jax_forward(name, x, w, shards):
    mesh = Mesh(np.asarray(jax.devices()[:shards]), ("space",))
    xj = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    if name.startswith("halo"):
        fn = lambda v: jhalo.exchange_halo(v, "space", int(name[4:]), axis=1)
    elif name == "inorm":
        fn = lambda v: jhalo.instance_norm_sharded(v, "space")
    else:
        wj = jnp.asarray(w.transpose(2, 3, 4, 1, 0))
        fn = lambda v: jhalo.halo_conv3d({"w": wj}, v, "space",
                                         stride=CONVS[name][1])
    spec = P(None, "space", None, None, None)
    out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec,
                                out_specs=spec))(xj)
    return np.asarray(out).transpose(0, 4, 1, 2, 3)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", ["halo1", "halo2", "inorm", "k3s1", "k3s2",
                                  "k5s1", "k5s2"])
def test_primitive_matches_jax_and_dense(inputs, ranks, shards, name):
    row = _row(ranks, shards)
    got = _gathered([r[name][0] for r in row])
    fn, wname = _dense_fns(shards)[name]
    w = inputs["weights"][CONVS[wname][0]] if wname else None
    want_jax = _jax_forward(name, inputs["x"], w, shards)
    assert got.shape == want_jax.shape
    if name.startswith("halo"):
        np.testing.assert_array_equal(got, want_jax)
    else:
        np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-5)
    # gradients against the dense graph's autograd
    leaves = [torch.from_numpy(inputs["x"]).requires_grad_(True)]
    if w is not None:
        leaves.append(torch.from_numpy(w).requires_grad_(True))
    y = fn(*leaves)
    grads = torch.autograd.grad(
        torch.sum(y * torch.from_numpy(inputs["cots"][shards][name])),
        leaves)
    _close_to_largest(got, y.detach().numpy(), 1e-5, f"{name} forward")
    _close_to_largest(_gathered([r[name][1] for r in row]),
                      grads[0].numpy(), 1e-5, f"{name} input gradient")
    if w is not None:
        _close_to_largest(sum(r[name][2] for r in row), grads[1].numpy(),
                          1e-5, f"{name} weight gradient")


@pytest.fixture(scope="module")
def unet_dense(inputs):
    out = {}
    for stage in STAGES:
        params = R.unet_params(inputs["unet"])
        leaves = {k: v.requires_grad_(True) for k, v in
                  weights._leaves(params).items()}
        y = apply_unet(params, torch.from_numpy(inputs["crops"]), stage=stage)
        grads = torch.autograd.grad(
            torch.sum(y * torch.from_numpy(inputs["unet_cots"][stage])),
            list(leaves.values()), allow_unused=True)
        out[stage] = (y.detach().numpy(), {
            p: None if g is None else g.numpy()
            for p, g in zip(leaves, grads)})
    return out


@pytest.mark.parametrize("stage", STAGES)
def test_sharded_unet_matches_jax(inputs, ranks, stage):
    got = _gathered([r["unet"][stage][0] for r in ranks[:2]])
    mesh = jax_make_mesh(2, space=2)
    want = jax.jit(lambda p, c: jhalo.shard_map_unet(mesh, p, c, stage=stage))(
        jax.tree.map(jnp.asarray, inputs["unet"]),
        jnp.asarray(inputs["crops"].transpose(0, 2, 3, 4, 1)))
    want = np.asarray(want).transpose(0, 4, 1, 2, 3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("stage", STAGES)
def test_sharded_unet_matches_dense(ranks, unet_dense, stage):
    want_y, want_g = unet_dense[stage]
    _close_to_largest(_gathered([r["unet"][stage][0] for r in ranks[:2]]),
                      want_y, 1e-5, f"{stage} logits")
    moved = 0
    for path, want in want_g.items():
        got = [r["unet"][stage][1][path] for r in ranks[:2]]
        if want is None:
            assert all(g is None for g in got), path
            continue
        _close_to_largest(sum(got), want, 1e-5, f"{stage} {path}")
        moved += 1
    assert moved == len(want_g) - (stage == "beginning")


def test_sharded_unet_rejects_misaligned_depth(inputs):
    mesh = types.SimpleNamespace(space=4, space_group=None)
    with pytest.raises(ValueError, match="local D"):
        halo.shard_map_unet(mesh, R.unet_params(inputs["unet"]),
                            torch.zeros(1, 1, 32, 32, 32), stage="beginning")


@pytest.mark.parametrize("name", ["heart", "lits"])
def test_sharded_mask_losses_match_dense(inputs, ranks, name):
    cfg = inputs["loss_cfgs"][name]
    masks = torch.from_numpy(inputs["masks"])
    pos_valid = torch.from_numpy(inputs["pos_valid"])
    lg = torch.from_numpy(inputs["logits"]).requires_grad_(True)
    ml = L.mask_loss(masks, pos_valid, lg, cfg)
    el = L.mask_edge_loss(masks, pos_valid, torch.softmax(lg, dim=1), cfg,
                          per_class=name == "lits")
    (g,) = torch.autograd.grad(ml + 2.0 * el, [lg])
    got = [r["losses"][name] for r in ranks[2:]]
    ml, el = float(ml.detach()), float(el.detach())
    for sm, se, _ in got:
        np.testing.assert_allclose(sm, ml, rtol=1e-5,
                                   err_msg=f"{name} mask loss")
        np.testing.assert_allclose(se, el, rtol=1e-5,
                                   err_msg=f"{name} edge loss")
    assert el > 0
    np.testing.assert_allclose(_gathered([s[2] for s in got]), g.numpy(),
                               rtol=1e-4, atol=1e-6, err_msg=f"{name} grads")
