"""The port's mesh training (``cfun_tpu_torch/parallel/mesh.py``, the mesh
branches of ``train/step.py`` and ``train/loop.py``) on gloo ranks on the
CPU, against the port's dense step on one device and against the JAX
package's mesh step (``cfun_tpu/parallel/mesh.py`` on its virtual CPU
devices, tests/conftest.py).

The steps (tests/torch_port_ranks.py::step_suite; tiny_config, float32,
K1's plain version): a (2, 1) step, two (2, 1) steps under
``grad_accum_steps=2``, a (1, 2) step at stage 'finetune' with
``shard_unet_spatial`` (the U-Net checkpointed, dropout 0.6, the edge
loss; 32^3 crops so that each of the two shards holds 16 planes), and a
(2, 2) step at 'beginning' with ``shard_unet_spatial``.  Each is held
against ``batched_train_forward`` on the same volumes with the same draws
and one dense update: the loss parts to rtol 1e-5, the gradients the
ranks summed within 1e-5 of each leaf's largest magnitude (the mask
U-Net's within 1e-4; the global-norm clip would hide a gradient scaled by
the mesh's size from the parameters), every updated leaf within 1e-6 of
its largest magnitude, the accumulation's as
tests/test_torch_port_train_heart.py holds it (rtol 1e-5 / atol 1e-7);
after every step the parameters are bit-equal on every rank.  The (2, 1)
step is also held against the JAX mesh step given the JAX step's own
per-volume draws (its key split as ``batched_train_forward`` splits it,
rebuilt by tests/torch_port_train.py): loss parts rtol 1e-5, parameters
within 1e-6 (the step tests').

The loop (``train_model(mesh_spec=...)``, 2 steps an epoch, validation and
a checkpoint every epoch, 32^3 crops and ``shard_unet_spatial``): (2, 1)
for 2 epochs; 1 epoch, then a run resumed from its checkpoint that
replays epoch 2 and its checkpoint bit for bit, and validates epoch 1 as
the uninterrupted run did (the validation loss is deterministic); (2, 2)
with the same loss trace as (2, 1) to rtol 2e-4
(tests/test_mesh_train_loop.py:76).  The feeder's shards give row r the
items the JAX single-controller loop stacks in row r, bit for bit.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfun_tpu import config as jconfig
from cfun_tpu.data.feeder import TrainFeeder as JaxFeeder
from cfun_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from cfun_tpu.ops.anchors import config_anchors
from cfun_tpu.parallel import make_mesh as jax_make_mesh
from cfun_tpu.parallel import make_parallel_train_step as jax_parallel_step
from cfun_tpu.parallel import stack_batches as jax_stack
from cfun_tpu.train.loop import _grouped
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.data.datasets import SyntheticDataset
from cfun_tpu_torch.data.feeder import TrainFeeder
from cfun_tpu_torch.parallel.launch import launch
from cfun_tpu_torch.parallel.mesh import stack_batches
from cfun_tpu_torch.train import loop
from cfun_tpu_torch.train import step as tstep
from torch_port_params import jax_params
import torch_port_ranks as R
from test_torch_port_feeder import _same_item
import torch_port_train as T

BASE = dict(nms_backend="scan", approx_topk=False)
# 32^3 crops: 16 planes a shard over two space ranks (local D % 16)
SHARD = dict(mask_pool_size=(32, 32, 32), mask_shape_override=(32, 32, 32),
             shard_unet_spatial=True)
FINETUNE = dict(mask_pool_size=(32, 32, 32), mask_shape_override=(64, 64, 64),
                shard_unet_spatial=True, remat_unet=True)
# the mesh's summed gradient leaves against the dense step's, each over its
# leaf's largest magnitude: 1e-5, but the mask U-Net's 1e-4 (float32 sums
# in other orders on the ranks' threads and shards; measured here up to
# 8.8e-6 unsplit and 3.2e-5 split)
GRAD_REL, UNET_GRAD_REL = 1e-5, 1e-4
# volumes whose organ sits on one of the start weights' proposals
PICKS = [(0, 0), (3, 1), (5, 0), (7, 2)]


def _cfgs(stage="beginning", **extra):
    return (jconfig.tiny_config(stage, **BASE, **extra),
            pconfig.tiny_config(stage, **BASE, **extra))


def _np_draws(d):
    return ((d.targets[0].numpy(), d.targets[1].numpy()),
            None if d.dropout_masks is None
            else [m.numpy() for m in d.dropout_masks])


def _gen_draws(cfg, seed):
    return tstep.draw_train(cfg, torch.Generator().manual_seed(seed), "cpu")


@pytest.fixture(scope="module")
def world():
    """The shared inputs: JAX-seeded weights, four organ batches (numpy),
    the JAX draws of the (2, 1) step's two volumes, generator draws of
    the other steps."""
    jcfg, pcfg = _cfgs()
    jp = jax_params(jcfg, 0)
    tparams = weights.params_from_numpy(jp, pcfg)
    batches = [T.organ_batch(pcfg, tparams, s, p) for s, p in PICKS]
    key = jax.random.PRNGKey(5)
    jdraws = [T.jax_draws(k, jcfg, pcfg) for k in jax.random.split(key, 2)]
    _, fcfg = _cfgs("finetune", **FINETUNE)
    return dict(jcfg=jcfg, pcfg=pcfg, jp=jp, batches=batches, key=key,
                jdraws=jdraws, fcfg=fcfg,
                acc_draws=[_gen_draws(pcfg, 11 + i) for i in range(4)],
                ft_draws=_gen_draws(fcfg, 21),
                shard_draws=[_gen_draws(pcfg.replace(**SHARD), 31 + i)
                             for i in range(2)])


@pytest.fixture(scope="module")
def two_ranks(world):
    b, jp = world["batches"], world["jp"]
    pcfg, fcfg = world["pcfg"], world["fcfg"]
    nd = [_np_draws(d) for d in world["jdraws"]]
    acc = [_np_draws(d) for d in world["acc_draws"]]
    cases = {
        "dp": (pcfg, jp, [[b[0], b[1]]], [nd], None),
        "accum": (pcfg.replace(grad_accum_steps=2), jp,
                  [[b[0], b[1]], [b[2], b[3]]], [acc[:2], acc[2:]], None),
        "space": (fcfg, jp, [[b[0]]], [[_np_draws(world["ft_draws"])]],
                  (1, 2)),
    }
    ranks = launch(R.step_suite, 2, 1, args=(cases,), devices="cpu")
    return {name: [r[name] for r in ranks] for name in cases}


@pytest.fixture(scope="module")
def four_ranks(world):
    b = world["batches"]
    cfg = world["pcfg"].replace(**SHARD)
    cases = {"mesh22": (cfg, world["jp"], [[b[0], b[1]]],
                        [[_np_draws(d) for d in world["shard_draws"]]],
                        None)}
    return [r["mesh22"] for r in launch(R.step_suite, 2, 2, args=(cases,),
                                        devices="cpu")]


def _dense_grads(cfg, params, batches, draws):
    """``batched_train_forward`` over the volumes on one device: (total,
    parts, the trainable leaves' gradients by path)."""
    flat = weights._leaves(params)
    paths = [p for p, v in flat.items() if v.requires_grad]
    total, parts = tstep.batched_train_forward(
        params, stack_batches([R.port_batch(x) for x in batches]),
        torch.from_numpy(config_anchors(cfg)), cfg, draws)
    grads = torch.autograd.grad(total, [flat[p] for p in paths],
                                allow_unused=True)
    return total.detach(), {k: v.detach() for k, v in parts.items()}, {
        p: torch.zeros_like(flat[p]) if g is None else g
        for p, g in zip(paths, grads)}


def _dense_step(cfg, jp, batches, draws):
    """``batched_train_forward`` over the volumes and one update from a
    fresh optimizer: (parts with the total, updated leaves by path, the
    gradients by path)."""
    init, _ = tstep.make_train_step(cfg, config_anchors(cfg))
    state = init(weights.params_from_numpy(jp, cfg))
    total, parts, grads = _dense_grads(cfg, state.params, batches, draws)
    grads_np = {p: g.numpy().copy() for p, g in grads.items()}
    state, metrics = tstep.apply_update(cfg, state, grads, total, parts)
    return ({k: float(v) for k, v in metrics.items()},
            R.digest(state.params), grads_np)


def _same_on_every_rank(runs):
    for s, (metrics, params) in enumerate(runs[0]["steps"]):
        for other in runs[1:]:
            om, op = other["steps"][s]
            assert om == metrics, f"step {s}: metrics differ across ranks"
            for p, v in params.items():
                np.testing.assert_array_equal(op[p], v, err_msg=f"{s} {p}")


def _assert_grads_close(got, want):
    """The first step's gradients as the ranks summed them against the
    dense step's, within GRAD_REL (UNET_GRAD_REL on the mask U-Net) of
    each leaf's largest magnitude.  A gradient scaled by the mesh's size
    is off by 50% or more: the global-norm clip hides that from the
    updated parameters, not from the gradients."""
    assert sorted(got) == sorted(want)
    for p, w in want.items():
        rel = UNET_GRAD_REL if p.startswith("mask/unet/") else GRAD_REL
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[p] - w).max())
        assert err <= rel * scale, f"{p}: {err:.3g} > {rel:g} x {scale:.3g}"


def _assert_step_close(got, want):
    (gm, gp), (wm, wp) = got, want[:2]
    assert sorted(gm) == sorted(wm)
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, err_msg=k)
    for p, v in wp.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        err = float(np.abs(gp[p] - v).max())
        assert err <= 1e-6 * scale, f"{p}: {err:.3g} > 1e-6 x {scale:.3g}"


def test_data_parallel_step_matches_dense(world, two_ranks):
    runs = two_ranks["dp"]
    assert [r["data_index"] for r in runs] == [0, 1]
    _same_on_every_rank(runs)
    want = _dense_step(world["pcfg"], world["jp"], world["batches"][:2],
                       world["jdraws"])
    _assert_step_close(runs[0]["steps"][0], want)
    _assert_grads_close(runs[0]["grads"], want[2])
    assert want[0]["mrcnn_mask_loss"] > 0  # the mask branch ran


def test_data_parallel_step_matches_jax_mesh_step(world, two_ranks):
    """The port's (2, 1) step against ``make_parallel_train_step`` on
    ``make_mesh(2, space=1)`` with the JAX step's own draws."""
    jcfg = world["jcfg"]
    mesh = jax_make_mesh(2, space=1)
    init, step = jax_parallel_step(jcfg, config_anchors(jcfg), mesh)
    state = init(jax.tree.map(jnp.asarray, world["jp"]))
    batch = jax_stack([T.jax_batch(b) for b in world["batches"][:2]])
    state, metrics = step(state, batch, world["key"])
    got_metrics, got_params = two_ranks["dp"][0]["steps"][0]
    for k, v in metrics.items():
        np.testing.assert_allclose(got_metrics[k], float(v), rtol=T.PARTS_RTOL,
                                   err_msg=k)
    jn = T.flat_numpy(jax.tree.map(np.asarray, state.params))
    tn = T.flat_numpy(weights.params_to_numpy(
        weights._unflatten({p: torch.from_numpy(v)
                            for p, v in got_params.items()})))
    assert sorted(tn) == sorted(jn)
    for k in jn:
        np.testing.assert_allclose(tn[k], jn[k], rtol=0, atol=T.PARAM_ATOL,
                                   err_msg=k)


def test_grad_accum_on_the_mesh(world, two_ranks):
    """``grad_accum_steps=2`` (tests/test_parallel.py:87): the parameters
    bit-unchanged after the first mesh step, and after the second one
    accum=1 update with the mean of the two steps' gradients, each the
    mean over its two volumes, taken at the original parameters."""
    runs = two_ranks["accum"]
    _same_on_every_rank(runs)
    jp, cfg = world["jp"], world["pcfg"]
    p0 = R.digest(weights.params_from_numpy(jp, cfg))
    for p, v in runs[0]["steps"][0][1].items():
        np.testing.assert_array_equal(v, p0[p], err_msg=p)
    init, _ = tstep.make_train_step(cfg, config_anchors(cfg))
    state = init(weights.params_from_numpy(jp, cfg))
    (total, parts, ga), (_, _, gb) = (
        _dense_grads(cfg, state.params, world["batches"][i:i + 2],
                     world["acc_draws"][i:i + 2]) for i in (0, 2))
    mean = {p: (ga[p] + gb[p]) / 2.0 for p in ga}
    state, _ = tstep.apply_update(cfg, state, mean, total, parts)
    want = R.digest(state.params)
    for p, v in runs[0]["steps"][1][1].items():
        np.testing.assert_allclose(v, want[p], rtol=1e-5, atol=1e-7,
                                   err_msg=p)


def test_spatially_sharded_step_matches_dense(world, two_ranks):
    """(1, 2) at 'finetune': the U-Net and its mask and edge losses split
    along D over the row's two ranks, checkpointed, with dropout."""
    runs = two_ranks["space"]
    assert [r["space_index"] for r in runs] == [0, 1]
    _same_on_every_rank(runs)
    want = _dense_step(world["fcfg"], world["jp"], world["batches"][:1],
                       [world["ft_draws"]])
    _assert_step_close(runs[0]["steps"][0], want)
    _assert_grads_close(runs[0]["grads"], want[2])
    assert want[0]["mrcnn_mask_edge_loss"] > 0


def test_data_and_space_step_matches_dense(world, four_ranks):
    assert [(r["data_index"], r["space_index"]) for r in four_ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    _same_on_every_rank(four_ranks)
    want = _dense_step(world["pcfg"].replace(**SHARD), world["jp"],
                       world["batches"][:2], world["shard_draws"])
    _assert_step_close(four_ranks[0]["steps"][0], want)
    _assert_grads_close(four_ranks[0]["grads"], want[2])
    assert want[0]["mrcnn_mask_loss"] > 0


# ---- the loop --------------------------------------------------------------

LOOP = dict(steps_per_epoch=2, validation_steps=1, val_every_epochs=1)


def _loop_cfg():
    return pconfig.tiny_config(**LOOP, **SHARD)


def _datasets(cfg):
    """The port's ``SyntheticDataset`` (pickled to the ranks by name)
    holding volumes whose organ sits on the start weights' proposals
    (tests/torch_port_train.py::organ_batch), so the ROI sample, the
    dropout and the mask branch run."""
    jcfg, pcfg = _cfgs()
    tparams = weights.params_from_numpy(jax_params(jcfg, 0), pcfg)
    out = []
    for picks in (PICKS, [(11, 0), (13, 1)]):
        ds = SyntheticDataset(cfg, n=len(picks))
        vols = [T.organ_batch(pcfg, tparams, s, p) for s, p in picks]
        ds._volumes = [(v["image"].transpose(1, 2, 0).copy(),
                        v["labels"].transpose(1, 2, 0).copy()) for v in vols]
        out.append(ds)
    return out


def _records(log_dir, rank=0):
    tag = "" if rank is None else f"-rank{rank}"
    files = sorted(glob.glob(os.path.join(log_dir, "**", "*" + tag,
                                          "train_metrics.jsonl"),
                             recursive=True))
    assert len(files) == 1, files
    with open(files[0]) as fh:
        return [json.loads(line) for line in fh]


def _epochs(records):
    return {r["epoch"]: r for r in records if "loss" in r}


def _vals(records):
    return {r["epoch"]: r["val_loss"] for r in records if "val_loss" in r}


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """A checkpoint of the JAX-seeded weights at epoch 0."""
    from cfun_tpu.utils import checkpoint as jcheckpoint

    path = str(tmp_path_factory.mktemp("start") / "init.npz")
    jcheckpoint.save(path, jax_params(_cfgs()[0], 0))
    return path


def _run(log, epochs, mesh_spec, weights_path):
    cfg = _loop_cfg()
    train, val = _datasets(cfg)
    return loop.train_model(cfg, train, val, log_dir=str(log), epochs=epochs,
                            weights=weights_path, seed=0, num_workers=1,
                            mesh_spec=mesh_spec, device="cpu")


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory, start):
    root = tmp_path_factory.mktemp("mesh_loops")
    full = _run(root / "full", 2, (2, 1), start)
    half = _run(root / "half", 1, (2, 1), start)
    resumed = _run(root / "resumed", 2, (2, 1), half)
    space = _run(root / "space", 2, (2, 2), start)
    return {name: (path, str(root / name)) for name, path in (
        ("full", full), ("half", half), ("resumed", resumed),
        ("space", space))}


def test_mesh_loop_two_epochs_val_checkpoint(loop_runs):
    path, log = loop_runs["full"]
    recs = _records(log)
    assert sorted(_epochs(recs)) == [1, 2] and sorted(_vals(recs)) == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["mrcnn_mask_loss"] > 0
               for r in _epochs(recs).values())
    # rank 1 logs the same losses (means over the rows) under its own tag
    other = _epochs(_records(log, 1))
    for e, r in _epochs(recs).items():
        assert {k: other[e][k] for k in T.LOSS_KEYS + ("loss",)} == {
            k: r[k] for k in T.LOSS_KEYS + ("loss",)}
    assert _vals(_records(log, 1)) == _vals(recs)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        assert any(k.startswith("opt/") for k in z.files)
    assert (meta["epoch"], meta["step"]) == (2, 4)
    # only rank 0 wrote a checkpoint
    assert len(glob.glob(os.path.join(log, "**", "model.npz"),
                         recursive=True)) == 1


def test_mesh_resume_reproduces_uninterrupted_run(loop_runs):
    """1 epoch, then resumed to 2, against 2 straight
    (tests/test_mesh_train_loop.py:38,129): the same epoch-2 losses, the
    same validation losses (epoch 1 from the first run), the same final
    checkpoint, bit for bit."""
    full, full_log = loop_runs["full"]
    half_log = loop_runs["half"][1]
    resumed, resumed_log = loop_runs["resumed"]
    f, r = _records(full_log), _records(resumed_log)
    assert sorted(_epochs(r)) == [2]
    for k in T.LOSS_KEYS + ("loss", "angle"):
        assert _epochs(r)[2][k] == _epochs(f)[2][k], k
    assert _vals(r)[2] == _vals(f)[2]
    assert _vals(_records(half_log))[1] == _vals(f)[1]
    with np.load(full) as a, np.load(resumed) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mesh_space_sharding_is_semantics_free(loop_runs):
    """(2, 2) with the U-Net and its losses split along D against (2, 1):
    the same loss trace (tests/test_mesh_train_loop.py:76)."""
    a = _epochs(_records(loop_runs["full"][1]))
    b = _epochs(_records(loop_runs["space"][1]))
    assert sorted(a) == sorted(b) == [1, 2]
    for e in (1, 2):
        for k in T.LOSS_KEYS + ("loss",):
            np.testing.assert_allclose(b[e][k], a[e][k], rtol=2e-4,
                                       atol=1e-5, err_msg=f"{e} {k}")
    va, vb = _vals(_records(loop_runs["full"][1])), _vals(
        _records(loop_runs["space"][1]))
    for e in (1, 2):
        np.testing.assert_allclose(vb[e], va[e], rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("data", [2, 3])
def test_feeder_shards_are_the_jax_loops_rows(data):
    """Row r's feeder shard gives the items the JAX single-controller
    loop stacks in row r of its steps (``_grouped`` of one feeder's
    epoch, cfun_tpu/train/loop.py:46-51, 247-250), bit for bit."""
    jcfg, pcfg = jconfig.tiny_config(), pconfig.tiny_config()
    anchors = config_anchors(jcfg)
    steps, angle, epoch = 3, 7.0, 2
    jf = JaxFeeder(JaxSynthetic(jcfg, n=5, seed=4), jcfg, anchors, seed=9,
                   num_workers=1)
    try:
        groups = list(_grouped(jf.epoch(angle, steps * data,
                                        epoch_index=epoch), data))
    finally:
        jf.close()
    assert len(groups) == steps
    for r in range(data):
        pf = TrainFeeder(SyntheticDataset(pcfg, n=5, seed=4), pcfg, anchors,
                         seed=9, num_workers=1, shard_index=r,
                         num_shards=data)
        try:
            items = list(pf.epoch(angle, steps, epoch_index=epoch))
        finally:
            pf.close()
        assert len(items) == steps
        for item, group in zip(items, groups):
            _same_item(item, group[r])
