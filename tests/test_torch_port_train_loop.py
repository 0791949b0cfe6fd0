"""The port's epoch loop (``cfun_tpu_torch/train/loop.py::train_model``)
against the JAX package's, on the CPU: the tiny heart config (float32,
exact top-k, the scan NMS on JAX's side, K1's plain version on the
port's) on in-memory volumes whose organ sits on one of the start
weights' proposals (4 train, 2 validation; no rotation), so the ROI
sample, the dropout and the mask branch run; 2 epochs of 3 steps with
validation and a checkpoint every epoch, both loops starting from one
checkpoint of seeded weights.

The angle and the feeder's plan are the same calls in both packages; the
per-step draws are not, so the JAX loop's own draws (its step and
validation keys as ``train/loop.py:172-180`` derives them) are fed to the
port through ``loop.step_draws``, the one function the port draws
through.  Criteria: every epoch loss part and validation loss to rtol
1e-4, and the final checkpoints' leaves (parameters and optimizer
traces) to rtol 1e-3 / atol 1e-6: the tolerances of
``tests/test_mesh_train_loop.py:129-165``, since XLA:CPU's steps are not
bit-repeatable; the mask U-Net's traces, sums of its gradients, to the
step tests' gradient tolerance summed over the 6 steps.  Then the port alone: a run resumed at epoch 2 replays the
uninterrupted 4-epoch run exactly (CPU torch is bit-repeatable here: the
same epoch losses, validation losses and checkpoint leaves, compared
with ``assert_array_equal``), two identical runs log the same validation
losses, and a mesh the devices cannot hold is refused.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfun_tpu import config as jconfig
from cfun_tpu.train import loop as jax_loop
from cfun_tpu.utils import checkpoint as jcheckpoint
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.train import loop
from torch_port_params import jax_params
import torch_port_train as T

SEED = 0
# no rotation: the organs stay on the start weights' proposals
LOOP = dict(steps_per_epoch=3, validation_steps=2, val_every_epochs=1,
            augment_rotate_degrees=0.0)


def _cfgs():
    return (jconfig.tiny_config(approx_topk=False, nms_backend="scan",
                                **LOOP),
            pconfig.tiny_config(**LOOP))


class OrganSet:
    """In-memory volumes of the config's own shape (molded as they are),
    each with its organ on one of the start weights' proposals
    (tests/torch_port_train.py::organ_batch): the loop's ROI sample, its
    dropout and the mask branch run, so its per-step draws matter.
    Molded by both packages' feeders, which read ``num_images``,
    ``load_image`` ([H, W, D, 1]) and ``load_mask`` ([H, W, D])."""

    def __init__(self, picks):
        _, pcfg = _cfgs()
        tparams = weights.params_from_numpy(jax_params(_cfgs()[0], SEED),
                                            pcfg)
        self._vols = []
        for seed, pick in picks:
            b = T.organ_batch(pcfg, tparams, seed, pick)
            self._vols.append((b["image"].transpose(1, 2, 0).copy(),
                               b["labels"].transpose(1, 2, 0).copy()))
        self.num_images = len(self._vols)

    def load_image(self, i):
        return self._vols[i][0][..., None]

    def load_mask(self, i):
        return self._vols[i][1]


def _datasets():
    return (OrganSet([(0, 0), (3, 1), (5, 0), (7, 2)]),
            OrganSet([(11, 0), (13, 1)]))


def _records(log_dir):
    out = []
    for f in sorted(glob.glob(os.path.join(log_dir, "**",
                                           "train_metrics.jsonl"),
                              recursive=True)):
        with open(f) as fh:
            out.extend(json.loads(line) for line in fh)
    return out


def _epochs(records):
    return {r["epoch"]: r for r in records if "loss" in r}


def _vals(records):
    return {r["epoch"]: r["val_loss"] for r in records if "val_loss" in r}


def _jax_loop_draws(jcfg, pcfg, epochs, steps, val_steps):
    """The JAX loop's per-step draws in the order the port's loop takes
    them: each epoch's train steps, then its validation forwards."""
    out = []
    train_base = jax.random.PRNGKey(SEED)
    val_base = jax.random.PRNGKey(SEED + 0x5EED)
    for epoch in range(1, epochs + 1):
        for base, n in ((train_base, steps), (val_base, val_steps)):
            key = jax.random.fold_in(base, epoch)
            for _ in range(n):
                key, sub = jax.random.split(key)
                out.append(T.jax_draws(sub, jcfg, pcfg))
    return out


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """One checkpoint of seeded weights (tests/torch_port_params.py; epoch
    0), the start of both loops.  Not ``init_params``' zero biases: from
    those, pre-activations sit at 0 and the two packages' float32 sums
    flip different ReLUs, so the trajectories part by ~10% within 6
    steps; from these they agree to ~2e-4 of each leaf's movement."""
    jcfg, _ = _cfgs()
    path = str(tmp_path_factory.mktemp("start") / "init.npz")
    jcheckpoint.save(path, jax_params(jcfg, SEED))
    return path


@pytest.fixture(scope="module")
def loops_ab(tmp_path_factory, start):
    jcfg, pcfg = _cfgs()
    root = tmp_path_factory.mktemp("loops")
    jtrain, jval = _datasets()
    draws = _jax_loop_draws(jcfg, pcfg, 2, LOOP["steps_per_epoch"],
                            LOOP["validation_steps"])
    taken = []

    def fake(cfg, generator, device):
        taken.append(generator)
        return draws[len(taken) - 1]

    mp = pytest.MonkeyPatch()
    # the JAX loop's initial weights are replaced by the checkpoint's
    # leaf for leaf; running init_params eagerly costs ~40 s on the CPU
    init = jax.tree.map(jnp.asarray, jax_params(jcfg, SEED + 1))
    mp.setattr(jax_loop.cfun, "init_params", lambda key, cfg: init)
    mp.setattr(loop, "step_draws", fake)
    try:
        jckpt = jax_loop.train_model(jcfg, jtrain, jval,
                                     log_dir=str(root / "jax"),
                                     weights=start, epochs=2, seed=SEED,
                                     num_workers=2)
        ptrain, pval = _datasets()
        pckpt = loop.train_model(pcfg, ptrain, pval,
                                 log_dir=str(root / "port"), weights=start,
                                 epochs=2, seed=SEED, num_workers=2,
                                 device="cpu")
    finally:
        mp.undo()
    assert len(taken) == len(draws)
    return dict(jrec=_records(str(root / "jax")),
                prec=_records(str(root / "port")), jckpt=jckpt, pckpt=pckpt)


def test_epoch_losses_match_jax(loops_ab):
    jep, pep = _epochs(loops_ab["jrec"]), _epochs(loops_ab["prec"])
    assert sorted(jep) == sorted(pep) == [1, 2]
    for e in (1, 2):
        assert pep[e]["angle"] == jep[e]["angle"]
        for k in T.LOSS_KEYS + ("loss",):
            np.testing.assert_allclose(pep[e][k], jep[e][k], rtol=1e-4,
                                       atol=0, err_msg=f"epoch {e} {k}")
    # the ROI sample had positives: the mask branch ran every epoch
    assert all(pep[e]["mrcnn_mask_loss"] > 0 for e in (1, 2))


def test_val_losses_match_jax(loops_ab):
    jv, pv = _vals(loops_ab["jrec"]), _vals(loops_ab["prec"])
    assert sorted(jv) == sorted(pv) == [1, 2]
    for e in (1, 2):
        np.testing.assert_allclose(pv[e], jv[e], rtol=1e-4, atol=0)


def test_final_checkpoint_matches_jax(loops_ab):
    """Every parameter and optimizer trace to rtol 1e-3 / atol 1e-6, but
    the mask U-Net's traces: each a momentum sum of the 6 steps' U-Net
    gradients, which the step tests hold to 5e-4 of a leaf's largest
    magnitude (XLA:CPU's float32 U-Net backward, ROADMAP.md section C), so
    within 6 x 5e-4 of the trace's largest magnitude."""
    order = loop.make_train_step(_cfgs()[1], np.zeros((1, 6), np.float32))[
        0](weights.init_params(_cfgs()[1], 0)).opt_state.tree_paths
    with np.load(loops_ab["jckpt"]) as a, np.load(loops_ab["pckpt"]) as b:
        assert sorted(a.files) == sorted(b.files)
        assert sum(k.startswith("opt/") for k in b.files) == len(order)
        for k in a.files:
            if k == "__meta__":
                ja = json.loads(bytes(a[k]).decode())
                pa = json.loads(bytes(b[k]).decode())
                assert (pa["epoch"], pa["step"]) == (ja["epoch"],
                                                     ja["step"]) == (2, 6)
            elif k.startswith("opt/") and order[int(k[4:])].startswith(
                    "mask/unet/"):
                err = float(np.abs(b[k] - a[k]).max())
                assert err <= 6 * 5e-4 * float(np.abs(a[k]).max()), k
            else:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-3,
                                           atol=1e-6, err_msg=k)


def _port_run(log, epochs, weights=None):
    _, pcfg = _cfgs()
    train, val = _datasets()
    return loop.train_model(pcfg, train, val, log_dir=str(log),
                            epochs=epochs, weights=weights, seed=SEED,
                            num_workers=2, device="cpu")


@pytest.fixture(scope="module")
def full_run(tmp_path_factory, start):
    log = tmp_path_factory.mktemp("full")
    return _port_run(log, 4, start), _records(str(log))


@pytest.mark.parametrize("stop", [1, 2])
def test_resume_reproduces_uninterrupted_trajectory(tmp_path, start,
                                                    full_run, stop):
    """4 epochs straight against ``stop`` + a resumed ``4 - stop``: the
    same epoch losses, validation losses and final checkpoint, bit for
    bit.  Resumed at epoch 1, the replayed epoch 2 still trains the mask
    branch (the start weights' proposals have not moved off the organs
    yet), so a per-step draw that ran on from before the resume would
    show; by epoch 3 they have, and the draws no longer move the loss."""
    full, fr = full_run
    half = _port_run(tmp_path / "half", stop, start)
    resumed = _port_run(tmp_path / "resumed", 4, half)
    rr = _records(str(tmp_path / "resumed"))
    assert sorted(_epochs(fr)) == [1, 2, 3, 4]
    assert sorted(_epochs(rr)) == list(range(stop + 1, 5))
    if stop == 1:
        assert _epochs(fr)[2]["mrcnn_mask_loss"] > 0
    for e in range(stop + 1, 5):
        for k in T.LOSS_KEYS + ("loss", "angle"):
            assert _epochs(rr)[e][k] == _epochs(fr)[e][k], (e, k)
        assert _vals(rr)[e] == _vals(fr)[e]
    with np.load(full) as a, np.load(resumed) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_val_loss_same_across_runs(tmp_path, start):
    vals = []
    for run in range(2):
        _port_run(tmp_path / f"run{run}", 1, start)
        vals.append(_vals(_records(str(tmp_path / f"run{run}"))))
    assert vals[0] and vals[0] == vals[1]


def test_multi_device_mesh_is_refused(monkeypatch, tmp_path):
    """A mesh the devices cannot hold is refused before any rank starts
    (the mesh itself runs: tests/test_torch_port_mesh.py): two CUDA ranks
    with one card visible (the count named), NCCL ranks sharing a card,
    and the device mold cache on a mesh (the JAX package's message)."""
    import torch

    from cfun_tpu_torch.parallel import launch

    _, pcfg = _cfgs()
    train, val = _datasets()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(launch.mp, "start_processes", None)
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        loop.train_model(pcfg, train, val, log_dir=str(tmp_path), epochs=1,
                         mesh_spec=(2, 1), device="cuda")
    with pytest.raises(ValueError, match="NCCL takes one card a rank"):
        loop.train_model(pcfg, train, val, log_dir=str(tmp_path), epochs=1,
                         mesh_spec=(2, 1), device="cuda",
                         devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="device_mold_cache is a "
                                         "single-device optimization"):
        loop.train_model(pcfg.replace(augment_on_device=True,
                                      device_mold_cache=True), train, val,
                         log_dir=str(tmp_path), epochs=1, mesh_spec=(2, 1),
                         device="cpu")
