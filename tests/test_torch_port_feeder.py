"""The port's training host path against the JAX package's, on the CPU:
``rotate_hw``, the native train molds (``csrc/host_ops.cc`` through
``cfun_tpu_torch/native.py`` against ``cfun_tpu.native``) and
``TrainFeeder`` (items, plans, epochs, a failing volume, the augment
mode's mold cache), and the feeders' native team (items on teams of any
size, the size rule, one region at a time in plan order).

Criteria: ``rotate_hw`` order 0 exact, order 1 to 1e-6; every native op
and every feeder item bit for bit (the bf16 wire by its uint16 bits);
plans and epoch sequences equal.  The JAX package's native library is the
one its own tests build.
"""

import itertools
import os
import threading
import time

import numpy as np
import pytest
import torch

from cfun_tpu import config as jconfig
from cfun_tpu import native as jnative
from cfun_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from cfun_tpu.data.feeder import TrainFeeder as JaxFeeder
from cfun_tpu.data.resample import rotate_hw as jax_rotate_hw
from cfun_tpu.ops.anchors import config_anchors
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import native as pnative
from cfun_tpu_torch.data.batch import AugTrainBatch
from cfun_tpu_torch.data.datasets import SyntheticDataset
from cfun_tpu_torch.data.feeder import TrainFeeder, shared_team, team_size
from cfun_tpu_torch.parallel.mesh import ranks_on_host
from cfun_tpu_torch.data.resample import rotate_hw

ANGLES = (0.0, 90.0, 20.0, -20.0, 13.0)
LITS = dict(name="lits", num_classes=3, backbone="P3D35",
            intensity_norm="hu_window", pad_shape=(40, 72, 72),
            mask_class_weights=(1.0, 1.0, 100.0), unet_dropout_rate=0.0,
            mask_shape_override=(16, 16, 16), mask_pool_size=(16, 16, 16),
            wire_int8_scale=127.0)
# (label, config overrides, host shape (H, W, D) of the volumes)
ITEM_CASES = {
    "heart_bf16": (dict(compute_dtype="bfloat16"), (41, 47, 23)),
    "heart_int8": (dict(compute_dtype="bfloat16", train_wire_int8=True),
                   (41, 47, 23)),
    "tiny_f32": ({}, (41, 47, 23)),
    "lits_bf16": (dict(compute_dtype="bfloat16", **LITS), (60, 66, 37)),
    "lits_int8": (dict(compute_dtype="bfloat16", train_wire_int8=True,
                       **LITS), (60, 66, 37)),
}


def bits(x):
    """An array or tensor as numpy, bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    if not jnative.available():
        pytest.fail("the JAX package's native library did not build")


# ---- rotate_hw ---------------------------------------------------------------

@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("angle", ANGLES)
def test_rotate_hw_matches_jax(order, angle):
    rng = np.random.default_rng(abs(int(angle)) + 100 * order)
    vol = rng.normal(size=(33, 40, 5)).astype(np.float32)
    labels = rng.integers(0, 4, size=(33, 40, 5)).astype(np.int32)
    got, want = rotate_hw(vol, angle, order), jax_rotate_hw(vol, angle,
                                                            order)
    assert got.dtype == want.dtype and got.shape == want.shape
    if order == 0:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(rotate_hw(labels, angle, 0),
                                      jax_rotate_hw(labels, angle, 0))
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---- the native train molds ----------------------------------------------------

@pytest.mark.parametrize("angle", ANGLES)
def test_heart_train_molds_match_jax(angle):
    rng = np.random.default_rng(1)
    src = (rng.normal(size=(37, 41, 23)) * 100).astype(np.float32)
    mask = rng.integers(0, 8, size=(37, 41, 23)).astype(np.int32)
    out = (19, 33, 30)
    np.testing.assert_array_equal(
        pnative.heart_train_mold(src, out, angle),
        bits(jnative.heart_train_mold(src, out, angle)))
    np.testing.assert_array_equal(
        pnative.heart_train_mold_q8(src, out, angle, 5.0, 25.4),
        jnative.heart_train_mold_q8(src, out, angle, 5.0, 25.4))
    np.testing.assert_array_equal(
        pnative.heart_train_labels(mask, out, angle),
        jnative.heart_train_labels(mask, out, angle))


@pytest.mark.parametrize("angle", ANGLES)
def test_lits_train_molds_match_jax(angle):
    rng = np.random.default_rng(2)
    src = (rng.normal(size=(37, 41, 23)) * 500).astype(np.float32)
    mask = rng.integers(0, 3, size=(37, 41, 23)).astype(np.int32)
    pad, out, offs, hu = (50, 60, 31), (21, 25, 27), (6, 9, 4), (300, -300)
    np.testing.assert_array_equal(
        pnative.lits_train_mold(src, pad, out, offs, angle, hu),
        bits(jnative.lits_train_mold(src, pad, out, offs, angle, hu)))
    np.testing.assert_array_equal(
        pnative.lits_train_mold_q8(src, pad, out, offs, angle, hu, 5.0,
                                   127.0),
        jnative.lits_train_mold_q8(src, pad, out, offs, angle, hu, 5.0,
                                   127.0))
    np.testing.assert_array_equal(
        pnative.lits_train_labels(mask, pad, out, offs, angle),
        jnative.lits_train_labels(mask, pad, out, offs, angle))
    np.testing.assert_array_equal(
        pnative.pad_nearest_labels(mask, pad, out, offs),
        jnative.pad_nearest_labels(mask, pad, out, offs))
    np.testing.assert_array_equal(
        pnative.pad_nearest_labels(mask, mask.shape, out, (0, 0, 0)),
        jnative.pad_nearest_labels(mask, mask.shape, out, (0, 0, 0)))


# ---- TrainFeeder ---------------------------------------------------------------

def _feeders(overrides, host, n=2, seed=3, **kw):
    jcfg, pcfg = (m.tiny_config(**overrides) for m in (jconfig, pconfig))
    anchors = config_anchors(jcfg)
    jf = JaxFeeder(JaxSynthetic(jcfg, n=n, seed=seed, host_shape=host),
                   jcfg, anchors, seed=0, num_workers=2, **kw)
    pf = TrainFeeder(SyntheticDataset(pcfg, n=n, seed=seed, host_shape=host),
                     pcfg, anchors, seed=0, num_workers=2, **kw)
    return jf, pf


def _same_item(got, want):
    assert got.image.shape[:2] == (1, 1)
    np.testing.assert_array_equal(bits(got.image)[0, 0],
                                  bits(want.image)[0, ..., 0])
    for field in ("rpn_match", "rpn_deltas", "gt_box_norm", "labels"):
        g, w = bits(getattr(got, field)), bits(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("angle", [0.0, 13.0])
@pytest.mark.parametrize("case", sorted(ITEM_CASES))
def test_make_item_matches_jax(case, angle):
    overrides, host = ITEM_CASES[case]
    jf, pf = _feeders(overrides, host)
    try:
        _same_item(pf.make_item(1, angle, 123), jf.make_item(1, angle, 123))
        assert len(pf.pop_times()) == 1 and pf.item_times == []
    finally:
        jf.close()
        pf.close()


@pytest.mark.parametrize("epoch_index", [None, 4])
@pytest.mark.parametrize("num_shards", [1, 3])
def test_plan_matches_jax(num_shards, epoch_index):
    jcfg, pcfg = jconfig.tiny_config(), pconfig.tiny_config()
    anchors = config_anchors(jcfg)
    for shard in range(num_shards):
        jf = JaxFeeder(JaxSynthetic(jcfg, n=5), jcfg, anchors, seed=9,
                       shard_index=shard, num_shards=num_shards)
        pf = TrainFeeder(SyntheticDataset(pcfg, n=5), pcfg, anchors,
                         seed=9, shard_index=shard, num_shards=num_shards)
        try:
            for _ in range(2):  # the stream form advances between calls
                (ji, js), (pi, ps) = (f._plan(7, epoch_index)
                                      for f in (jf, pf))
                assert pi == ji
                np.testing.assert_array_equal(ps, js)
        finally:
            jf.close()
            pf.close()


def test_epoch_yields_jax_sequence():
    jf, pf = _feeders({}, (41, 47, 23), n=3)
    try:
        want = list(jf.epoch(-7.0, 5, epoch_index=2))
        got = list(pf.epoch(-7.0, 5, epoch_index=2))
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            _same_item(g, w)
    finally:
        jf.close()
        pf.close()


class _Flaky(SyntheticDataset):
    def load_image(self, image_id):
        if image_id == 1:
            raise IOError("corrupt volume")
        return super().load_image(image_id)


def test_feeder_survives_bad_volume():
    """As tests/test_data_io.py::test_feeder_survives_bad_volume: the bad
    volume is substituted and the count holds; with ``epoch_index`` the
    substitutions are a function of (seed, epoch), the same in two
    feeders whatever their own streams drew before."""
    cfg = pconfig.tiny_config()
    anchors = config_anchors(cfg)
    runs = []
    for advance in (0, 3):
        feeder = TrainFeeder(_Flaky(cfg, n=3), cfg, anchors, seed=0,
                             num_workers=2, prefetch=2)
        # the second feeder's own stream has moved on (an epoch-less plan
        # was drawn from it): its substitutions must not
        for _ in range(advance):
            feeder._plan(2)
        try:
            batches = list(feeder.epoch(angle=0.0, steps=4, epoch_index=5))
        finally:
            feeder.close()
        assert len(batches) == 4
        for b in batches:
            assert torch.isfinite(b.image.float()).all()
        runs.append(batches)
        stream = TrainFeeder(_Flaky(cfg, n=3), cfg, anchors, seed=0,
                             num_workers=2, prefetch=2)
        try:
            assert len(list(stream.epoch(angle=0.0, steps=4))) == 4
        finally:
            stream.close()
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_aug_mode_caches_molds_and_matches_jax():
    """As tests/test_device_augment.py::test_feeder_aug_mode_caches_molds,
    and the cached item is the JAX package's."""
    ov = dict(augment_on_device=True)
    jf, pf = _feeders(ov, (41, 47, 23))
    try:
        items = list(pf.epoch(angle=7.0, steps=4))
        assert len(items) == 4
        assert all(isinstance(it, AugTrainBatch) for it in items)
        assert all(it.angle == 7.0 for it in items)
        assert len(pf._mold_cache) == 2
        again = pf.make_item(0, angle=-3.0, seed=1)
        assert again.image is pf._mold_cache[0].image
        assert again.angle == -3.0
        want = jf.make_item(0, angle=-3.0, seed=1)
        np.testing.assert_array_equal(bits(again.image)[0, 0],
                                      bits(want.image)[0, ..., 0])
        np.testing.assert_array_equal(bits(again.labels), bits(want.labels))
        assert again.fill == float(want.fill)
    finally:
        jf.close()
        pf.close()


def test_aug_mode_refuses_lits():
    cfg = pconfig.tiny_config(augment_on_device=True, **LITS)
    feeder = TrainFeeder(SyntheticDataset(cfg, n=1), cfg,
                         config_anchors(cfg), num_workers=1)
    try:
        with pytest.raises(ValueError, match="heart molding only"):
            feeder.make_item(0, 5.0, 0)
    finally:
        feeder.close()


# ---- the feeders' team -----------------------------------------------------------

@pytest.mark.parametrize("threads", [None, 1, 3])
@pytest.mark.parametrize("case", ["heart_bf16", "heart_int8", "lits_int8"])
def test_make_item_on_the_team_matches_jax(case, threads):
    """An item molded on the process's shared team (None) or on a team of
    1 or 3 threads is the JAX package's, bit for bit."""
    overrides, host = ITEM_CASES[case]
    jf, pf = _feeders(overrides, host)
    if threads is None:
        assert pf.team is shared_team()
    else:
        pf.team = pnative.Team(threads)
    try:
        _same_item(pf.make_item(1, 13.0, 77), jf.make_item(1, 13.0, 77))
    finally:
        jf.close()
        pf.close()


@pytest.mark.parametrize("cores,ranks,size", [
    (8, 1, 6),   # one process on an 8-core host: the loop and the
                 # workers' NumPy keep a core each
    (8, 2, 2),   # two ranks on the host
    (32, 4, 6),  # four ranks on a four-card host
    (8, 4, 1),
    (1, 1, 1),   # a host of one core still has a team
    (2, 4, 1),
])
def test_team_size_rule(cores, ranks, size):
    assert team_size(cores, ranks) == size


def test_team_size_observes_the_process(monkeypatch):
    import torch.distributed as dist

    cores = len(os.sched_getaffinity(0))
    assert ranks_on_host() == 1
    assert team_size() == max(1, cores - 2)
    # a rank of two on this host, as parallel/launch.py starts them
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert ranks_on_host() == 2
    assert team_size() == max(1, cores // 2 - 2)
    # torchrun's ranks on this host of a larger world
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert ranks_on_host() == 1


class _Probe:
    """The native library with every call counted: how many were in
    flight at once, on which thread, and the marker voxel of its first
    argument."""

    def __init__(self, lib):
        self._lib = lib
        self._lock = threading.Lock()
        self.live = self.most = 0
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(self._lib, name)

        def probed(*args):
            with self._lock:
                self.live += 1
                self.most = max(self.most, self.live)
                self.calls.append((name, threading.current_thread().name,
                                   float(args[0].flat[0])))
            try:
                return fn(*args)
            finally:
                with self._lock:
                    self.live -= 1
        return probed


class _SlowFirst(SyntheticDataset):
    """Each volume's first voxel marks its id; the first loads are the
    slowest, so without an order the fourth item would reach the team
    first.  Counts the loads in flight at once."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._loads = itertools.count()
        self._lock = threading.Lock()
        self.live = self.most = 0

    def load_image(self, image_id):
        with self._lock:
            self.live += 1
            self.most = max(self.most, self.live)
        time.sleep(0.04 * max(0, 4 - next(self._loads)))
        image = super().load_image(image_id).copy()
        image.flat[0] = 1000.0 + image_id
        with self._lock:
            self.live -= 1
        return image


def test_items_take_the_team_one_at_a_time_in_plan_order(monkeypatch):
    """At most one native call in flight, all on the team's thread, each
    item's mold and labels back to back in the plan's order; the loads are
    not held to that order (several run at once)."""
    cfg = pconfig.tiny_config(compute_dtype="bfloat16")
    data = _SlowFirst(cfg, n=3, seed=3, host_shape=(41, 47, 23))
    feeder = TrainFeeder(data, cfg, config_anchors(cfg), seed=0,
                         num_workers=4, prefetch=4)
    probe = _Probe(pnative.library())
    monkeypatch.setattr(pnative, "library", lambda: probe)
    try:
        items = list(feeder.epoch(5.0, 7, epoch_index=3))
        ids, _ = feeder._plan(7, 3)
    finally:
        feeder.close()
    assert len(items) == 7
    assert data.most > 1
    assert probe.most == 1
    assert {thread for _, thread, _ in probe.calls} == {"native-team_0"}
    names = [name for name, _, _ in probe.calls]
    assert names == ["heart_train_mold_bf16", "heart_train_labels_i32"] * 7
    molded = [int(mark) - 1000 for name, _, mark in probe.calls
              if name == "heart_train_mold_bf16"]
    assert molded == ids
