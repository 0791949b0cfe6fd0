"""The port's training host path against the JAX package's, on the CPU:
``rotate_hw``, the native train molds (``csrc/host_ops.cc`` through
``cfun_tpu_torch/native.py`` against ``cfun_tpu.native``) and
``TrainFeeder`` (items, plans, epochs, a failing volume, the augment
mode's mold cache).

Criteria: ``rotate_hw`` order 0 exact, order 1 to 1e-6; every native op
and every feeder item bit for bit (the bf16 wire by its uint16 bits);
plans and epoch sequences equal.  The JAX package's native library is the
one its own tests build.
"""

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
from cfun_tpu_torch.data.datasets import SyntheticDataset
from cfun_tpu_torch.data.feeder import TrainFeeder
from cfun_tpu_torch.data.resample import rotate_hw
from cfun_tpu_torch.ops.augment import AugTrainBatch

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
