"""The port's LiTS slice against the JAX package, on the CPU: the LiTS
presets, the NumPy HU-window / virtual-pad mold, the device overlap-tile
paste, a P3D35 trunk with the (5, 7, 7) stem, the LiTS checkpoint's
layout, and ``Detector.detect`` end to end on a tiny LiTS detector (and on
a heart detector with three instances, which takes the same paste).

Criteria: configs field for field; the NumPy mold bit for bit, window
equal; the paste's averaged probabilities within 1e-5 of the
``scale_and_translate`` oracle and its labels agreeing with JAX's on
>= 99.9% of voxels; the trunk to rtol 1e-4 / atol 1e-4 (float32 convs
summed in different orders); the detectors' int8 wire bit for bit, rois
and class ids equal, scores to rtol 1e-5, label volumes >= 99.9%.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfun_tpu import config as jconfig
from cfun_tpu import native as jnative
from cfun_tpu.data.feeder import mold_volume as jax_mold
from cfun_tpu.data.feeder import normalize_intensity as jax_normalize
from cfun_tpu.data import resample as jresample
from cfun_tpu.data.resample import pad_resize_nearest as jax_pad_resize
from cfun_tpu.inference import Detector as JaxDetector
from cfun_tpu.models import cfun as jcfun
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.data.mold import (mold_volume, normalize_intensity,
                                      quantize_int8)
from cfun_tpu_torch.data import resample as presample
from cfun_tpu_torch.data.resample import pad_resize_nearest
from cfun_tpu_torch.inference import Detector
from cfun_tpu_torch.models import cfun as tcfun
from torch_port_params import jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("beginning", "together", "finetune")


def _tiny_lits(mod, **overrides):
    """tests/test_lits_variant.py's ``_tiny_lits`` with the LiTS stem and
    the LiTS inference wire: three instances, int8 x127, the overlap
    paste."""
    return mod.tiny_config("beginning").replace(**{**dict(
        name="lits", num_classes=3, backbone="P3D35",
        backbone_stem_kernel=(5, 7, 7), intensity_norm="hu_window",
        pad_shape=(64, 128, 128), mask_class_weights=(1.0, 1.0, 100.0),
        unet_dropout_rate=0.0, mask_shape_override=(16, 16, 16),
        mask_pool_size=(16, 16, 16), detection_max_instances=3,
        wire_image_dtype="int8", wire_int8_scale=127.0, fast_unmold=True),
        **overrides})


def _hu_volume(seed, shape=(100, 110, 50)):
    """A raw [H, W, D] HU volume: ~300 HU background, a low-HU 'liver'
    block with a darker 'tumour' inside."""
    rng = np.random.default_rng(seed)
    vol = np.full(shape, 300.0, np.float32)
    vol += rng.normal(0, 40, size=shape).astype(np.float32)
    h, w, d = shape
    vol[h // 5:3 * h // 5, w // 4:3 * w // 4, d // 5:7 * d // 10] = -150.0
    vol[7 * h // 20:9 * h // 20, 2 * w // 5:11 * w // 20,
        9 * d // 25:13 * d // 25] = -280.0
    return vol


# ---- configuration ---------------------------------------------------------

@pytest.mark.parametrize("preset", ["lits_config", "lits_inference_config"])
@pytest.mark.parametrize("stage", STAGES)
def test_lits_presets_match_jax(preset, stage):
    got = getattr(pconfig, preset)(stage)
    want = getattr(jconfig, preset)(stage)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("mask_shape", "num_positive_rois",
                 "backbone_feature_shapes", "num_anchors"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.mask_shape == ((64, 160, 160) if stage == "finetune"
                              else (32, 80, 80))
    assert got.num_anchors == 16 * 20 * 20 + 32 * 40 * 40


# ---- the NumPy mold --------------------------------------------------------

# raw [H, W, D] sources against the tiny pad (D, H, W) = (64, 128, 128):
# inside the pad, wider than it (cropped, offset 0), deeper than it, odd
MOLD_SHAPES = [(100, 100, 40), (100, 140, 40), (60, 70, 90), (77, 91, 33)]
MOLD_IDS = ["inside_pad", "wider_than_pad", "deeper_than_pad", "odd"]


@pytest.mark.parametrize("shape", MOLD_SHAPES, ids=MOLD_IDS)
def test_lits_numpy_mold_matches_jax(monkeypatch, shape):
    """HU window, virtual pad and nearest resize bit for bit against the
    JAX package's NumPy mold (its native one patched away), window equal,
    and the int8 wire as the JAX ``_mold`` makes it.  The port's native
    mold agrees to 1e-6 (a multiplication by the reciprocal where NumPy
    divides) and its wire to one int8 step."""
    monkeypatch.setattr(jnative, "lits_mold", lambda *a: None)
    cfg = _tiny_lits(jconfig)
    pcfg = _tiny_lits(pconfig)
    vol = _hu_volume(2, shape)
    want, want_win, _ = jax_mold(vol, cfg)
    got, got_win = mold_volume(vol, pcfg)
    assert got.shape == cfg.image_shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_win, want_win)
    np.testing.assert_array_equal(
        normalize_intensity(vol, pcfg), jax_normalize(vol, cfg))
    wire = quantize_int8(got, pcfg.wire_int8_scale)
    np.testing.assert_array_equal(
        wire, (np.clip(want, -5.0, 5.0) * 127.0).astype(np.int8))
    det = Detector(pcfg, weights.init_params(pcfg), device="cpu")
    nwire, nwin, _ = det.mold(vol)
    np.testing.assert_array_equal(nwin, want_win)
    assert int(np.abs(nwire[0, 0].numpy().astype(np.int16) - wire).max()) <= 1


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_pad_resize_nearest_matches_jax(dtype):
    rng = np.random.default_rng(4)
    vol = rng.integers(-500, 500, size=(37, 53, 21)).astype(dtype)
    for pad, out, off in [((61, 66, 43), (33, 27, 21), (12, 6, 11)),
                          ((30, 66, 20), (16, 40, 24), (0, 6, 0))]:
        np.testing.assert_array_equal(
            pad_resize_nearest(vol, pad, out, off),
            jax_pad_resize(vol, pad, out, off))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("shape", MOLD_SHAPES, ids=MOLD_IDS)
def test_molded_labels_to_original_matches_jax(shape, native):
    """The unmold of the overlap paste's molded label volume back to the
    raw geometry (float64 index maps through the pad; a source wider or
    deeper than the pad maps through offset 0), against the JAX
    detector's, native and NumPy."""
    if not jnative.available():
        pytest.fail("the JAX package's native library did not build")
    cfg = _tiny_lits(jconfig)
    pcfg = _tiny_lits(pconfig)
    labels = np.random.default_rng(5).integers(
        0, 3, size=cfg.image_shape, dtype=np.int8)
    want = JaxDetector.__new__(JaxDetector)
    want.cfg = cfg
    det = Detector(pcfg, weights.init_params(pcfg), device="cpu",
                   native=native)
    got = det._molded_labels_to_original(labels, shape)
    assert got.shape == shape and got.dtype == np.int16
    np.testing.assert_array_equal(
        got, want._molded_labels_to_original(labels, shape))


def test_host_overlap_unmold_matches_jax():
    """The exact path's host unmold: every detection's probability stack
    resized into its box and averaged over the overlaps
    (``unmold_overlap_labels``), and one stack into one box
    (``trilinear_into_box``), bit for bit; boxes overlapping, at the
    volume's far faces, one voxel thin, and none."""
    rng = np.random.default_rng(6)
    probs = rng.uniform(size=(3, 8, 10, 12, 3)).astype(np.float32)
    shape = (32, 64, 64)
    boxes = np.array([[2, 4, 4, 18, 36, 36], [8, 20, 20, 24, 52, 52],
                      [20, 40, 30, 32, 64, 64]], np.int64)
    for b in (boxes, boxes[:1], boxes[:0],
              np.array([[10, 10, 10, 11, 40, 40]], np.int64)):
        np.testing.assert_array_equal(
            presample.unmold_overlap_labels(probs[:len(b)], b, shape),
            jresample.unmold_overlap_labels(probs[:len(b)], b, shape))
    for box in boxes:
        np.testing.assert_array_equal(
            presample.trilinear_into_box(probs[0], box, shape),
            jresample.trilinear_into_box(probs[0], box, shape))


# ---- the overlap paste -----------------------------------------------------

PASTE = {
    # two overlapping boxes (up-scaled on every axis) and an invalid slot
    "overlap": ([[2, 4, 4, 18, 36, 36], [8, 20, 20, 24, 52, 52],
                 [0, 0, 0, 8, 16, 16]], [True, True, False]),
    "all_invalid": ([[2, 4, 4, 18, 36, 36], [8, 20, 20, 24, 52, 52],
                     [0, 0, 0, 8, 16, 16]], [False, False, False]),
    # touching the volume's far faces
    "far_faces": ([[20, 40, 30, 32, 64, 64], [0, 0, 0, 32, 64, 64],
                   [31, 63, 63, 32, 64, 64]], [True, True, True]),
    # one voxel thick along z (thinner than a mask voxel is long), zero
    # thick along x, and a box down-scaled on every axis
    "thin": ([[10, 10, 10, 11, 40, 40], [4, 8, 8, 20, 30, 8],
              [3, 5, 7, 7, 12, 13]], [True, True, True]),
    # up along z, down along y and x; down along z, up along y and x
    "scaling": ([[0, 10, 20, 30, 16, 28], [12, 2, 1, 16, 60, 63],
                 [5.0, 6.0, 7.0, 9.0, 30.0, 20.0]], [True, True, True]),
}


@pytest.fixture(scope="module")
def paste_inputs():
    cfg = jconfig.tiny_config(detection_max_instances=3, fast_unmold=True,
                              num_classes=3)
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 8, 10, 12, 3)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    return cfg, probs


def _oracle(probs, dets, valid, cfg):
    """The JAX paste's averaged probabilities, slot by slot through
    ``jax.image.scale_and_translate`` (tests/test_detector.py's oracle):
    [D, H, W, C]."""
    d, h, w = cfg.image_shape
    n, md, mh, mw, c = probs.shape
    acc = np.zeros((d, h, w, c), np.float32)
    cnt = np.zeros((d, h, w), np.float32)
    zi, yi, xi = (np.arange(s, dtype=np.float32) for s in (d, h, w))
    for i in range(n):
        box = dets[i, :6]
        size = np.maximum(box[3:] - box[:3], 1.0)
        resized = np.asarray(jax.image.scale_and_translate(
            jnp.asarray(probs[i]), (d, h, w, c), (0, 1, 2),
            jnp.asarray(size / np.array([md, mh, mw], np.float32)),
            jnp.asarray(box[:3]), method="trilinear", antialias=False))
        inside = (((zi >= box[0]) & (zi < box[3]))[:, None, None]
                  & ((yi >= box[1]) & (yi < box[4]))[None, :, None]
                  & ((xi >= box[2]) & (xi < box[5]))[None, None, :])
        v = inside.astype(np.float32) * float(valid[i])
        acc += resized * v[..., None]
        cnt += v
    return np.clip(acc / (cnt[..., None] + 1e-6), 0.0, 1.0)


@pytest.mark.parametrize("case", list(PASTE))
def test_overlap_paste_matches_jax(paste_inputs, case):
    cfg, probs = paste_inputs
    boxes, valid = PASTE[case]
    dets = np.zeros((3, 8), np.float32)
    dets[:, :6] = boxes
    valid = np.array(valid)
    tprobs = torch.from_numpy(np.moveaxis(probs, -1, 1).copy())
    pcfg = pconfig.tiny_config(detection_max_instances=3, fast_unmold=True,
                               num_classes=3)
    got = tcfun.overlap_paste_probs(tprobs, torch.from_numpy(dets),
                                    torch.from_numpy(valid), pcfg)
    assert got.shape == (3, *cfg.image_shape) and got.dtype == torch.float32
    want = _oracle(probs, dets, valid, cfg)
    np.testing.assert_allclose(got.permute(1, 2, 3, 0).numpy(), want,
                               rtol=0, atol=1e-5)
    labels = tcfun.overlap_paste_labels(tprobs, torch.from_numpy(dets),
                                        torch.from_numpy(valid), pcfg)
    jlabels = np.asarray(jcfun.overlap_paste_labels(
        jnp.asarray(probs), jnp.asarray(dets), jnp.asarray(valid), cfg))
    assert labels.dtype == torch.int8 and labels.shape == jlabels.shape
    agree = float((labels.numpy() == jlabels).mean())
    assert agree >= 0.999, f"labels agree on {agree:.5f}"
    if not valid.any():
        assert not labels.any() and not got.any()


# ---- trunk and weights -----------------------------------------------------

def test_p3d35_trunk_matches_jax():
    """The P3D35 trunk (bottleneck depths 4 and 5) with the (5, 7, 7) stem
    at the tiny width, float32."""
    jcfg = _tiny_lits(jconfig)
    pcfg = _tiny_lits(pconfig)
    jp = jax_params(jcfg, 6)
    tp = weights.params_from_numpy(jp, pcfg)
    assert tuple(tp["backbone"]["stem_conv"]["w"].shape[2:]) == (5, 7, 7)
    assert len(tp["backbone"]["c2"]) == 4 and len(tp["backbone"]["c3"]) == 5
    d, h, w = jcfg.image_shape
    img = np.random.default_rng(0).normal(size=(1, d, h, w, 1))
    img = img.astype(np.float32)
    jt = jax.jit(lambda p, x: jcfun.apply_trunk(p, x, jcfg))(
        jp, jnp.asarray(img))
    tt = tcfun.apply_trunk(tp, torch.from_numpy(
        np.moveaxis(img, -1, 1).copy()), pcfg)
    for field in ("p2", "p3", "rpn_logits", "rpn_deltas"):
        want = np.asarray(getattr(jt, field))
        if field in ("p2", "p3"):
            want = np.moveaxis(want, -1, 1)
        np.testing.assert_allclose(getattr(tt, field).numpy(), want,
                                   rtol=1e-4, atol=1e-4, err_msg=field)


def test_load_lits_checkpoint_consumes_every_leaf():
    path = os.path.join(ROOT, "weights", "lits_synth.npz")
    cfg = pconfig.lits_inference_config()
    params, meta = weights.load_npz(path, cfg)
    assert meta["stage"] == "finetune"
    assert meta["tag"] == "lits-synthetic-staged"
    with np.load(path) as z:
        n_leaves = sum(k.startswith("params/") for k in z.files)
        w = z["params/backbone/stem_conv/w"]
    flat = weights._flatten(params)
    assert len(flat) == n_leaves
    assert w.shape[:3] == (5, 7, 7)
    np.testing.assert_array_equal(
        flat["backbone/stem_conv/w"],
        w.astype(np.float32).transpose(4, 3, 0, 1, 2))
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        weights.layout(cfg)


# ---- Detector.detect end to end --------------------------------------------

CASES = {"fast": {}, "exact": dict(fast_unmold=False)}


@pytest.fixture(scope="module")
def lits_params():
    jcfg = _tiny_lits(jconfig, approx_topk=False, nms_backend="scan")
    jp = jax_params(jcfg, 5)
    return jp, weights.params_from_numpy(jp, _tiny_lits(pconfig))


def _assert_same_result(got, want, vol, num_classes=3):
    assert len(want["scores"]) >= 2, "fewer than two detections to paste"
    np.testing.assert_array_equal(got["rois"], want["rois"])
    np.testing.assert_array_equal(got["class_ids"], want["class_ids"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5)
    assert got["mask"].shape == want["mask"].shape == vol.shape
    assert got["mask"].dtype == np.int16
    assert set(np.unique(got["mask"])) <= set(range(num_classes))
    agree = float((got["mask"] == want["mask"]).mean())
    assert agree >= 0.999, f"label volumes agree on {agree:.5f}"


@pytest.mark.parametrize("host", ["native", "numpy"])
@pytest.mark.parametrize("case", list(CASES))
def test_lits_detect_matches_jax(monkeypatch, lits_params, case, host):
    """Both detectors on one raw volume and shared weights.  ``native``:
    both packages' host libraries, the pipelined LiTS mold engaged on both
    on the fast path; ``numpy``: the JAX package's native ops patched
    away, the port given ``native=False``.  The int8 wire bit for bit (the
    JAX slabs concatenated against the port's device tensor), and so are
    the window and the bytes each detect() moved."""
    jp, tp = lits_params
    if host == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "lits_mold", lambda *a: None)
        monkeypatch.setattr(jnative, "unmold_nearest_labels",
                            lambda *a: None)
    elif not jnative.available():
        pytest.fail("the JAX package's native library did not build")
    jcfg = _tiny_lits(jconfig, approx_topk=False, nms_backend="scan",
                      **CASES[case])
    pcfg = _tiny_lits(pconfig, **CASES[case])
    jdet = JaxDetector(jcfg, jp)
    det = Detector(pcfg, tp, device="cpu", native=host == "native")
    assert jdet._pipelined_lits == det._pipelined_lits == \
        (host == "native" and case == "fast")
    vol = _hu_volume(1)
    slabs, jwin, _ = jdet._mold(vol)
    wire, pwin, _ = det.mold(vol)
    jwire = np.concatenate([np.asarray(s) for s in slabs], axis=0)
    np.testing.assert_array_equal(wire[0, 0].numpy(), jwire)
    np.testing.assert_array_equal(pwin, jwin)
    want = jdet.detect(vol)
    got = det.detect(vol)
    _assert_same_result(got, want, vol, pcfg.num_classes)
    assert det.last_wire_bytes == jdet.last_wire_bytes
    if case == "fast":
        d, h, w = pcfg.image_shape
        assert det.labels_shape == (d, h, w)
        assert det.last_wire_bytes == {"up": d * h * w,
                                       "down": 3 * 33 + d * h * w // 4}


def test_heart_multi_instance_detect_matches_jax():
    """A heart detector with three instances takes the overlap paste, as
    in JAX (cfun_tpu/models/cfun.py:200-208): native on both sides, the
    heart slab pipeline engaged on both (tests/test_detector.py:228-246's
    configuration with the served heart wire)."""
    if not jnative.available():
        pytest.fail("the JAX package's native library did not build")
    over = dict(detection_max_instances=3, fast_unmold=True,
                wire_image_dtype="int8", device_normalize=True)
    jcfg = jconfig.tiny_config(approx_topk=False, nms_backend="scan", **over)
    pcfg = pconfig.tiny_config(**over)
    assert tcfun.uses_overlap_paste(pcfg)
    jp = jax_params(jcfg, 2)
    jdet = JaxDetector(jcfg, jp)
    det = Detector(pcfg, weights.params_from_numpy(jp, pcfg), device="cpu")
    assert jdet._pipelined and det._pipelined
    assert det.labels_shape == tuple(pcfg.image_shape)
    rng = np.random.default_rng(4)
    vol = (rng.normal(size=(64, 64, 32)) * 50.0 + 100.0).astype(np.float32)
    vol[8:28, 8:28, 4:14] += 300.0
    vol[36:56, 36:56, 18:28] += 300.0
    slabs, _, _ = jdet._mold(vol)
    wire, _, _ = det.mold(vol)
    np.testing.assert_array_equal(
        wire[0, 0].numpy(), np.concatenate([np.asarray(s) for s in slabs]))
    want = jdet.detect(vol)
    got = det.detect(vol)
    _assert_same_result(got, want, vol, pcfg.num_classes)
    assert det.last_wire_bytes == jdet.last_wire_bytes
