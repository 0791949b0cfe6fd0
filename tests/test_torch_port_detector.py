"""The port's host mold, Detector and weight loading against the JAX
package, on the CPU.

``Detector.detect`` of both packages on the same raw volume and the same
weights (tiny_config with the heart inference overrides, at 'beginning'
and at 'finetune', whose 2x U-Net output is the label volume), twice:
with the NumPy mold on both sides (the JAX detector reads
``native.available()`` in ``__init__``, patched to False there; the port
is given ``native=False``), and with the native host ops on both sides,
the way both serve (the slab-pipelined int8 mold on the packed cases).
Criteria: the molded int8 wire bit for bit; rois, class ids equal; scores
to rtol 1e-5; label volumes agreeing on >= 99.9% of voxels.
"""

import json
import os

import numpy as np
import pytest
import torch

from cfun_tpu import native
from cfun_tpu.config import tiny_config
from cfun_tpu.data.feeder import mold_volume as jax_mold
from cfun_tpu.data.feeder import normalize_intensity as jax_normalize
from cfun_tpu.inference import Detector as JaxDetector
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.data.mold import (mold_volume, normalize_intensity,
                                      quantize_int8)
from cfun_tpu_torch.inference import Detector
from torch_port_params import jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEART = dict(wire_image_dtype="int8", device_normalize=True,
             fast_unmold=True, detection_max_instances=1)


def _volume(seed, shape=(80, 72, 40)):
    rng = np.random.default_rng(seed)
    vol = (rng.normal(size=shape) * 50.0 + 100.0).astype(np.float32)
    h, w, d = shape
    vol[h // 4:3 * h // 4, w // 4:3 * w // 4, d // 4:3 * d // 4] += 300.0
    return vol


@pytest.mark.parametrize("shape", [(80, 72, 40), (48, 40, 24)])
def test_mold_matches_jax(shape):
    """Resize + z-score + int8 quantization (pipeline.py:166-177)."""
    cfg = tiny_config(**HEART)
    vol = _volume(1, shape)
    molded, window, _ = jax_mold(vol, cfg)
    molded = jax_normalize(molded, cfg)
    want = (np.clip(molded, -5.0, 5.0) * cfg.wire_int8_scale).astype(np.int8)
    pm, pw = mold_volume(vol, pconfig.tiny_config(**HEART))
    pm = normalize_intensity(pm)
    np.testing.assert_array_equal(pw, window)
    np.testing.assert_array_equal(pm, molded)
    np.testing.assert_array_equal(quantize_int8(pm, cfg.wire_int8_scale),
                                  want)


OVERRIDES = [HEART, dict(detection_max_instances=1, approx_topk=False),
             dict(HEART, stage="finetune"), dict(HEART, num_classes=17)]
OVERRIDE_IDS = ["heart_fast", "bf16_wire_probs", "heart_fast_finetune",
                "fast_unpacked_17_classes"]


@pytest.fixture(scope="module")
def shared_params():
    """The JAX tree for each override set, and its conversion."""
    out = {}
    for name, overrides in zip(OVERRIDE_IDS, OVERRIDES):
        jcfg = tiny_config(**overrides, nms_backend="scan")
        pcfg = pconfig.tiny_config(**overrides)
        jp = jax_params(jcfg, 2)
        out[name] = (jcfg, pcfg, jp, weights.params_from_numpy(jp, pcfg))
    return out


def _assert_same_result(got, want, vol):
    assert len(want["scores"]) >= 1, "no detection to compare"
    np.testing.assert_array_equal(got["rois"], want["rois"])
    np.testing.assert_array_equal(got["class_ids"], want["class_ids"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5)
    assert got["mask"].shape == want["mask"].shape == vol.shape
    assert got["mask"].dtype == np.int16
    agree = float((got["mask"] == want["mask"]).mean())
    assert agree >= 0.999, f"label volumes agree on {agree:.5f}"


@pytest.mark.parametrize("name", OVERRIDE_IDS)
def test_detect_matches_jax(monkeypatch, shared_params, name):
    """Both detectors on one volume and shared weights, with the NumPy
    mold and unmold.  With 17 classes the fast path's labels do not fit
    the 4-bit packing: the graph returns int8 labels unpacked and
    ``detect`` reads ``mask_labels``, as the JAX ``_finish`` does."""
    monkeypatch.setattr(native, "available", lambda: False)
    jcfg, pcfg, jp, tp = shared_params[name]
    vol = _volume(3)
    want = JaxDetector(jcfg, jp).detect(vol)
    got = Detector(pcfg, tp, device="cpu", native=False).detect(vol)
    _assert_same_result(got, want, vol)


@pytest.mark.parametrize("name", OVERRIDE_IDS)
def test_detect_matches_jax_native(shared_params, name):
    """The same with the native host ops on both sides, as both serve:
    the slab-pipelined int8 mold on the packed cases (engaged on both),
    the one-pass native molds otherwise, the native unmolds.  The wire is
    bit-equal (the JAX slabs concatenated against the port's device
    tensor), and so are the bytes each detect() moved."""
    if not native.available():
        pytest.fail("the JAX package's native library did not build")
    jcfg, pcfg, jp, tp = shared_params[name]
    jdet = JaxDetector(jcfg, jp)
    det = Detector(pcfg, tp, device="cpu")
    packed = name != "fast_unpacked_17_classes" and "fast" in name
    assert jdet._pipelined == det._pipelined == packed
    vol = _volume(3)
    slabs, jwin, _ = jdet._mold(vol)
    wire, pwin, _ = det.mold(vol)
    jwire = np.concatenate([np.asarray(s) for s in slabs], axis=0)
    if jwire.dtype != np.int8:  # the bf16 wire: compare the bits
        jwire = jwire.view(np.uint16)
        pwire = wire[0, 0].view(torch.int16).numpy().view(np.uint16)
    else:
        pwire = wire[0, 0].numpy()
    np.testing.assert_array_equal(pwire, jwire)
    np.testing.assert_array_equal(pwin, jwin)
    want = jdet.detect(vol)
    got = det.detect(vol)
    _assert_same_result(got, want, vol)
    assert det.last_wire_bytes == jdet.last_wire_bytes


def test_detector_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = pconfig.tiny_config(**HEART)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Detector(cfg, weights.init_params(cfg))


def _load_whole(name, stage):
    path = os.path.join(ROOT, "weights", name)
    cfg = pconfig.heart_inference_config(stage)
    params, meta = weights.load_npz(path, cfg)
    assert meta["stage"] == stage
    assert meta["tag"] == "synthetic-60ep-bf16"
    with np.load(path) as z:
        n_leaves = sum(k.startswith("params/") for k in z.files)
        w = z["params/backbone/stem_conv/w"]
    flat = weights._flatten(params)
    assert len(flat) == n_leaves
    np.testing.assert_array_equal(flat["backbone/stem_conv/w"],
                                  w.astype(np.float32).transpose(4, 3, 0, 1, 2))
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        weights.layout(cfg)


def test_load_npz_consumes_every_leaf():
    _load_whole("heart_synth.npz", "beginning")


def test_load_npz_finetune_consumes_every_leaf():
    """The finetune checkpoint, out_upscale included, under the finetune
    inference config."""
    _load_whole("heart_synth_ft.npz", "finetune")


def test_params_from_numpy_rejects_unused_missing_and_misshapen():
    cfg = pconfig.tiny_config()
    tree = jax_params(tiny_config(), 0)
    weights.params_from_numpy(tree, cfg)
    extra = dict(tree, stray={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unused"):
        weights.params_from_numpy(extra, cfg)
    with pytest.raises(ValueError, match="shapes"):
        weights.params_from_numpy(tree, pconfig.tiny_config(fpn_channels=8))
    del tree["rpn"]["cls"]["b"]
    with pytest.raises(ValueError, match="missing"):
        weights.params_from_numpy(tree, cfg)


def test_init_params_fills_the_layout():
    """The seeded tree has every parameter of ``layout`` at its shape,
    Xavier-bounded convs and identity frozen BN."""
    cfg = pconfig.tiny_config()
    flat = weights._flatten(weights.init_params(cfg, seed=3))
    assert {k: tuple(v.shape) for k, v in flat.items()} == weights.layout(cfg)
    w = flat["fpn/p3_conv2/w"]
    co, ci = w.shape[:2]
    assert 0 < float(np.abs(w).max()) <= (6.0 / (27 * (co + ci))) ** 0.5
    assert np.all(flat["backbone/stem_bn/var"] == 1.0)
    again = weights._flatten(weights.init_params(cfg, seed=3))
    assert all(np.array_equal(flat[k], again[k]) for k in flat)


def test_load_npz_reads_meta(tmp_path):
    tree = weights._flatten(jax_params(tiny_config(), 1))
    arrays = {f"params/{k}": v.astype(np.float16) for k, v in tree.items()}
    arrays["__meta__"] = np.frombuffer(json.dumps({"tag": "t"}).encode(),
                                       np.uint8)
    np.savez(tmp_path / "w.npz", **arrays)
    params, meta = weights.load_npz(str(tmp_path / "w.npz"),
                                    pconfig.tiny_config())
    assert meta == {"tag": "t"}
    assert params["rpn"]["cls"]["w"].dtype == torch.float32
