"""The port's CLIs against the JAX package's, on the CPU.

``run_test`` and ``run_submit`` of both CLIs on fabricated data (the
manifest dataset of tests/test_cli_integration.py, the raw LiTS tree of
tests/test_lits_cli_integration.py, preprocessed), with shared weights
(``tests/torch_port_params.py``), the NumPy host ops on both sides (the
JAX package's native library patched away, the port given
``native=False``) and the native ones on both sides; the JAX side at
``approx_topk=False, nms_backend="scan"``.  Criteria: per-class IoU and
Dice (and LiTS' box IoUs) to rtol 1e-6, the same file names, and the
exported label volumes agreeing on >= 99.9% of voxels.  Then ``main``:
``--exact`` reaches the config; ``train --device cpu`` of both CLIs on
fabricated data (the config shrunk to the tiny one) writes its checkpoint
and metrics, alone and with ``--mesh 2`` (two gloo ranks on the CPU);
``--mesh`` over more cards than are visible stops (exit code 2) naming
their count, and ``--device-cache`` without ``--aug-device`` stops;
without ``--device`` on a machine with no card every command stops
before it loads anything.  And ``--trace``'s profiler context.
"""

import glob
import os

import numpy as np
import pytest

from cfun_tpu import config as jconfig
from cfun_tpu import native as jnative
from cfun_tpu.cli import heart_main as jheart
from cfun_tpu.cli import lits_main as jlits
from cfun_tpu.data import nifti as jnifti
from cfun_tpu.data.preprocess_lits import preprocess as jpreprocess
from cfun_tpu_torch import config as pconfig
from cfun_tpu_torch import weights
from cfun_tpu_torch.cli import heart_main as pheart
from cfun_tpu_torch.cli import lits_main as plits
from cfun_tpu_torch.cli import parse_mesh
from cfun_tpu_torch.data import nifti as pnifti
from tests.test_cli_integration import _write_synth_dataset
from tests.test_lits_cli_integration import _raw_volume
from torch_port_params import jax_params

HOSTS = ["numpy", "native", "native_fast"]
# the served wire of each family ('native_fast'): the int8 wire, labels
# packed on the device (the heart re-z-scored there, LiTS' overlap paste)
FAST = {"heart": dict(wire_image_dtype="int8", fast_unmold=True,
                      device_normalize=True),
        "lits": dict(wire_image_dtype="int8", wire_int8_scale=127.0,
                     fast_unmold=True)}


def _host(monkeypatch, host):
    """The JAX package's native ops patched away for 'numpy'; the port's
    ``native`` flag."""
    if host == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "lits_mold", lambda *a: None)
        monkeypatch.setattr(jnative, "unmold_nearest_labels",
                            lambda *a: None)
    elif not jnative.available():
        pytest.fail("the JAX package's native library did not build")
    return host != "numpy"


def _configs(params, family, host):
    jcfg, pcfg, jp, tp = params
    if host == "native_fast":
        jcfg, pcfg = (c.replace(**FAST[family]) for c in (jcfg, pcfg))
    return jcfg, pcfg, jp, tp


def _same_exports(jdir, pdir):
    """The same file names, each pair of label volumes (and affines)
    agreeing on >= 99.9% of voxels."""
    names = sorted(os.listdir(jdir))
    assert names and sorted(os.listdir(pdir)) == names
    for name in names:
        jd, ja = jnifti.load(os.path.join(jdir, name))
        pd, pa = pnifti.load(os.path.join(pdir, name))
        assert pd.shape == jd.shape and pd.dtype == jd.dtype
        np.testing.assert_array_equal(pa, ja)
        agree = float((pd == jd).mean())
        assert agree >= 0.999, f"{name}: labels agree on {agree:.5f}"
    return names


# ---- heart -----------------------------------------------------------------

@pytest.fixture(scope="module")
def heart_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("heartdata"))
    _write_synth_dataset(root)
    return root


@pytest.fixture(scope="module")
def heart_params():
    jcfg = jconfig.tiny_config(detection_max_instances=1, approx_topk=False,
                               nms_backend="scan")
    pcfg = pconfig.tiny_config(detection_max_instances=1)
    # a seed whose detections overlap the drawn organs
    jp = jax_params(jcfg, 4)
    return jcfg, pcfg, jp, weights.params_from_numpy(jp, pcfg)


@pytest.mark.parametrize("host", HOSTS)
def test_heart_run_test_matches_jax(monkeypatch, tmp_path, heart_root,
                                    heart_params, host):
    """Both ``run_test``s over the three manifest volumes (the native case
    draws the box wireframe into the exports too)."""
    native = _host(monkeypatch, host)
    jcfg, pcfg, jp, tp = _configs(heart_params, "heart", host)
    bbox = host == "native"
    jious, jdices = jheart.run_test(jcfg, jp, heart_root, 3, True, bbox,
                                    results_dir=str(tmp_path / "jax"))
    pious, pdices = pheart.run_test(pcfg, tp, heart_root, 3, True, bbox,
                                    results_dir=str(tmp_path / "port"),
                                    device="cpu", native=native)
    assert pious.shape == pdices.shape == (3, pcfg.num_classes - 1)
    assert float(pdices.max()) > 0.0, "nothing segmented to compare"
    np.testing.assert_allclose(pious, jious, rtol=1e-6)
    np.testing.assert_allclose(pdices, jdices, rtol=1e-6)
    names = _same_exports(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert len(names) == 3


@pytest.mark.parametrize("host", HOSTS)
def test_heart_run_submit_matches_jax(monkeypatch, tmp_path, heart_root,
                                      heart_params, host):
    native = _host(monkeypatch, host)
    jcfg, pcfg, jp, tp = _configs(heart_params, "heart", host)
    jheart.run_submit(jcfg, jp, heart_root, 2,
                      results_dir=str(tmp_path / "jax"))
    per_volume = pheart.run_submit(pcfg, tp, heart_root, 2,
                                   results_dir=str(tmp_path / "port"),
                                   device="cpu", native=native)
    assert per_volume > 0.0
    names = _same_exports(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert names == ["img_000.nii.gz", "img_001.nii.gz"]


# ---- LiTS ------------------------------------------------------------------

def _tiny_lits(mod, **overrides):
    """The JAX LiTS CLI tests' config (tests/test_lits_variant.py's
    ``_tiny_lits`` at 'together', two instances)."""
    return mod.tiny_config("together").replace(
        name="lits", num_classes=3, backbone="P3D35",
        intensity_norm="hu_window", pad_shape=(64, 128, 128),
        mask_class_weights=(1.0, 1.0, 100.0), unet_dropout_rate=0.0,
        mask_shape_override=(16, 16, 16), mask_pool_size=(16, 16, 16),
        detection_max_instances=2, **overrides)


@pytest.fixture(scope="module")
def lits_dirs(tmp_path_factory):
    """tests/test_lits_cli_integration.py's raw tree and its cache (two
    train volumes, one test volume), the raw test volume linked into the
    cache as the real layout has it."""
    raw = str(tmp_path_factory.mktemp("lits_raw"))
    cache = str(tmp_path_factory.mktemp("lits_cache"))
    affine = np.diag([0.8, 0.8, 1.5, 1.0])
    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        os.makedirs(os.path.join(raw, sub))
    for i in (0, 1):
        image, label = _raw_volume(seed=i)
        jnifti.save(os.path.join(raw, "imagesTr", f"volume-{i}.nii.gz"),
                    image.astype(np.int16), affine)
        jnifti.save(os.path.join(raw, "labelsTr",
                                 f"segmentation-{i}.nii.gz"), label, affine)
    timage, _ = _raw_volume(seed=7)
    jnifti.save(os.path.join(raw, "imagesTs", "test-volume-0.nii.gz"),
                timage.astype(np.int16), affine)
    jpreprocess(raw, cache, n_train=2, n_test=1)
    os.symlink(os.path.join(raw, "imagesTs"), os.path.join(cache, "imagesTs"))
    return raw, cache


@pytest.fixture(scope="module")
def lits_params():
    jcfg = _tiny_lits(jconfig, approx_topk=False, nms_backend="scan")
    pcfg = _tiny_lits(pconfig)
    jp = jax_params(jcfg, 5)
    return jcfg, pcfg, jp, weights.params_from_numpy(jp, pcfg)


@pytest.mark.parametrize("host", HOSTS)
def test_lits_run_test_matches_jax(monkeypatch, tmp_path, lits_dirs,
                                   lits_params, host):
    native = _host(monkeypatch, host)
    _, cache = lits_dirs
    jcfg, pcfg, jp, tp = _configs(lits_params, "lits", host)
    jbox, jious = jlits.run_test(jcfg, jp, cache, 0, True, False,
                                 results_dir=str(tmp_path / "jax"))
    pbox, pious = plits.run_test(pcfg, tp, cache, 0, True, False,
                                 results_dir=str(tmp_path / "port"),
                                 device="cpu", native=native)
    assert len(pbox) == len(jbox) == 2, "a detection on each volume"
    assert len(pious) == len(jious) == 2
    np.testing.assert_allclose(pbox, jbox, rtol=1e-6)
    np.testing.assert_allclose(np.array(pious), np.array(jious), rtol=1e-6)
    assert float(np.max(pious)) > 0.0, "nothing segmented to compare"
    names = _same_exports(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert sorted(n.split("_", 1)[1] for n in names) == ["liver_0.nii.gz",
                                                         "liver_1.nii.gz"]


@pytest.mark.parametrize("host", HOSTS)
def test_lits_run_submit_matches_jax(monkeypatch, tmp_path, lits_dirs,
                                     lits_params, host):
    """The test volume's segmentation, resized back to the raw geometry."""
    native = _host(monkeypatch, host)
    raw, cache = lits_dirs
    jcfg, pcfg, jp, tp = _configs(lits_params, "lits", host)
    jlits.run_submit(jcfg, jp, cache, results_dir=str(tmp_path / "jax"))
    plits.run_submit(pcfg, tp, cache, results_dir=str(tmp_path / "port"),
                     device="cpu", native=native)
    names = _same_exports(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert names == ["test-segmentation-0.nii"]
    data, affine = pnifti.load(str(tmp_path / "port" / names[0]))
    rdata, raffine = pnifti.load(os.path.join(raw, "imagesTs",
                                              "test-volume-0.nii.gz"))
    assert data.shape == rdata.shape
    np.testing.assert_array_equal(affine, raffine)


def test_lits_preprocess_command_matches_jax(tmp_path, lits_dirs):
    """``main(["preprocess", ...])`` writes the JAX package's cache."""
    raw, cache = lits_dirs
    out = str(tmp_path / "cache")
    assert plits.main(["preprocess", "--data", raw, "--out", out]) is None
    for sub, name in (("image_np", "liver_1.npy"),
                      ("label_np", "liver_label_1.npy"),
                      ("image_test_np", "liver_0.npy")):
        with open(os.path.join(out, sub, name), "rb") as a, \
                open(os.path.join(cache, sub, name), "rb") as b:
            assert a.read() == b.read(), name


# ---- main ------------------------------------------------------------------

@pytest.mark.parametrize("family", ["heart", "lits"])
def test_exact_flag_reaches_config(monkeypatch, heart_root, family):
    """As tests/test_cli_integration.py checks for the JAX CLI: ``--exact``
    takes ``exact_reference_overrides()`` into the inference config, and
    ``--device cpu`` reaches ``run_test``."""
    mod = pheart if family == "heart" else plits
    seen = {}

    def fake_run_test(cfg, params, data_dir, limit, save, bbox, device,
                      span_log):
        seen.update(cfg=cfg, device=device, limit=limit, span_log=span_log)

    monkeypatch.setattr(mod, "run_test", fake_run_test)
    # the parameters are unused by the fake; skip the full-size init
    monkeypatch.setattr(weights, "init_params", lambda cfg, seed: {})
    argv = ["test", "--weights", "none", "--data", heart_root, "--device",
            "cpu", "--stage", "finetune"]
    mod.main(argv + ["--exact"])
    cfg = seen["cfg"]
    assert (cfg.name, cfg.stage, seen["device"]) == (family, "finetune",
                                                     "cpu")
    assert cfg.wire_image_dtype == "bfloat16"
    assert cfg.fast_unmold is False and cfg.device_normalize is False
    assert cfg.approx_topk is False and cfg.nms_backend == "scan"
    mod.main(argv)
    cfg = seen["cfg"]
    assert cfg.wire_image_dtype == "int8" and cfg.fast_unmold is True
    assert seen["limit"] == (5 if family == "heart" else 111)
    assert seen["span_log"] is None  # no --trace: the spans only time
    if family == "lits":
        assert cfg.wire_int8_scale == 127.0
    else:
        assert cfg.device_normalize is True


def _train_cfg(mod, stage, family):
    """The family's train config shrunk as the CLI A/Bs shrink theirs:
    the tiny config (LiTS: tests/test_torch_port_feeder.py's tiny LiTS),
    two steps an epoch, one validation forward every epoch."""
    loop = dict(steps_per_epoch=2, validation_steps=1, val_every_epochs=1)
    if family == "heart":
        return mod.tiny_config(stage, **loop)
    return mod.tiny_config(stage, **loop).replace(
        name="lits", num_classes=3, backbone="P3D35",
        intensity_norm="hu_window", pad_shape=(40, 72, 72),
        mask_class_weights=(1.0, 1.0, 100.0), unet_dropout_rate=0.0,
        mask_shape_override=(16, 16, 16), mask_pool_size=(16, 16, 16),
        wire_int8_scale=127.0)


@pytest.fixture(scope="module")
def train_roots(tmp_path_factory):
    """Fabricated training data: a heart manifest of 15 volumes (the first
    13 validate), and a LiTS cache with train volume 0 and validation
    volume 111."""
    heart = str(tmp_path_factory.mktemp("heart_train"))
    _write_synth_dataset(heart, n=15)
    lits = str(tmp_path_factory.mktemp("lits_train"))
    for sub in ("image_np", "label_np"):
        os.makedirs(os.path.join(lits, sub))
    for i in (0, 111):
        image, label = _raw_volume(seed=i)
        np.save(os.path.join(lits, "image_np", f"liver_{i}.npy"),
                image.astype(np.float32))
        np.save(os.path.join(lits, "label_np", f"liver_label_{i}.npy"),
                label.astype(np.int16))
    return {"heart": heart, "lits": lits}


def _train_argv(root, logs, *extra):
    return ["train", "--weights", "none", "--stage", "beginning", "--data",
            root, "--logs", logs, "--epochs", "1", "--workers", "2",
            "--device", "cpu", *extra]


def _check_train_outputs(ckpt, logs, family, ranks):
    """``model.npz`` (parameters, the optimizer's leaves, epoch 1 after 2
    steps) and one ``train_metrics.jsonl`` a rank (the epoch's loss and
    its validation loss)."""
    import json

    assert ckpt.endswith("model.npz") and os.path.isfile(ckpt)
    with np.load(ckpt) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        assert any(k.startswith("opt/") for k in data.files)
        assert any(k.startswith("params/") for k in data.files)
    assert (meta["epoch"], meta["step"], meta["name"]) == (1, 2, family)
    assert len(glob.glob(os.path.join(logs, "**", "model.npz"),
                         recursive=True)) == 1
    files = glob.glob(os.path.join(logs, "**", "train_metrics.jsonl"),
                      recursive=True)
    assert len(files) == ranks
    for name in files:
        with open(name) as f:
            records = [json.loads(line) for line in f]
        assert [r["epoch"] for r in records] == [1, 1]
        assert np.isfinite(records[0]["loss"]) and records[0]["steps"] == 2
        assert np.isfinite(records[1]["val_loss"])


@pytest.mark.parametrize("family", ["heart", "lits"])
def test_train_writes_checkpoint_and_metrics(monkeypatch, tmp_path,
                                             train_roots, family):
    """``train --device cpu`` runs the loop on the fabricated data (the
    family's config shrunk) and writes its checkpoint and metrics."""
    mod = pheart if family == "heart" else plits
    name = "heart_config" if family == "heart" else "lits_config"
    monkeypatch.setattr(pconfig, name, lambda stage, **kw: _train_cfg(
        pconfig, stage, family))
    logs = str(tmp_path / "logs")
    ckpt = mod.main(_train_argv(train_roots[family], logs))
    _check_train_outputs(ckpt, logs, family, 1)


@pytest.mark.parametrize("family", ["heart", "lits"])
def test_train_mesh_on_cpu_ranks(monkeypatch, tmp_path, train_roots,
                                 family):
    """``train --device cpu --mesh 2``: two gloo ranks on the CPU, each
    volume of a step on its own rank; rank 0 writes the checkpoint, each
    rank its metrics (``-rank{i}``)."""
    mod = pheart if family == "heart" else plits
    name = "heart_config" if family == "heart" else "lits_config"
    monkeypatch.setattr(pconfig, name, lambda stage, **kw: _train_cfg(
        pconfig, stage, family))
    logs = str(tmp_path / "logs")
    ckpt = mod.main(_train_argv(train_roots[family], logs, "--mesh", "2"))
    _check_train_outputs(ckpt, logs, family, 2)
    assert sorted(os.path.basename(os.path.dirname(f))[-6:] for f in
                  glob.glob(os.path.join(logs, "**", "train_metrics.jsonl"),
                            recursive=True)) == ["-rank0", "-rank1"]


@pytest.mark.parametrize("family", ["heart", "lits"])
def test_train_multi_device_mesh_stops(monkeypatch, capsys, tmp_path,
                                       train_roots, family):
    """``--device cuda --mesh 2`` with one card visible stops with exit
    code 2 and names the count: no rank starts, nothing carries on with
    fewer cards or on the CPU."""
    import torch

    mod = pheart if family == "heart" else plits
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(weights, "init_params",
                        lambda *a, **k: calls.append(a))
    with pytest.raises(SystemExit) as exc:
        mod.main(_train_argv(train_roots[family], str(tmp_path))[:-2]
                 + ["--device", "cuda", "--mesh", "2"])
    assert exc.value.code == 2 and calls == []
    assert "only 1 CUDA device(s) are visible" in capsys.readouterr().err


def test_train_device_cache_needs_aug_device(tmp_path, train_roots):
    with pytest.raises(SystemExit, match="--device-cache requires "
                                         "--aug-device"):
        pheart.main(_train_argv(train_roots["heart"], str(tmp_path),
                                "--device-cache"))


@pytest.mark.parametrize("family", ["heart", "lits"])
@pytest.mark.parametrize("command", ["train", "test", "submit"])
def test_no_card_and_no_device_flag_stops(monkeypatch, capsys, heart_root,
                                          family, command):
    """Without ``--device`` the commands run on CUDA; with no card they
    stop with an error before loading weights, and never reach the
    command on the CPU."""
    import torch

    mod = pheart if family == "heart" else plits
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mod, "run_test", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(mod, "run_submit", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(weights, "init_params",
                        lambda *a, **k: calls.append(a))
    with pytest.raises(SystemExit) as exc:
        mod.main([command, "--weights", "none", "--stage", "beginning",
                  "--data", heart_root])
    assert exc.value.code != 0 and calls == []
    assert "no CUDA device" in capsys.readouterr().err


def test_detector_without_card_raises(monkeypatch, heart_params):
    """``run_test`` itself, with its default device, raises without a
    card rather than running on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pcfg, _, tp = heart_params
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pheart.run_test(pcfg, tp, "unused", 1, False, False)


def test_parse_mesh_spec():
    assert parse_mesh(None) is None
    assert parse_mesh("") is None
    assert parse_mesh("4") == (4, 1)
    assert parse_mesh("4,2") == (4, 2)
    for bad in ("4,2,1", "0"):
        with pytest.raises(ValueError):
            parse_mesh(bad)


def test_draw_bbox_wireframe_matches_jax():
    rng = np.random.default_rng(3)
    for roi in ([2, 3, 1, 10, 12, 6], [-4, 5, 0, 30, 9, 40]):
        want = rng.integers(0, 3, size=(14, 15, 8)).astype(np.int16)
        got = want.copy()
        jheart.draw_bbox_wireframe(want, roi)
        pheart.draw_bbox_wireframe(got, roi)
        np.testing.assert_array_equal(got, want)
        assert (got == 10).any()


def test_device_trace_names_annotated_region(tmp_path):
    """``device_trace`` on the CPU writes a Chrome/Perfetto trace that
    names each stage of a detector's request (its spans, on with a span
    log, as the CLIs' ``--trace`` runs it) and the ops inside them."""
    import json

    from cfun_tpu_torch.inference import Detector
    from cfun_tpu_torch.utils.profiling import SpanLog, device_trace

    cfg = pconfig.tiny_config(detection_max_instances=1)
    det = Detector(cfg, weights.init_params(cfg, seed=0), device="cpu",
                   native=False)
    det.spans.log = SpanLog()
    vol = np.random.default_rng(0).normal(size=(48, 48, 20))
    with device_trace(str(tmp_path)):
        det.detect(vol.astype(np.float32))
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"mold", "dispatch", "wait", "finish", "unpack",
            "paste"} <= ranges
    assert any(e.get("name") == "aten::conv3d" for e in events)


def test_import_scan_covers_the_slice():
    """tests/test_torch_port_imports.py imports every module
    ``pkgutil.walk_packages`` finds in the port; this slice's are among
    them."""
    import pkgutil

    import cfun_tpu_torch

    found = {m.name for m in pkgutil.walk_packages(cfun_tpu_torch.__path__,
                                                   "cfun_tpu_torch.")}
    slice_modules = {f"cfun_tpu_torch.{m}" for m in (
        "cli", "cli.heart_main", "cli.lits_main", "utils",
        "utils.checkpoint", "utils.metrics", "utils.profiling",
        "utils.torch_convert", "utils.logging", "data.nifti",
        "data.datasets", "data.preprocess_lits", "data.feeder",
        "ops.augment", "train.loop", "parallel", "parallel.mesh",
        "parallel.halo", "parallel.launch")}
    assert slice_modules <= found, sorted(slice_modules - found)
