"""The heart training cell's pieces on the CPU at a tiny size: the loop's
stop hook and spans (``train/loop.py::train_model``), and the program's
train step held against the benchmark's plain training reference
(``portbench/reference/train.py``) through the cell's own run
(``portbench/drivers/train.py``): the loss parts, every gradient leaf,
the update, the detection targets, the RPN targets and K1's keep set.
The float8 control and planted faults (``portbench/faults_train.py``)
read not correct.

The tiny configuration is ``tiny_config('beginning')`` in float32 with
eight classes (the synthetic heart's labels), every anchor before the NMS
(288 -> 128 kept) and a detection-target IoU of 0.1, so that the seeded
tiny weights' proposals give each step positive ROIs and the mask branch
runs.  Both sides compute in float32 on the CPU, so the limits are those
of float32 rounding: the same boxes before the NMS (every anchor is
taken), each loss part to 1e-5, each leaf's and each module's gradient
cosine at least 0.9999, the global gradient norm to 1e-5, the update
(the new momentum, leaf by leaf, and the parameter change) to 1e-5."""

import glob
import json
import os
import threading
import time
import types

import pytest
import torch

from cfun_tpu_torch.config import tiny_config
from cfun_tpu_torch.train import loop
from cfun_tpu_torch.utils.profiling import SpanLog, SpanRecorder
from portbench import harness
from portbench.drivers import train as train_cell
from portbench.faults_train import planted

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SEED = 2 ** 31 + 5
OVER = dict(num_classes=8, pre_nms_limit=288, post_nms_rois_training=128,
            steps_per_epoch=4, val_every_epochs=1000000,
            detection_target_iou=0.1)
LIMITS = {"proposal_mismatch": 0, "k1_keep_mismatch": 0,
          "targets_mismatch": 0, "rpn_target_violations": 0,
          "loss_rel_err": 1e-5, "grad_cos_min": 0.9999,
          "grad_cos_group_min": 0.9999, "grad_norm_rel_err": 1e-5,
          "update_rel_err": 1e-5}


def _config():
    full = harness.config_file("heart-train")
    cfg = tiny_config("beginning", **OVER)
    model = {k: train_cell._plain(getattr(cfg, k)) for k in full["model"]}
    train = dict(full["train"], factory="tiny_config", weights="none",
                 overrides=OVER, limits=dict(LIMITS),
                 volumes={"generator": "heart", "hw": [48, 48],
                          "depths": [20, 28]})
    return {"name": "tiny-heart-train", "train": train, "model": model}


def _run(trace=0, controls=()):
    bench = harness.benchmark(ROOT)
    cell = harness.cell_of(bench, "heart-train.train")
    traffic = dict(harness.traffic_file("train_loop"), workers=2,
                   warmup_steps=2, trace_from=3, trace_steps=5)
    ctx = types.SimpleNamespace(
        root=ROOT, bench=bench, cell=cell, config=_config(),
        traffic=traffic, seed=SEED, seconds=1.0, trace=bool(trace),
        device=CPU, t0=time.perf_counter(),
        metrics=harness.metrics_of(bench, cell, bool(trace)),
        controls=controls)
    return train_cell.run(ctx)


@pytest.fixture(scope="module")
def sound():
    return _run(controls=("fp8",))


def test_the_configuration_file_holds_what_the_port_runs():
    config = harness.config_file("heart-train")
    cfg = train_cell.port_config(config["train"], config["model"])
    assert cfg.compute_dtype == "bfloat16" and cfg.stage == "beginning"
    assert config["reduced"] == []
    assert os.path.exists(os.path.join(ROOT, config["train"]["weights"]))


def test_the_step_agrees_with_the_reference(sound):
    assert sound["correct"] is True, sound["compared"]
    assert sound["failed"] == 0 and sound["attempted"] >= 1
    assert len(sound["info"]["judged_steps"]) == 2
    for r in sound["readings"]:
        assert r["positive_rois"] >= 1
        assert r["k1_keep_mismatch"] == r["targets_mismatch"] == 0
        assert r["rpn_target_violations"] == r["proposal_mismatch"] == 0
        assert {"grad_cos.backbone", "grad_cos.mask"} <= set(r)
    assert set(sound["metrics"]) == {"setup_s", "volumes_per_s",
                                     "peak_mem_gib"}


def test_the_float8_control_is_not_correct(sound):
    ok, rows = train_cell.compare_train.verdict(sound["controls"]["fp8"],
                                            LIMITS)
    assert not ok, rows


@pytest.mark.parametrize("fault", ["mask_weight_0", "dropout_ignored",
                                   "k1_iou_05", "pre_nms_half",
                                   "deltas_unscaled", "decay_on_norm",
                                   "clip_skipped"])
def test_a_broken_step_is_not_correct(fault):
    with planted(fault):
        out = _run()
    assert out["correct"] is False, out["compared"]


def test_the_mask_unet_is_judged_as_one_module():
    """A wrong U-Net gradient reads in ``grad_cos_group_min`` however small
    a share of the global norm each of its leaves carries."""
    want = {"backbone/w": torch.tensor([100.0, 0.0]),
            "mask/unet/a/w": torch.tensor([0.01, 0.02]),
            "mask/unet/b/w": torch.tensor([0.02, -0.01])}
    got = dict(want, **{"mask/unet/a/w": torch.tensor([-0.01, -0.02])})
    numbers = train_cell.compare_train.gradient_numbers(got, want)
    assert numbers["grad_cos_min"] == pytest.approx(1.0)  # the share hides
    assert numbers["grad_cos.mask"] == pytest.approx(0.0, abs=1e-9)
    assert numbers["grad_cos_group_min"] == numbers["grad_cos.mask"]


def test_observers_run_on_one_device_only(tmp_path):
    with pytest.raises(ValueError, match="one device"):
        loop.train_model(tiny_config("beginning", **OVER), [], [],
                         log_dir=str(tmp_path), mesh_spec=(1, 1),
                         device="cpu", observers={})


def test_a_traced_run_reads_the_loop_spans():
    out = _run(trace=1)
    assert out["correct"] is True, out["compared"]
    # on the CPU: no device metric, the span and FLOP readers only
    assert {"feed_wait_ms.train", "item_ms.train", "enqueue_ms.train",
            "mfu.train"} <= set(out["metrics"])


def test_a_program_without_the_hook_stops_at_once(monkeypatch):
    def old_train_model(cfg, train_dataset, val_dataset, log_dir="./logs",
                        weights=None, epochs=None, seed=0, num_workers=8,
                        mesh_spec=None, device="cuda", backend=None,
                        devices=None):
        raise AssertionError("not to be called")

    monkeypatch.setattr(loop, "train_model", old_train_model)
    t = time.perf_counter()
    with pytest.raises(SystemExit):
        _run()
    assert time.perf_counter() - t < 5.0


# ---- the loop ---------------------------------------------------------------

def _loop_run(tmp_path, on_step=None, spans=None, epochs=2):
    cfg = tiny_config("beginning", **OVER)
    data = train_cell.held_volumes(_config()["train"]["volumes"], SEED, CPU)
    log = str(tmp_path)
    out = loop.train_model(cfg, data, data, log_dir=log, weights="none",
                           epochs=epochs, seed=SEED, num_workers=2,
                           device="cpu", on_step=on_step, spans=spans)
    records = []
    for f in glob.glob(os.path.join(log, "**", "train_metrics.jsonl"),
                       recursive=True):
        with open(f) as fh:
            records += [json.loads(line) for line in fh]
    return out, [r for r in records if "loss" in r]


def test_the_hook_stops_the_loop_after_n_steps(tmp_path):
    seen = []

    def stop(step, metrics):
        assert isinstance(metrics["total_loss"], torch.Tensor)
        seen.append(step)
        return len(seen) == 6

    out, epochs = _loop_run(tmp_path, stop, epochs=5)
    assert seen == list(range(6))
    assert out is None  # no final checkpoint
    assert [r["epoch"] for r in epochs] == [1]  # 6 steps: one epoch ends
    assert not glob.glob(os.path.join(str(tmp_path), "**", "model*"),
                         recursive=True)


# the epoch losses of this run from the loop as it was before the hook
# and the spans (its parent commit, on the CPU; equal bit for bit there)
BEFORE = [{"loss": 157.8546600341797, "rpn_class_loss": 0.693907618522644,
           "rpn_bbox_loss": 0.7624961733818054,
           "mrcnn_class_loss": 0.6918513178825378,
           "mrcnn_bbox_loss": 2.3520331382751465,
           "mrcnn_mask_loss": 2.606571674346924},
          {"loss": 133.7661590576172, "rpn_class_loss": 0.6180922985076904,
           "rpn_bbox_loss": 0.7540666460990906,
           "mrcnn_class_loss": 0.6917964220046997,
           "mrcnn_bbox_loss": 1.5526137351989746,
           "mrcnn_mask_loss": 2.509530782699585}]


def test_without_a_hook_the_losses_are_those_of_before(tmp_path):
    out, plain = _loop_run(tmp_path / "plain")
    _, hooked = _loop_run(tmp_path / "hooked", lambda step, m: False)
    assert out is not None and os.path.exists(out)
    keys = [k for k in plain[0] if k.endswith("_loss") or k == "loss"]
    assert len(plain) == len(hooked) == 2
    for a, b, want in zip(plain, hooked, BEFORE):
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
        for k, v in want.items():
            assert a[k] == pytest.approx(v, rel=1e-4), k


def test_the_loop_times_itself_in_spans(tmp_path):
    spans = SpanRecorder(SpanLog())
    _loop_run(tmp_path, lambda step, m: step == 5, spans=spans)
    got = spans.log.take()
    names = {s.name for s in got}
    assert {"feed", "step", "forward", "backward", "update", "epoch_end",
            "item", "load", "mold", "labels", "rpn"} <= names
    main = threading.current_thread().name
    for s in got:
        if s.name in ("forward", "backward", "update"):
            assert s.parent == "step" and s.thread == main
        if s.name in ("load", "mold", "labels", "rpn"):
            assert s.parent == "item"
        if s.name == "item":
            assert s.thread != main and s.parent is None
        if s.name in ("feed", "step", "epoch_end"):
            assert s.parent is None and s.thread == main
    feeds = [s for s in got if s.name == "feed"]
    assert all(s.counts["h2d"] == 0 for s in feeds)  # the CPU sends none
    steps = sorted(s.request for s in got if s.name == "step")
    assert steps == list(range(6))
    assert [s.request for s in got if s.name == "epoch_end"] == [1]
