"""A run of a cell, driven on the CPU at a tiny size with the look for a
card skipped: the reference agrees with the port's CPU path, the result
line has the benchmark's keys, the float8 control and a program broken
underneath come out not correct, and without a card the measuring path
stops with no result."""

import json
import time

import numpy as np
import pytest
import torch

import tiny
from portbench import compare, harness
from portbench.control import readings
from portbench.faults import planted
from portbench.run import ROOT, main, run_cell

CPU = torch.device("cpu")
# seeds whose seeded tiny weights keep detections on the CPU
SEEDS = {"heart": 3, "lits": 1}


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark(ROOT)


def run(bench, family, seed, trace=0, device=CPU):
    cell = harness.cell_of(bench, f"{family}.serve")
    return run_cell(ROOT, bench, cell, seed, 0.5, trace, device,
                    time.perf_counter(), config=tiny.config(family),
                    traffic=tiny.traffic())


def line(out):
    return harness.result_line(out["correct"], out["attempted"],
                               out["failed"], out["metrics"], out["device"],
                               out["compared"], out["breakdown"])


@pytest.mark.parametrize("family", ["heart", "lits"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_agrees_with_the_reference_and_prints_its_keys(bench, family,
                                                             trace):
    out = run(bench, family, SEEDS[family] + 2 ** 31, trace)
    result = json.loads(json.dumps(line(out)))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] * trace + ["compared"]
    assert list(result) == keys
    assert result["correct"] is True, out["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = {m["name"] for m in harness.metrics_of(
        bench, harness.cell_of(bench, f"{family}.serve"), bool(trace))}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
    for row in result["compared"]:
        assert row["value"] == 0.0 or row["name"].startswith("label_gap")


@pytest.mark.parametrize("family", ["heart", "lits"])
def test_the_float8_control_is_not_correct(family):
    seed = SEEDS[family]
    got = readings(ROOT, tiny.config(family), [seed], CPU)[seed]
    ok, _ = compare.verdict(got["control"], tiny.LIMITS)
    assert not ok, got["control"]
    ok, _ = compare.verdict(got["program"], tiny.LIMITS)
    assert ok, got["program"]


def _alter_host_labels(monkeypatch):
    """The raw-geometry label volume altered where the host unmold
    produces it."""
    from cfun_tpu_torch.inference.pipeline import Detector

    real = Detector.unmold

    def broken(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        mask = out["mask"]
        mask[..., : max(1, mask.shape[2] // 4)] = 1
        return out

    monkeypatch.setattr(Detector, "unmold", broken)


# each fault a family's served path can show; a partial loss needs more
# than the heart's one detection
FAULTS = [(family, name) for family in ("heart", "lits")
          for name in ("device_labels", "host_labels", "drop_all",
                       "k1_no_suppression", "k1_second_best",
                       "drop_partial", "box_moved")
          if not (family == "heart" and name == "drop_partial")]


@pytest.mark.parametrize("family,fault", FAULTS)
def test_a_broken_program_is_not_correct(bench, monkeypatch, family, fault):
    if fault == "host_labels":
        _alter_host_labels(monkeypatch)
        out = run(bench, family, SEEDS[family])
    else:
        with planted(fault):
            out = run(bench, family, SEEDS[family])
    assert out["correct"] is False, out["compared"]


def test_without_a_card_the_run_stops_with_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["--workload", "heart.serve", "--seed", "1", "--seconds", "1",
               "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["heart", "lits"])
def test_a_tiny_run_on_the_card_agrees_with_the_reference(bench, card,
                                                          family,
                                                          monkeypatch):
    # the tiny configurations state float32: no TF32 in the program either
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    out = run(bench, family, SEEDS[family], trace=1, device=card)
    assert out["correct"] is True, out["compared"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert np.isfinite(out["device"]["window_s"])
