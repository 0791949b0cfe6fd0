"""The device's idle time split by the program's spans
(``portbench/spans.py``) and the readers of the span metrics: on a
synthetic timeline the idle time by span plus 'host' is the window less
the busy time, each idle instant goes to the latest begun open span, and
launch calls to the span they begin in; on a CPU profile of the tiny
detector the spans are found by name; the readers return nothing from
records without spans (a program without them); ``span_probe.py`` runs
a tiny cell on the CPU."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tiny
from cfun_tpu_torch.utils.profiling import SpanLog
from portbench import harness, span_probe, spans
from portbench.run import ROOT

READERS = ("dispatch_ms.serve", "wait_ms.serve", "launches.serve",
           "idle_dispatch_ms.serve", "idle_mold_ms.serve",
           "idle_finish_ms.serve")
TOP = ("mold", "dispatch", "wait", "finish")


def test_idle_splits_the_window_by_the_span_open_on_the_host():
    device = [(10, 20), (15, 30), (50, 60), (120, 130)]
    host = [(0, 25, "mold"), (25, 55, "dispatch"), (55, 58, "wait"),
            (60, 90, "finish"), (70, 80, "paste")]
    calls = [26, 27, 40, 56, 75, 95]
    out = spans.split_idle(device, host, calls, (0, 100),
                           TOP + ("paste",))
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(30e-6)  # [10, 30], [50, 60]
    idle = {k: round(v * 1e6, 9) for k, v in out["idle_s"].items()}
    assert idle == {"mold": 10, "dispatch": 20, "wait": 0, "finish": 20,
                    "paste": 10, "host": 10}
    assert sum(out["idle_s"].values()) == pytest.approx(
        out["window_s"] - out["busy_s"])
    assert out["launches"] == {"mold": 0, "dispatch": 3, "wait": 1,
                               "finish": 0, "paste": 1}
    # a stage named alone counts its children
    out = spans.split_idle(device, host[:4], calls, (0, 100), TOP)
    assert out["idle_s"]["finish"] == pytest.approx(30e-6)


@pytest.fixture(scope="module")
def tiny_detector():
    from portbench.drivers import serve

    config = tiny.config("heart")
    _, _, det, _ = serve.build(ROOT, config["serve"], config["model"], 3,
                               torch.device("cpu"))
    vols = serve.pool(config["serve"], 3, torch.device("cpu"))
    det.warmup()
    yield det, vols
    det.close()


def test_a_cpu_profile_of_the_detector_splits_by_its_spans(tiny_detector):
    det, vols = tiny_detector
    det.spans.log = SpanLog()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            for v in vols:
                det.detect(v)
            wall = time.perf_counter() - t0
        logged = det.spans.log.take()
    finally:
        det.spans.log = None
    out = spans.idle_by_span(prof, TOP)
    assert out["busy_s"] == 0.0  # no device on the CPU
    assert sum(out["idle_s"].values()) == pytest.approx(out["window_s"])
    assert out["window_s"] == pytest.approx(wall, rel=0.05)
    stage_s = {n: sum(s.seconds for s in logged if s.name == n) for n in TOP}
    for name in TOP:  # a range lies inside its span's clock reads
        assert 0 < out["idle_s"][name] <= stage_s[name] * 1.001, name
    records = {"spans": logged, "idle_by_span": out, "requests": len(vols)}
    got = {m: harness.metric_reader(m)(records) for m in READERS}
    assert got["dispatch_ms.serve"] == pytest.approx(
        1e3 * stage_s["dispatch"] / len(vols))
    assert got["wait_ms.serve"] == pytest.approx(
        1e3 * stage_s["wait"] / len(vols))
    # no device trace on the CPU: its readers find nothing
    assert [got[m] for m in READERS[2:]] == [None] * 4


def test_span_readers_return_nothing_without_spans():
    parent = {"timings": [{"mold": 0.01, "device": 0.02, "unmold": 0.01,
                           "total": 0.04}], "requests": 1, "wall_s": 0.04,
              "busy_s": 0.02, "kernel_s": {}}
    for records in ({}, parent):
        for m in READERS:
            assert harness.metric_reader(m)(records) is None, m


def test_the_probe_runs_a_tiny_cell():
    bench = harness.benchmark(ROOT)
    cell = harness.cell_of(bench, "heart.serve")
    out = span_probe.probe(ROOT, cell, tiny.config("heart"),
                           tiny.traffic(), 3 + 2 ** 31, 0.2,
                           torch.device("cpu"), True)
    assert out["log_on"]["requests"] >= 1 and out["log_off"]["requests"] >= 1
    assert set(out["log_on"]["spans_ms"]) == set(span_probe.STAGES)
    traced = out["traced_log_on"]
    assert traced["dispatch_ms.serve"] > 0
    assert traced["extent_s"] == pytest.approx(traced["wall_s"], rel=0.05)
    assert out["traced_log_off"]["dispatch_ms.serve"] is None
