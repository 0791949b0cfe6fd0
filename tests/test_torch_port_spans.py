"""The detector's spans (``utils/profiling.py``), on the CPU detector of
tests/test_torch_port_stream.py: with no span log attached a request
keeps no span and opens no profiler range, and ``last_timings`` /
``last_sub_timings`` / ``last_wire_bytes`` keep their keys; with one,
``detect`` logs ``mold``, ``dispatch``, ``wait`` and ``finish`` (``unpack``
and ``paste`` in it) under one id, whose durations and counts are those
views; ``detect_stream`` gives each request its own increasing id, its
``dispatch`` on the dispatch thread and its ``wait`` and ``finish`` on the
finisher thread, and its views as each result is yielded; under
``torch.profiler`` the spans are ``record_function`` ranges and no
``aten::`` op runs inside a leaf span; ``paste`` counts the bytes the
native box paste wrote ("filled"), 0 on the NumPy route."""

import threading

import pytest
from torch.profiler import ProfilerActivity, profile

from cfun_tpu_torch.inference import Detector
from cfun_tpu_torch.utils.profiling import SpanLog, SpanRecorder
from tests.test_torch_port_stream import _volumes, detector  # noqa: F401

STAGES = ("mold", "dispatch", "wait", "finish", "unpack", "paste")
LEAVES = ("wait", "unpack", "paste")  # they enclose no launch or copy


@pytest.fixture
def logged(detector):  # noqa: F811
    detector.spans.log = SpanLog()
    try:
        yield detector
    finally:
        detector.spans.log = None


def _by_request(spans):
    out = {}
    for s in spans:
        out.setdefault(s.request, {})[s.name] = s
    return out


def _check_views(det, spans):
    """The ``last_*`` views are exactly the request's spans."""
    t, sub = det.last_timings, det.last_sub_timings
    assert t["mold"] == spans["mold"].seconds
    assert t["device"] == spans["dispatch"].seconds + spans["wait"].seconds
    assert t["unmold"] == spans["finish"].seconds
    assert t["total"] == (spans["finish"].end_ns
                          - spans["mold"].start_ns) * 1e-9
    assert sub["fetch"] == (spans["unpack"].start_ns
                            - spans["finish"].start_ns) * 1e-9
    assert sub["unpack"] == spans["unpack"].seconds
    assert sub["paste"] == spans["paste"].seconds
    assert det.last_wire_bytes == {"up": spans["mold"].counts["up"],
                                   "down": spans["dispatch"].counts["down"]}


def test_log_off_keeps_no_spans_and_the_views_keep_their_keys(
        detector):  # noqa: F811
    assert detector.spans.log is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        detector.detect(_volumes()[0])
    assert not {e.name for e in prof.events()} & set(STAGES)
    assert not getattr(detector.spans._open, "stack", [])
    assert set(detector.last_timings) == {"mold", "device", "unmold",
                                          "total"}
    assert set(detector.last_sub_timings) == {"fetch", "unpack", "paste"}
    assert set(detector.last_wire_bytes) == {"up", "down"}
    assert all(v >= 0 for v in detector.last_timings.values())


def test_detect_logs_one_request_whose_spans_are_its_views(logged):
    logged.detect(_volumes()[1])
    spans = logged.spans.log.take()
    assert len(logged.spans.log.take()) == 0  # take() empties the log
    assert [s.name for s in spans] == ["mold", "dispatch", "wait", "unpack",
                                       "paste", "finish"]
    assert {s.request for s in spans} == {logged.last_request}
    assert {s.thread for s in spans} == {threading.current_thread().name}
    by = _by_request(spans)[logged.last_request]
    assert {n: s.parent for n, s in by.items()} == {
        "mold": None, "dispatch": None, "wait": None, "finish": None,
        "unpack": "finish", "paste": "finish"}
    # one after another, unpack and paste inside finish
    order = [by[n] for n in ("mold", "dispatch", "wait", "finish")]
    for a, b in zip(order, order[1:]):
        assert a.start_ns <= a.end_ns <= b.start_ns
    for child in (by["unpack"], by["paste"]):
        assert by["finish"].start_ns <= child.start_ns <= child.end_ns \
            <= by["finish"].end_ns
    _check_views(logged, by)


def test_detect_stream_gives_each_request_its_id_and_threads(logged):
    ids, views = [], []
    for _ in logged.detect_stream(_volumes()):
        ids.append(logged.last_request)
        views.append((dict(logged.last_timings),
                      dict(logged.last_sub_timings),
                      dict(logged.last_wire_bytes)))
    assert len(set(ids)) == 3 and ids == sorted(ids)
    by = _by_request(logged.spans.log.take())
    assert sorted(by) == ids
    main = threading.current_thread().name
    for rid, (timings, sub, wire) in zip(ids, views):
        spans = by[rid]
        assert set(spans) == set(STAGES)
        assert spans["mold"].thread == main
        assert spans["dispatch"].thread.startswith("detector-dispatch")
        for name in ("wait", "finish", "unpack", "paste"):
            assert spans[name].thread.startswith("detector-finish"), name
        # the views as the result was yielded are this request's own
        logged.last_timings, logged.last_sub_timings, \
            logged.last_wire_bytes = timings, sub, wire
        _check_views(logged, spans)


def test_spans_are_profiler_ranges_and_leaves_enclose_no_op(logged):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logged.detect(_volumes()[2])
    events = list(prof.events())
    ranges = {name: [e for e in events if e.name == name] for name in STAGES}
    assert all(len(r) == 1 for r in ranges.values()), \
        {n: len(r) for n, r in ranges.items()}
    ops = [e for e in events if e.name.startswith("aten::")]

    def inside(span):
        r = span.time_range
        return [e.name for e in ops if e.thread == span.thread
                and r.start <= e.time_range.start <= r.end]

    assert inside(ranges["dispatch"][0])  # the ops the graph enqueued
    for name in LEAVES:
        assert inside(ranges[name][0]) == [], name


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_paste_counts_the_bytes_the_native_pass_filled(detector,  # noqa: F811
                                                       native):
    det = detector if native else Detector(
        detector.cfg, detector.params, device="cpu", native=False)
    det.spans.log = SpanLog()
    try:
        result = det.detect(_volumes()[0])
        pastes = [s for s in det.spans.log.take() if s.name == "paste"]
    finally:
        det.spans.log = None
        if det is not detector:
            det.close()
    assert len(result["scores"]) >= 1  # a box to paste into
    assert len(pastes) == 1
    assert pastes[0].counts == {
        "filled": result["mask"].nbytes if native else 0}


def test_the_log_is_bounded_and_an_unlogged_span_only_times():
    rec = SpanRecorder()
    with rec.span("a", 1, n=2) as s:
        pass
    assert (s.thread, s.parent, s.counts) == (None, None, {"n": 2})
    assert s.end_ns >= s.start_ns > 0
    rec.log = SpanLog(capacity=3)
    for i in range(5):
        with rec.span("outer", i):
            with rec.span("inner", i):
                pass
    kept = rec.log.take()
    assert [(s.name, s.request, s.parent) for s in kept] == [
        ("outer", 3, None), ("inner", 4, "outer"), ("outer", 4, None)]
