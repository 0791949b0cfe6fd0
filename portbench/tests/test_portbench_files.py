"""BENCHMARK.json and the files its cells are found by: each cell's
configuration, traffic and per-layer metric files exist under their
names, and the entries keep to the benchmark's format."""

import json
import os
import re

import pytest

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_their_keys_and_names(bench, section):
    for entry in bench[section]:
        assert set(entry) - {"workloads"} == KEYS[section], entry
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in entry:
                assert 1 <= len(entry[text]) <= 200
                assert "\n" not in entry[text] and "\t" not in entry[text]
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))


def test_each_cell_finds_its_files_by_name(bench):
    for cell in bench["workloads"]:
        assert cell["chips"] == 1
        config = harness.config_file(cell["config"])
        traffic = harness.traffic_file(cell["traffic"])
        assert harness.driver(traffic).run
        assert config["reduced"] == []
        assert any(c["file"] == f"portbench/configs/{cell['config']}.json"
                   for c in bench["configs"])
        for m in harness.metrics_of(bench, cell, trace=True):
            assert callable(harness.metric_reader(m["name"]))


def test_the_families_differ_only_in_their_configuration(bench):
    cells = {c["name"]: c for c in bench["workloads"]}
    heart, lits = cells["heart.serve"], cells["lits.serve"]
    assert heart["traffic"] == lits["traffic"]
    assert (heart["config"], lits["config"]) == ("heart", "lits")


def test_metrics_move_a_reported_end_to_end_metric(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_readers_return_nothing_without_records(bench):
    for m in bench["per_layer"]:
        assert harness.metric_reader(m["name"])({}) is None


def test_configuration_files_hold_what_the_port_runs():
    from portbench.drivers.serve import port_config

    for name in ("heart", "lits"):
        config = harness.config_file(name)
        cfg = port_config(config["serve"], config["model"])
        assert cfg.compute_dtype == "bfloat16"
        assert os.path.exists(os.path.join(ROOT, config["serve"]["weights"]))
