"""BENCHMARK.json against the shape the benchmark's checks expect: keys, names, units, files
found by name, and what each cell reports."""

import json
import os.path as osp
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    with open(osp.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level(manifest):
    assert set(manifest) == TOP_KEYS
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert osp.getsize(osp.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def _one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_unique_and_valid(manifest, kind):
    names = [e["name"] for e in manifest[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        assert _one_line(c["source"]) and _one_line(c["why"])
        assert len(c["reduced"]) <= 16
        with open(osp.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and key in cfg["reduced"]
        assert osp.exists(osp.join(ROOT, "benchmark", "entries",
                                   c["name"] + ".py"))
        assert "sample_missing" in cfg["limits"]
        assert {"flow_epe_px", "flow_epe_median_px"} & set(cfg["limits"])


def test_workloads(manifest):
    pairs = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["traffic"]) and _one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert osp.exists(osp.join(ROOT, "benchmark", "workloads",
                                   w["name"] + ".json"))


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(manifest, kind):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    allowed = {"name", "unit", "better", "bound", "source"} if (
        kind == "end_to_end") else {"name", "unit", "better", "source",
                                    "layer", "moves"}
    for m in manifest[kind]:
        assert set(m) - {"workloads"} == allowed
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert osp.exists(osp.join(ROOT, "benchmark", "metrics",
                                   m["name"] + ".py"))
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert m["moves"] in e2e and _one_line(m["layer"])


def test_a_layer_metric_moves_what_its_cells_report(manifest):
    for m in manifest["per_layer"]:
        for cell in m["workloads"]:
            e2e = harness.cell_metrics(manifest, cell, "end_to_end")
            assert m["moves"] in {e["name"] for e in e2e}, (m["name"], cell)


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        e2e = harness.cell_metrics(manifest, w["name"], "end_to_end")
        layer = harness.cell_metrics(manifest, w["name"], "per_layer")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer


def test_layers_named_in_perf_md(manifest):
    with open(osp.join(ROOT, "PERF.md")) as f:
        text = f.read()
    for m in manifest["per_layer"]:
        assert m["layer"] in text, m["layer"]


def test_run_budget(manifest):
    """A full check of 24 cells at this run length fits 43200 s."""
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
