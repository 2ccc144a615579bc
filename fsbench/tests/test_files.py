"""BENCHMARK.json and the files it names: found by name, well formed."""

from __future__ import annotations

import json
import os
import re

import pytest

from fsbench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = registry.cell(cell)
    assert spec["config"] == entry["config"]
    assert spec["traffic"] == entry["traffic"]
    assert spec["chips"] == entry["chips"] == 1
    assert spec["why"] == entry["why"]
    config = registry.config(spec["config"])
    assert hasattr(registry.generator(spec["generator"]), "generate")
    module = registry.entry(config["entry"])
    for fn in ("Driver", "reference", "compare", "check", "as_sample",
               "read_sample", "kernel_work", "images_per_call"):
        assert hasattr(module, fn), fn


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_files_found_by_name(cfg):
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg)
    spec = registry.config(cfg)
    assert entry["file"] == f"fsbench/configs/{cfg}.json"
    assert os.path.isfile(os.path.join(registry.ROOT, entry["file"]))
    assert spec["name"] == cfg and spec["source"] == entry["source"]
    assert spec["reduced"] == entry["reduced"]
    for key in spec["reduced"]:
        assert key in spec


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_files_agree(metric):
    entry = next(m for m in METRICS if m["name"] == metric)
    reader = registry.metric(metric)
    assert reader.UNIT == entry["unit"]
    assert reader.BETTER == entry["better"]
    assert reader.SOURCE == entry["source"]
    if "layer" in entry:
        assert reader.LAYER == entry["layer"]
        assert reader.MOVES == entry["moves"]
    assert callable(reader.read)


def test_names_units_and_strings():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS +
             [m["name"] for m in METRICS] +
             [w["traffic"] for w in BENCH["workloads"]] +
             [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for kind in (CELLS, [c["name"] for c in BENCH["configs"]],
                 [m["name"] for m in METRICS]):
        assert len(kind) == len(set(kind))
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] +
                 [c["why"] for c in BENCH["configs"]] +
                 [c["source"] for c in BENCH["configs"]] +
                 [m["layer"] for m in BENCH["per_layer"]] +
                 BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and \
            "\t" not in text, text


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        reported = registry.cell_metrics(BENCH, cell, per_layer=False)
        assert "setup_s" in reported and len(reported) >= 2
        assert registry.cell_metrics(BENCH, cell, per_layer=True)


def test_layer_metrics_cells_report_what_they_move():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in CELLS
            assert m["moves"] in registry.cell_metrics(BENCH, cell,
                                                       per_layer=False)
        layers.setdefault(m["layer"], set()).add(m["name"])


def test_paths_hold_only_benchmark_names():
    allowed = re.compile(r"^[A-Za-z0-9_./-]+$")
    for top, _, files in os.walk(registry.HERE):
        if "__pycache__" in top:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(top, f), registry.ROOT)
            assert allowed.match(rel), rel
