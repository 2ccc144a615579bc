"""The metrics of the spans and counters inside run_experiment's host half
(``fsbench/program_registry.py``), on fabricated registries and on a tiny
traced run."""

from __future__ import annotations

import pytest

from fsbench import registry
from fsbench.tests.conftest import tiny
from fsbench.tests.test_program_metrics import Run, program  # noqa: F401

SPANS = {"spot_lists_ms": "api/track/spot_lists",
         "link_ms": "api/track/link",
         "fill_ms": "api/track/fill",
         "lookup_ms": "api/track/lookup",
         "hole_enqueue_ms": "api/track/hole_enqueue",
         "track_rows_ms": "api/track/rows",
         "track_wait_ms": "api/run_experiment/track_wait"}
COUNTERS = {"traces_per_call": "experiment/traces",
            "holes_per_call": "experiment/holes"}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_metrics(metric, program):  # noqa: F811
    reader = registry.metric(metric)
    span = SPANS[metric]
    assert reader.read(Run(4)) is None
    program["timings"][span] = {"count": 8, "total": 0.5, "max": 0.1}
    assert reader.read(Run(4)) == pytest.approx(1e3 * 0.5 / 4)
    assert reader.read(Run(0)) is None


@pytest.mark.parametrize("metric", sorted(COUNTERS))
def test_counter_metrics(metric, program):  # noqa: F811
    reader = registry.metric(metric)
    assert reader.read(Run(4)) is None
    program["counters"][COUNTERS[metric]] = 1000
    assert reader.read(Run(4)) == 250
    assert reader.read(Run(0)) is None


def test_the_seqrun_cells_list_every_metric():
    bench = registry.benchmark()
    for name in ("seqrun.dense", "seqrun.sparse"):
        listed = registry.cell_metrics(bench, name, per_layer=True)
        assert set(SPANS) | set(COUNTERS) <= set(listed), name


def test_a_traced_seqrun_reports_the_track_metrics():
    """On the CPU a tiny traced run reports all nine; the worker's six
    spans fit inside track_ms."""
    from fsbench.run import run_cell

    cell, config = tiny("seqrun.dense")
    run, res = run_cell("seqrun.dense", 2**31 + 29, 0.5, 1, device="cpu",
                        cell=cell, config=config)
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(SPANS) | set(COUNTERS) <= set(m)
    inner = sum(m[k] for k in SPANS if k != "track_wait_ms")
    assert inner <= m["track_ms"]
    assert m["track_wait_ms"] > 0
    assert m["traces_per_call"] > 0 and m["holes_per_call"] > 0
