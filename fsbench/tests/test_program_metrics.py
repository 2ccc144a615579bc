"""The metrics read from the port's tracing registry
(``fsbench/program_registry.py``), on fabricated runs and registries."""

from __future__ import annotations

import pytest

from fsbench import registry
from fsbench.tests.conftest import tiny

SPANS = {"consolidate_ms": ("api/detect/consolidate", "device_total"),
         "candidates_ms": ("api/detect/candidates", "device_total"),
         "registration_ms": ("api/step/registration", "device_total"),
         "photometry_ms": ("api/step/photometry", "device_total"),
         "background_ms": ("api/zstack/background", "device_total"),
         "fetch_wait_ms": ("api/fetch_wait", "total")}


class Run:
    def __init__(self, n_calls):
        self.calls = [{"images": 1}] * n_calls


@pytest.fixture
def program(monkeypatch):
    """The port's registry, replaced by the dicts the test fills."""
    from fluorosequencingimageanalysis_torch.utils import profiling
    held = {"timings": {}, "counters": {}}
    monkeypatch.setattr(profiling, "timings", lambda: held["timings"])
    monkeypatch.setattr(profiling, "counters", lambda: held["counters"])
    return held


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_metrics(metric, program):
    reader = registry.metric(metric)
    span, key = SPANS[metric]
    assert reader.read(Run(4)) is None
    program["timings"][span] = {"count": 8, "total": 0.5, "max": 0.1}
    if key == "device_total":
        # A span with host time only (the CPU, or no events) reads None.
        assert reader.read(Run(4)) is None
        program["timings"][span]["device_total"] = 0.2
    assert reader.read(Run(4)) == pytest.approx(
        1e3 * program["timings"][span][key] / 4)
    assert reader.read(Run(0)) is None


def test_consolidate_rounds(program):
    reader = registry.metric("consolidate_rounds")
    assert reader.read(Run(4)) is None
    program["counters"]["detect/consolidate_rounds"] = 100
    assert reader.read(Run(4)) == 25
    assert reader.read(Run(0)) is None


def test_candidates_per_image(program):
    reader = registry.metric("candidates_per_image")
    assert reader.read(Run(4)) is None
    program["counters"]["detect/images"] = 0
    assert reader.read(Run(4)) is None
    program["counters"].update({"detect/images": 64,
                                "detect/candidates": 64 * 4096})
    assert reader.read(Run(4)) == 4096


@pytest.mark.parametrize("name", ["zstack.frames32", "seqrun.sparse"])
def test_a_traced_run_reports_the_registry_metrics(name):
    """On the CPU (no device time) a tiny traced run reports the counters
    and the host-clock span, and leaves the device spans out."""
    from fsbench.run import run_cell

    cell, config = tiny(name)
    run, res = run_cell(name, 2**31 + 11, 0.5, 1, device="cpu", cell=cell,
                        config=config)
    assert res["correct"]
    m = res["metrics"]
    assert {"consolidate_rounds", "candidates_per_image",
            "fetch_wait_ms"} <= set(m)
    assert m["consolidate_rounds"]["value"] >= 1
    cap = config["call"]["max_candidates"]
    assert 0 < m["candidates_per_image"]["value"] <= cap
    assert not set(SPANS) - {"fetch_wait_ms"} & set(m)
