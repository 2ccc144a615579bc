"""The spans and counters inside run_experiment's host half (the worker
thread's track+photometry) and the calling thread's wait on it, on the CPU
at 3 fields x 3 cycles of 128^2 in groups of two fields (two groups)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_torch import api
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.config import (DetectConfig,
                                                        PipelineConfig)
from fluorosequencingimageanalysis_torch.pipeline import fast_experiment
from fluorosequencingimageanalysis_torch.pipeline.tracking import (
    accumulate_offsets)
from fluorosequencingimageanalysis_torch.utils import profiling
from fluorosequencingimageanalysis_torch.utils.synth import (
    make_experiment_stack)

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

DET = dict(max_candidates=128, num_iters=10)
FIELDS, CYCLES, GROUP = 3, 3, 2
GROUP_SPANS = ("api/track/spot_lists", "api/track/lookup",
               "api/track/hole_enqueue", "api/track/rows")
FIELD_SPANS = ("api/track/link", "api/track/fill")
WORKER_SPANS = GROUP_SPANS + FIELD_SPANS
WAIT = "api/run_experiment/track_wait"
COUNTERS = ("experiment/traces", "experiment/holes")


@pytest.fixture(autouse=True)
def two_groups(monkeypatch):
    monkeypatch.setattr(api, "GROUP_FIELDS", GROUP)
    profiling.reset_timings()
    profiling.reset_counters()
    yield
    profiling.reset_timings()
    profiling.reset_counters()
    assert not profiling.enabled()


@pytest.fixture(scope="module")
def fields():
    return make_experiment_stack(FIELDS, CYCLES, 128, 128,
                                 spots_per_field=30, seed=7)


def _pipe(profile):
    return Pipeline(PipelineConfig(detect=DetectConfig(**DET)), device="cpu",
                    profile=profile)


def _run(fields, profile=True, **kw):
    return _pipe(profile).run_experiment(
        fields, max_candidates=DET["max_candidates"], **kw)


def test_each_span_once_a_group_or_a_field(fields):
    _run(fields)
    t = profiling.timings()
    for name in GROUP_SPANS:
        assert t[name]["count"] == 2, name
    for name in FIELD_SPANS:
        assert t[name]["count"] == FIELDS, name
    assert t[WAIT]["count"] == 1
    # Nested one after another inside the worker's host half.
    inner = sum(t[name]["total"] for name in WORKER_SPANS)
    assert inner <= t["api/run_experiment/track+photometry"]["total"]
    assert t[WAIT]["total"] <= t["api/run_experiment/groups"]["total"]


def test_traces_counts_every_linked_trace(fields):
    res = _run(fields, keep_invalid=True)
    # keep_invalid: every linked trace emits a row.
    assert profiling.counters()["experiment/traces"] == len(res["rows"]) > 0
    profiling.reset_counters()
    res = _run(fields)
    assert profiling.counters()["experiment/traces"] >= len(res["rows"])


def _holes_by_hand(args, kwargs):
    """The hole positions of one group's valid traces, from
    ``_link_field`` and ``_fill_traces`` on run_experiment_stack's
    arguments."""
    stack, offsets_h, offsets_w, (rhs, rws) = args[:4]
    frame = tuple(stack.shape[2:])
    radius = fast_experiment._photometry_window_radius(
        kwargs["photometry_method"], kwargs["photometry_radius"])
    n = 0
    for f in range(len(rhs)):
        cum = np.asarray(accumulate_offsets(
            [(float(offsets_h[f, c]), float(offsets_w[f, c]))
             for c in range(CYCLES)]), dtype=np.float64)
        pos, present = fast_experiment._link_field(
            rhs[f], rws[f], frame, cum, kwargs["candidate_radius"])
        _, valid, _, _ = fast_experiment._fill_traces(
            pos, present, cum, frame, photometry_radius=radius)
        n += int((~present[valid]).sum())
    return n


def test_holes_counts_the_positions_gathered(fields, monkeypatch):
    calls, nan_before_flush = [], []
    measure = fast_experiment.run_experiment_stack
    flush = fast_experiment.flush_hole_queue

    def watched(*args, **kwargs):
        calls.append((args, kwargs))
        return measure(*args, **kwargs)

    def counted(queue):
        nan_before_flush.append(sum(int(np.isnan(phot).sum())
                                    for _, phot, _, _ in queue))
        return flush(queue)

    monkeypatch.setattr(fast_experiment, "run_experiment_stack", watched)
    monkeypatch.setattr(fast_experiment, "flush_hole_queue", counted)
    _run(fields)
    assert len(calls) == 2
    holes = profiling.counters()["experiment/holes"]
    assert holes == sum(_holes_by_hand(*c) for c in calls) > 0
    assert nan_before_flush == [holes]


def test_nothing_new_while_tracing_is_off(fields):
    _run(fields, profile=False)
    assert not set(WORKER_SPANS + (WAIT,)) & set(profiling.timings())
    assert not set(COUNTERS) & set(profiling.counters())


def test_worker_spans_share_the_callers_profiler_clock(fields):
    """With every thread profiled, the worker's spans are events of the
    profiler under their own thread, inside the caller's groups span."""
    from torch.profiler import ProfilerActivity, profile
    try:
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pytest.skip("this torch's profiler has no profile_all_threads")
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=config) as prof:
        _run(fields)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(
            (e.start_ns(), e.end_ns(), e.start_thread_id()))
    (g0, g1, caller), = events["api/run_experiment/groups"]
    (w0, w1, wait_thread), = events[WAIT]
    assert wait_thread == caller and g0 <= w0 <= w1 <= g1
    for name in WORKER_SPANS:
        want = FIELDS if name in FIELD_SPANS else 2
        assert len(events[name]) == want, name
        for start, end, thread in events[name]:
            assert thread != caller, name
            assert g0 <= start <= end <= g1, name
