"""The movie path's tracing: the spans ``api/timetrace/track``,
``api/stepfit/ck_masks``, ``api/stepfit/postpass`` and
``api/run_timetrace/csv`` and the counters ``timetrace/frames``,
``timetrace/traces`` and ``timetrace/csv_rows`` that ``run_timetrace``
records under ``Pipeline(profile=True)``, and nothing of them without.

On the CPU the spans hold host time only; the test marked ``cuda`` reads
their device time on the card:

    python -m pytest --noconftest tests/test_torch_profiling_timetrace.py -q
"""

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.utils import profiling
from fluorosequencingimageanalysis_torch.utils.synth import make_movie

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

DEVICE_SPANS = ("api/timetrace/track", "api/stepfit/ck_masks")
HOST_SPANS = ("api/stepfit/postpass",)
COUNTERS = ("timetrace/frames", "timetrace/traces", "timetrace/csv_rows")
CALL = dict(max_candidates=None, photometry_min=None, mirror_start=0,
            chung_kennedy=1, p_threshold=0.01)


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset_timings()
    profiling.reset_counters()
    yield
    profiling.reset_timings()
    profiling.reset_counters()
    assert not profiling.enabled()


@pytest.fixture(scope="module")
def movie():
    return make_movie(T=12, H=96, W=96, n_spots=15, seed=6)


def test_run_timetrace_records_its_spans_and_counters(movie, tmp_path):
    pipe = Pipeline(device="cpu", profile=True)
    outs = [pipe.run_timetrace(movie, csv_path=str(tmp_path / "a.csv"),
                               **CALL) for _ in range(2)]
    t = profiling.timings()
    for name in DEVICE_SPANS + HOST_SPANS:
        assert t[name]["count"] == 2, name     # one stepfit dispatch a call
        assert t[name]["total"] > 0
        assert "device_total" not in t[name]   # the CPU has no device time
    c = profiling.counters()
    assert c["timetrace/frames"] == 2 * movie.shape[0]
    n = outs[0]["trace_count"]
    assert n > 0 and c["timetrace/traces"] == 2 * n


def test_the_csv_is_a_span_and_counts_its_rows(movie, tmp_path):
    """``api/run_timetrace/csv`` spans the native writer, and the counter
    ``timetrace/csv_rows`` counts the rows it wrote: N x T a call with a
    CSV, nothing without one, nothing from the class path's writer."""
    from fluorosequencingimageanalysis_torch.pipeline.experiment import (
        TimetraceExperiment)

    pipe = Pipeline(device="cpu", profile=True)
    outs = [pipe.run_timetrace(movie, csv_path=str(tmp_path / "a.csv"),
                               **CALL),
            pipe.run_timetrace(movie, **CALL)]
    t = profiling.timings()
    assert t["api/run_timetrace/csv"]["count"] == 1
    assert t["api/run_timetrace/csv"]["total"] > 0
    n = outs[0]["trace_count"]
    assert n > 0
    assert profiling.counters()["timetrace/csv_rows"] == n * movie.shape[0]
    inter = outs[0]["step_fit_intermediates"]
    with profiling.tracing():
        TimetraceExperiment(
            frames=[None] * movie.shape[0],
            spot_traces=[v["photometries"] for v in inter.values()],
            step_fits=outs[0]["step_fits"], step_fit_intermediates=inter
        ).save_experiment_as_csv(str(tmp_path / "b.csv"),
                                 include_step_fits=True,
                                 include_intermediates=True)
    assert profiling.counters()["timetrace/csv_rows"] == n * movie.shape[0]
    assert (tmp_path / "b.csv").read_bytes() == \
        (tmp_path / "a.csv").read_bytes()


def test_nothing_is_recorded_without_profile(movie, tmp_path):
    Pipeline(device="cpu").run_timetrace(
        movie, csv_path=str(tmp_path / "a.csv"), **CALL)
    assert not set(DEVICE_SPANS + HOST_SPANS) & set(profiling.timings())
    assert not set(COUNTERS) & set(profiling.counters())


def test_spans_are_events_of_the_profiler(movie):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        Pipeline(device="cpu", profile=True).run_timetrace(movie, **CALL)
    names = {e.name for e in prof.events()}
    assert set(DEVICE_SPANS + HOST_SPANS) <= names


def test_stepfit_dispatches_are_spans_each():
    """``stepfit_batched`` opens one device span per dispatch (chunk)."""
    from fluorosequencingimageanalysis_torch.ops.stepfit_batch import (
        stepfit_batched)
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_step_traces)

    traces = make_step_traces(10, 40)
    with profiling.tracing():
        stepfit_batched(traces, chung_kennedy=1, chunk=4, device="cpu",
                        n_threads=1)
    t = profiling.timings()
    assert t["api/stepfit/ck_masks"]["count"] == 3     # 4 + 4 + 2 rows
    assert t["api/stepfit/postpass"]["count"] == 1


@pytest.mark.cuda
def test_device_spans_read_device_time_on_the_card(tmp_path):
    """On the card the two device spans read a positive ``device_total``
    no longer than the call's host wall; the post-pass reads none."""
    import time

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    movie = make_movie(T=40, H=256, W=256, n_spots=200, seed=3)
    pipe = Pipeline(device="cuda", profile=True)
    pipe.run_timetrace(movie, csv_path=str(tmp_path / "w.csv"), **CALL)
    torch.cuda.synchronize()
    profiling.reset_timings()
    profiling.reset_counters()
    t0 = time.perf_counter()
    out = pipe.run_timetrace(movie, csv_path=str(tmp_path / "a.csv"), **CALL)
    wall = time.perf_counter() - t0
    t = profiling.timings()
    for name in DEVICE_SPANS:
        assert 0 < t[name]["device_total"] <= wall, name
    assert "device_total" not in t["api/stepfit/postpass"]
    c = profiling.counters()
    assert c["timetrace/frames"] == 40
    assert c["timetrace/traces"] == out["trace_count"] > 0
    assert np.isfinite(out["photometries"]).all()
