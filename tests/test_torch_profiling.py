"""The port's tracing: the switch, spans with device time, and the
counters at the detection, NMS, registration, background and fetch layers
(``utils/profiling.py`` and the spans placed in ``api.py``,
``parallel/mesh.py``, ``models/detect.py`` and ``ops/consolidate.py``).

CPU only: CUDA events are stood in for by fakes where device time is
tested here; ``tests/test_torch_cuda.py`` reads real ones on the card.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.config import (DetectConfig,
                                                        PipelineConfig)
from fluorosequencingimageanalysis_torch.ops import consolidate as cons
from fluorosequencingimageanalysis_torch.pipeline import fast_experiment
from fluorosequencingimageanalysis_torch.utils import profiling
from fluorosequencingimageanalysis_torch.utils.synth import (
    make_experiment_stack, make_zstack)

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

DET = dict(max_candidates=128, num_iters=10)
BOX = dict(box_size=16, filter_size=3)
ZSTACK_SPANS = ("api/run_zstack", "api/zstack/background",
                "api/detect/candidates", "api/detect/consolidate",
                "api/fetch_wait")
EXPERIMENT_SPANS = ("api/run_stack", "api/step/registration",
                    "api/detect/candidates", "api/detect/consolidate",
                    "api/step/photometry", "api/fetch_wait")
COUNTERS = ("detect/images", "detect/candidates",
            "detect/consolidate_rounds")


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset_timings()
    profiling.reset_counters()
    yield
    profiling.reset_timings()
    profiling.reset_counters()
    assert not profiling.enabled()


def _pipe(profile):
    return Pipeline(PipelineConfig(detect=DetectConfig(**DET)), device="cpu",
                    profile=profile)


@pytest.fixture(scope="module")
def frames():
    return make_zstack(3, 64, 64, n_spots=12, seed=4)


@pytest.fixture(scope="module")
def fields():
    return make_experiment_stack(2, 3, 64, 64, spots_per_field=10, seed=5)


class FakeEvent:
    """Stands in for ``torch.cuda.Event``: each span's pair reads 2 ms."""
    made = 0
    waits = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.stream = None

    def record(self, stream=None):
        self.stream = stream

    def synchronize(self):
        FakeEvent.waits += 1

    def elapsed_time(self, end):
        assert end.stream == self.stream
        return 2.0


@pytest.fixture
def fake_cuda(monkeypatch):
    """Fake CUDA events and streams; returns the streams asked for."""
    FakeEvent.made = FakeEvent.waits = 0
    asked = []

    def current_stream(device=None):
        asked.append(device)
        return ("stream", str(device))

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    return asked


def test_span_while_off_is_the_shared_null_context(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span while tracing is off did work")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.time, "perf_counter", refuse)
    assert not profiling.enabled()
    a = profiling.span("api/a")
    b = profiling.span("api/b", device="cuda")
    assert a is b
    with a, b:
        pass
    monkeypatch.undo()
    assert profiling.timings() == {}


def test_switch_nests_and_spans_threads():
    with profiling.tracing(False):
        assert not profiling.enabled()
    with profiling.tracing():
        with profiling.tracing():
            assert profiling.enabled()
        assert profiling.enabled()
    assert not profiling.enabled()
    # A block on another thread that outlives this thread's block keeps
    # the switch on until it ends.
    opened, release = threading.Event(), threading.Event()
    seen = []

    def other():
        with profiling.tracing():
            opened.set()
            release.wait(30)
            seen.append(profiling.enabled())

    t = threading.Thread(target=other)
    with profiling.tracing():
        t.start()
        assert opened.wait(30)
    assert profiling.enabled()
    release.set()
    t.join(30)
    assert not t.is_alive() and seen == [True]
    assert not profiling.enabled()
    # tracing(False) inside an open block leaves the switch on.
    with profiling.tracing():
        with profiling.tracing(False):
            assert profiling.enabled()
    assert not profiling.enabled()


def test_span_records_host_time_beside_stages():
    with profiling.tracing():
        for _ in range(3):
            with profiling.span("api/x"):
                pass
        with profiling.span("api/x", device="cpu"):
            pass
    with profiling.stage("api/x"):
        pass
    t = profiling.timings()["api/x"]
    assert t["count"] == 5 and t["total"] >= t["max"] >= 0
    assert "device_total" not in t    # the CPU has no device time


def test_device_time_resolves_when_timings_are_read(fake_cuda):
    with profiling.tracing():
        for _ in range(3):
            with profiling.span("api/dev", device="cuda:0"):
                pass
        with profiling.span("api/host"):
            pass
    assert FakeEvent.made == 6 and FakeEvent.waits == 0
    assert fake_cuda == [torch.device("cuda:0")] * 6
    t = profiling.timings()
    assert FakeEvent.waits == 3
    assert t["api/dev"]["device_total"] == pytest.approx(3 * 2e-3)
    assert "device_total" not in t["api/host"]
    # Resolved once: a second read adds nothing.
    assert profiling.timings()["api/dev"]["device_total"] == \
        pytest.approx(6e-3)
    assert FakeEvent.waits == 3
    assert "device_s" in profiling.report()


def test_reset_timings_drops_pending_events(fake_cuda):
    with profiling.tracing():
        with profiling.span("api/dev", device="cuda"):
            pass
    profiling.reset_timings()
    assert profiling.timings() == {}
    assert FakeEvent.waits == 0
    with profiling.tracing():
        with profiling.span("api/dev", device="cuda"):
            pass
    t = profiling.timings()["api/dev"]
    assert t["count"] == 1 and t["device_total"] == pytest.approx(2e-3)


def test_spans_from_threads_land_in_one_registry(fake_cuda):
    n_threads, n_each = 12, 300

    def work():
        for _ in range(n_each):
            with profiling.span("stress/span", device="cuda"):
                profiling.bump("stress/events")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.tracing():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n_each
    t = profiling.timings()["stress/span"]
    assert t["count"] == total
    assert t["device_total"] == pytest.approx(total * 2e-3)
    assert profiling.counters() == {"stress/events": total}


def test_bump_max_waits_for_counters_and_only_while_tracing():
    """A device count (kernel F's per-image rounds) is kept pending, not
    read, and its largest entry added when ``counters()`` is read; while
    tracing is off nothing is kept; ``reset_counters()`` drops what is
    pending."""
    rounds = torch.tensor([3, 7, 5], dtype=torch.int32)
    profiling.bump_max("t/rounds", rounds)
    assert profiling._pending_max == []
    assert profiling.counters() == {}
    with profiling.tracing():
        profiling.bump_max("t/rounds", rounds)
        profiling.bump_max("t/rounds", torch.tensor([2], dtype=torch.int32))
        profiling.bump_max("t/empty", torch.zeros(0, dtype=torch.int32))
        profiling.bump("t/rounds", 1)
        assert len(profiling._pending_max) == 3
    assert profiling.counters() == {"t/rounds": 7 + 2 + 1, "t/empty": 0}
    assert profiling.counters() == {"t/rounds": 10, "t/empty": 0}
    with profiling.tracing():
        profiling.bump_max("t/rounds", rounds)
    profiling.reset_counters()
    assert profiling._pending_max == []
    assert profiling.counters() == {}


def _chains(lengths, n):
    """Images of fits in a chain each: fit i at (10, 10 + 3 i), R^2
    falling along it, so that each rival pair is decided one fixpoint
    round after the last (radius 4: neighbours rival, the next do not)."""
    ch = torch.full((len(lengths), n), 10.0)
    cw = torch.zeros(len(lengths), n)
    r2 = torch.zeros(len(lengths), n)
    valid = torch.zeros(len(lengths), n, dtype=torch.bool)
    for b, k in enumerate(lengths):
        cw[b, :k] = 10.0 + 3.0 * torch.arange(k)
        r2[b, :k] = 0.99 - 0.01 * torch.arange(k)
        valid[b, :k] = True
    return ch, cw, r2, valid


@pytest.mark.parametrize("lengths,one_group,rounds", [
    ([1], True, 1), ([2], True, 2), ([5], True, 5), ([9], True, 9),
    ([0], True, 0),
    ([3, 5], True, 5),     # one group: its rounds are its longest chain's
    ([3, 5], False, 8),    # a group an image: their rounds add
])
def test_consolidate_counts_its_fixpoint_rounds(lengths, one_group, rounds,
                                                monkeypatch):
    n = 9
    if not one_group:
        monkeypatch.setattr(cons, "_MAX_PAIRS", n * n)
    ch, cw, r2, valid = _chains(lengths, n)
    keep = cons.consolidate(ch, cw, r2, valid, radius=4.0)
    assert profiling.counters() == {"detect/consolidate_rounds": rounds}
    for b, k in enumerate(lengths):
        want = [i < k and i % 2 == 0 for i in range(n)]
        assert keep[b].tolist() == want


def test_pipeline_profile_turns_tracing_on_for_its_calls(frames, fields,
                                                         monkeypatch):
    seen = []
    measure = fast_experiment.run_experiment_stack

    def watched(*args, **kwargs):
        seen.append((threading.current_thread() is threading.main_thread(),
                     profiling.enabled()))
        return measure(*args, **kwargs)

    monkeypatch.setattr(fast_experiment, "run_experiment_stack", watched)
    _pipe(True).run_experiment(fields, max_candidates=DET["max_candidates"])
    # The host half runs on the worker thread, and sees the switch on.
    assert seen == [(False, True)]
    assert not profiling.enabled()
    profiling.reset_timings()
    seen.clear()
    _pipe(False).run_experiment(fields, max_candidates=DET["max_candidates"])
    assert seen == [(False, False)]
    _pipe(False).run_zstack(frames, **BOX)
    # Untraced: no span, but the counters are always on.
    assert profiling.timings() == {}
    assert set(COUNTERS) <= set(profiling.counters())


@pytest.mark.parametrize("lean", [False, True])
def test_run_zstack_records_its_spans_and_counters(frames, lean,
                                                   monkeypatch):
    from fluorosequencingimageanalysis_torch import api
    monkeypatch.setattr(api, "GROUP_FRAMES", 2)   # 3 frames: 2 groups
    kw = dict(lean=True, max_spots=32) if lean else {}
    out = _pipe(True).run_zstack(frames, **BOX, **kw)
    t = profiling.timings()
    assert t["api/run_zstack"]["count"] == 1
    for name in ZSTACK_SPANS[1:]:
        assert t[name]["count"] == 2, name
    c = profiling.counters()
    assert c["detect/images"] == 3
    mc = DET["max_candidates"]
    assert c["detect/candidates"] == int(np.minimum(out["cand_count"],
                                                    mc).sum()) > 0
    assert c["detect/consolidate_rounds"] >= 2   # a group needs one at least


def test_run_experiment_records_its_spans_and_counters(fields):
    mc = DET["max_candidates"]
    _pipe(True).run_experiment(fields, max_candidates=mc)
    t = profiling.timings()
    for name in EXPERIMENT_SPANS[1:]:
        assert t[name]["count"] == 1, name   # 2 fields: one group
    c = profiling.counters()
    cand = _pipe(False).run_stack(fields, max_candidates=mc)["cand_count"]
    assert c["detect/images"] == 6
    assert c["detect/candidates"] == int(np.minimum(cand, mc).sum()) > 0
    assert c["detect/consolidate_rounds"] >= 1


def test_spans_are_events_of_the_profiler(frames, fields):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _pipe(True).run_zstack(frames, **BOX)
        _pipe(True).run_experiment(fields,
                                   max_candidates=DET["max_candidates"])
    names = {e.name for e in prof.events()}
    assert set(ZSTACK_SPANS + EXPERIMENT_SPANS) <= names
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _pipe(False).run_zstack(frames, **BOX)
    assert not {e.name for e in prof.events()} & set(ZSTACK_SPANS)
