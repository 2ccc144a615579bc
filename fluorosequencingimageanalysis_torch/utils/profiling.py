"""Stage timers, spans, event counters and a CUDA-event device timer.

Counterpart of fluorosequencingimageanalysis_tpu/utils/profiling.py: a
process-wide registry of named host-clock stages (``stage``, ``timings``,
``reset_timings``, ``report``) and of event counts (``bump``,
``counters``, ``reset_counters``), both safe to update from several
threads. ``device_time`` times a computation on the card with CUDA events.

Tracing. One process-wide switch (``enabled``), which every thread sees,
is on while any ``tracing()`` block is open, on any thread.
``Pipeline(profile=True)`` opens one around each of its calls.
``span(name, device=...)`` is a no-op while the switch is off: one check
of a module-level boolean, and the same shared null context every time.
While it is on, a span

- adds its host-clock time to the registry under ``name``, as ``stage``
  does, so that ``timings()[name]["total"]`` reads both;
- runs inside ``torch.profiler.record_function(name)``, so that it shows
  in a ``torch.profiler`` timeline, on the clock of the device activity;
- given a CUDA ``device``, records a pair of timing events on that
  device's current stream at entry and exit. The events stay pending: no
  host read happens on the traced path. ``timings()`` waits for them and
  adds each span's device seconds (end event minus start event, summed)
  as ``device_total``; ``reset_timings()`` drops them.

``stage`` is always on (it does not read the switch), and so are the
counters: ``bump`` takes a lock and never reads the device.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch

_lock = threading.Lock()
_stats: dict = defaultdict(lambda: {"count": 0, "total": 0.0, "max": 0.0})
_counts: dict = defaultdict(int)

_enabled = False     # the switch, read without the lock
_holds = 0           # open ``tracing()`` blocks, on any thread
_pending: list = []  # (name, start event, end event) not yet resolved
_OFF = contextlib.nullcontext()


def _record(name: str, dt: float) -> None:
    with _lock:
        s = _stats[name]
        s["count"] += 1
        s["total"] += dt
        s["max"] = max(s["max"], dt)


@contextlib.contextmanager
def stage(name: str):
    """Time a named stage on the host clock; accumulates into the registry.

    >>> with stage("detect"):
    ...     run_detection()
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record(name, time.perf_counter() - t0)


def enabled() -> bool:
    """Whether tracing is on (``span`` records)."""
    return _enabled


@contextlib.contextmanager
def tracing(on: bool = True):
    """Tracing on for the block where ``on`` (else the switch is left as
    it is). Blocks that overlap, on one thread or several, keep it on until
    the last of them ends."""
    global _enabled, _holds
    if not on:
        yield
        return
    with _lock:
        _holds += 1
        _enabled = True
    try:
        yield
    finally:
        with _lock:
            _holds -= 1
            _enabled = _holds > 0


class _Span:
    """What ``span`` returns while tracing is on."""

    __slots__ = ("name", "device", "scope", "t0", "start")

    def __init__(self, name, device):
        self.name = name
        self.device = device

    def __enter__(self):
        self.scope = torch.profiler.record_function(self.name)
        self.scope.__enter__()
        self.start = None
        if self.device is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            with _lock:
                _pending.append((self.name, self.start, end))
        _record(self.name, dt)
        self.scope.__exit__(*exc)
        return False


def span(name: str, device=None):
    """A traced span named ``name`` (a null context while tracing is off).
    ``device``: where the block's work runs; a CUDA device adds the
    block's device time (module docstring). Host-clock only otherwise."""
    if not _enabled:
        return _OFF
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            device = None
    return _Span(name, device)


def timings() -> dict:
    """Snapshot of {stage: {count, total, max, mean}} (seconds), with
    ``device_total`` for spans that recorded device time. Waits for the
    device events of the spans recorded so far."""
    with _lock:
        # Under the lock, so that a reset cannot interleave; the work the
        # events close is enqueued already, so each wait ends on its own.
        for name, start, end in _pending:
            end.synchronize()
            s = _stats[name]
            s["device_total"] = (s.get("device_total", 0.0) +
                                 start.elapsed_time(end) / 1e3)
        _pending.clear()
        return {name: dict(s, mean=s["total"] / max(s["count"], 1))
                for name, s in _stats.items()}


def reset_timings() -> None:
    with _lock:
        _stats.clear()
        _pending.clear()


def bump(name: str, n: int = 1) -> None:
    """Count an event (an upload, a step, a fetch, bytes moved)."""
    with _lock:
        _counts[name] += n


def counters() -> dict:
    with _lock:
        return dict(_counts)


def reset_counters() -> None:
    with _lock:
        _counts.clear()


def report() -> str:
    """Human-readable stage-timing table (sorted by total, descending);
    ``device_s`` for spans with device time."""
    rows = sorted(timings().items(), key=lambda kv: -kv[1]["total"])
    lines = [f"{'stage':<36} {'count':>7} {'total_s':>10} {'mean_s':>10} "
             f"{'max_s':>10} {'device_s':>10}"]
    for name, s in rows:
        dev = s.get("device_total")
        dev = "" if dev is None else f"{dev:>10.4f}"
        lines.append(f"{name:<36} {s['count']:>7} {s['total']:>10.4f} "
                     f"{s['mean']:>10.4f} {s['max']:>10.4f} {dev}")
    return "\n".join(lines)


def device_time(fn, *args, warmup: int = 1, iters: int = 3, **kwargs):
    """Time ``fn(*args, **kwargs)`` on the current CUDA device with CUDA
    events: ``warmup`` untimed runs, then ``iters`` timed ones, each
    bracketed by a synchronisation. Returns (best_seconds, last output).
    Raises where torch sees no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time needs a CUDA device")
    out = None
    for _ in range(max(warmup, 0)):
        out = fn(*args, **kwargs)
    best = float("inf")
    for _ in range(max(iters, 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best, out
