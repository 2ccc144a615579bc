"""Stage timers, event counters and a CUDA-event device timer.

Counterpart of fluorosequencingimageanalysis_tpu/utils/profiling.py: a
process-wide registry of named host-clock stages (``stage``, ``timings``,
``reset_timings``, ``report``) and of event counts (``bump``,
``counters``, ``reset_counters``), both safe to update from several
threads. ``device_time`` times a computation on the card with CUDA events.
The JAX package's profiler-trace wrapper has no counterpart here;
``torch.profiler`` is used directly where a trace is wanted.
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
        dt = time.perf_counter() - t0
        with _lock:
            s = _stats[name]
            s["count"] += 1
            s["total"] += dt
            s["max"] = max(s["max"], dt)


def timings() -> dict:
    """Snapshot of {stage: {count, total, max, mean}} (seconds)."""
    with _lock:
        return {name: dict(s, mean=s["total"] / max(s["count"], 1))
                for name, s in _stats.items()}


def reset_timings() -> None:
    with _lock:
        _stats.clear()


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
    """Human-readable stage-timing table (sorted by total, descending)."""
    rows = sorted(timings().items(), key=lambda kv: -kv[1]["total"])
    lines = [f"{'stage':<36} {'count':>7} {'total_s':>10} {'mean_s':>10} "
             f"{'max_s':>10}"]
    for name, s in rows:
        lines.append(f"{name:<36} {s['count']:>7} {s['total']:>10.4f} "
                     f"{s['mean']:>10.4f} {s['max']:>10.4f}")
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
