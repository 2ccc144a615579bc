"""What the port's own tracing registry (``utils/profiling.py``) holds
after a traced window, for the metric readers.

A traced run resets the registry's timings and counters at the window's
start, and the port has run nothing since the window closed (the check
runs the reference, which does not import the port), so the registry
holds the window's spans and counts. A port without the span or counter
asked for, as an older commit of the program is, reads None.
"""

from __future__ import annotations


def _profiling():
    from fluorosequencingimageanalysis_torch.utils import profiling
    return profiling


def span_ms_per_call(run, name, key="device_total"):
    """``key`` of span ``name`` (``device_total``: its device seconds;
    ``total``: its host seconds), in ms per call of the window; None where
    the registry has no such span or key."""
    if not run.calls:
        return None
    seconds = _profiling().timings().get(name, {}).get(key)
    if seconds is None:
        return None
    return 1e3 * seconds / len(run.calls)


def counter(name):
    """Counter ``name`` over the window, or None where it was never
    bumped."""
    return _profiling().counters().get(name)


def counter_per_call(run, name):
    n = counter(name)
    if n is None or not run.calls:
        return None
    return n / len(run.calls)
