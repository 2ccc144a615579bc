"""The device trace of a traced run: torch.profiler over the window.

``DeviceTrace`` records CPU and CUDA activity; ``summary`` reduces it to
the device's busy time inside the window (the union of every device
operation's interval: kernels, copies, memsets; the device-side ranges of
host annotations are not operations and are left out), the device time of
each operation by name, the ten that took most, and the ten longest idle
gaps, each named by the innermost named host span (the benchmark's call
span or a program stage) running at its middle and, below it, the
innermost host operation.
"""

from __future__ import annotations

import bisect
import collections

import numpy as np


def _span_ns(event):
    """(start, end) of a kineto event in ns."""
    if hasattr(event, "start_ns"):
        return event.start_ns(), event.end_ns()
    start = event.start_us() * 1000
    return start, start + event.duration_us() * 1000


class DeviceTrace:
    """Context manager around the traced window; ``span(name)`` marks host
    spans (``record_function``) that name the idle gaps."""

    def __init__(self, window_name):
        self.window_name = window_name
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def events(self):
        return self.prof.profiler.kineto_results.events()

    @staticmethod
    def span(name):
        from torch.profiler import record_function
        return record_function(name)

    def summary(self, host_spans=(), top=10, name_chars=160):
        """``host_spans``: prefixes of the host spans that name idle
        gaps."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        named_spans = tuple(host_spans)
        skip = named_spans + (self.window_name,)
        dev, cpu = [], []
        window = None
        for e in self.events():
            start, end = _span_ns(e)
            if e.device_type() == cuda:
                if not (e.is_user_annotation() or
                        e.name().startswith(skip)):
                    dev.append((start, end, e.name()[:name_chars]))
            else:
                if e.name() == self.window_name:
                    window = (start, end)
                cpu.append((start, end, e.name()))
        if window is None or not dev:
            return None
        w0, w1 = window
        spans = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev
                       if b > w0 and a < w1)
        by_name = collections.Counter()
        for a, b, n in spans:
            by_name[n] += (b - a) * 1e-9
        busy, merged = 0, []
        for a, b, _ in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged)
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        cpu = [c for c in cpu if c[2] != self.window_name]
        cpu.sort()
        starts = [c[0] for c in cpu]
        ends = np.array([c[1] for c in cpu], np.int64)
        named = []
        for length, a, b in gaps:
            mid = (a + b) // 2
            k = bisect.bisect_right(starts, mid)
            covering = sorted(np.nonzero(ends[:k] > mid)[0],
                              key=lambda i: starts[i])
            span = [cpu[i][2] for i in covering
                    if cpu[i][2].startswith(named_spans)]
            name = span[-1] if span else "between calls"
            if covering and cpu[covering[-1]][2] != name:
                name += " > " + cpu[covering[-1]][2]
            named.append([name[:name_chars], length * 1e-9])
        return {"busy_s": busy * 1e-9, "window_s": (w1 - w0) * 1e-9,
                "kernels": dict(by_name),
                "device_ops": [[n, s] for n, s in by_name.most_common(top)],
                "idle_gaps": named}
