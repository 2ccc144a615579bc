"""Percentiles of a sample."""

from __future__ import annotations

import math


def percentile(values, q):
    """The ``q``-th percentile (0-100) by linear interpolation between
    the closest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of an empty sample")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
