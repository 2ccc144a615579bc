"""What the entry drivers share: the port's config from a configuration
file, the program's stage timings, and the comparison helpers."""

from __future__ import annotations

import collections
import contextlib

import numpy as np


def pipeline(config, device, profile):
    """``Pipeline`` of the port with the configuration's settings."""
    from fluorosequencingimageanalysis_torch.api import Pipeline
    from fluorosequencingimageanalysis_torch.config import (
        DetectConfig, PhotometryConfig, PipelineConfig, RegistrationConfig)

    s = config["settings"]
    cfg = PipelineConfig(detect=DetectConfig(**s["detect"]),
                         registration=RegistrationConfig(
                             **s["registration"]),
                         photometry=PhotometryConfig(**s["photometry"]))
    return Pipeline(cfg, device=device, profile=profile)


def stage_totals():
    """{stage: total seconds} of the port's host-clock stages."""
    from fluorosequencingimageanalysis_torch.utils import profiling
    return {k: v["total"] for k, v in profiling.timings().items()}


def reset_stages():
    from fluorosequencingimageanalysis_torch.utils import profiling
    profiling.reset_timings()
    profiling.reset_counters()


STAGE_PREFIX = "api/"


def stages_as_spans():
    """Make each of the port's host-clock stages also a profiler span of
    its name (traced runs only), so that the trace can name what the host
    was doing. Returns a function that undoes it."""
    from torch.profiler import record_function

    from fluorosequencingimageanalysis_torch.utils import profiling

    timed = profiling.stage

    @contextlib.contextmanager
    def stage(name):
        with record_function(name), timed(name):
            yield

    profiling.stage = stage

    def undo():
        profiling.stage = timed
    return undo


def multiset_mismatch(got, want):
    """Items of ``want`` and ``got`` that the other lacks (as multisets),
    over the size of ``want``."""
    a, b = collections.Counter(got), collections.Counter(want)
    return sum(((a - b) + (b - a)).values()) / max(sum(b.values()), 1)


def max_or_zero(values):
    values = np.asarray(values, np.float64)
    if values.size == 0:
        return 0.0
    return float(np.max(values))
