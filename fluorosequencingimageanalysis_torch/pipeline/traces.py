"""Trace hierarchy: sequences of a Spot through frames.

A copy of fluorosequencingimageanalysis_tpu/pipeline/traces.py (numpy and
the host step-fit chain only), held equal to it by
tests/test_torch_import.py. Parity: flexlibrary.py:1320-1662 (Trace,
SimpleTrace, PhotometryTrace, PlateauTrace). The step-fit chain
(mirror -> Chung-Kennedy -> sliding-t -> refit -> t-test merge) matches
Trace.stepfit_photometries (flexlibrary.py:1380-1469).
"""

from __future__ import annotations

import numpy as np

from .. import stepfitting


class Trace:
    """Base class; subclasses define .trace, .h, .w, .num_frames,
    .photometry(frame)."""

    def photometry(self, **kwargs):
        raise AttributeError("Every Trace subclass must implement its own "
                             "photometry() method")

    def photometries(self, photometry_min=None,
                     photometry_method="mexican_hat", **kwargs):
        out = [spot.photometry(method=photometry_method, **kwargs)
               if spot is not None else 0
               for spot in self.trace]
        if photometry_min is not None:
            out = [max(photometry_min, rp) for rp in out]
        return tuple(out)

    def stepfit_photometries(self, h, w, mirror_start=0, chung_kennedy=0,
                             p_threshold=0.01, photometry_min=None,
                             photometry_method="mexican_hat", **kwargs):
        photometries = self.photometries(photometry_min=photometry_min,
                                         photometry_method=photometry_method,
                                         **kwargs)
        mirrored = stepfitting.mirror_photometries(photometries,
                                                   mirror_size=mirror_start)
        ck = mirrored
        for _ in range(chung_kennedy):
            # Parity: the reference re-filters the *mirrored* input each
            # round (flexlibrary.py:1432-1436), so repetition does not
            # compound; we reproduce that.
            ck = stepfitting.chung_kennedy_filter(
                luminosities=mirrored, window_lengths=(2, 4, 8, 16))
        plateaus = stepfitting.sliding_t_fitter(
            luminosity_sequence=ck, window_radius=6, p_threshold=p_threshold,
            median_filter_size=None, downsteps_only=False,
            min_step_magnitude=None)
        plateaus = stepfitting.refit_plateaus(mirrored, plateaus)
        t_filtered = stepfitting.t_test_filter(
            luminosities=mirrored, plateaus=plateaus,
            p_threshold=p_threshold, drop_sort=True,
            no_merge_start=mirror_start)
        un_ck = stepfitting.unmirror_photometries(ck, mirror_size=mirror_start)
        un_plateaus = stepfitting.unmirror_plateaus(plateaus,
                                                    mirror_size=mirror_start)
        un_t = stepfitting.unmirror_plateaus(t_filtered,
                                             mirror_size=mirror_start)
        return (PhotometryTrace(photometries, h, w),
                PhotometryTrace(un_ck, h, w),
                PlateauTrace(un_plateaus, h, w),
                PlateauTrace(un_t, h, w))

    def frame_output(self, frame, **kwargs):
        return self.photometry(frame, **kwargs)

    @staticmethod
    def trace_comparison_rss(trace_A, trace_B, photometry_method="mexican_hat",
                             **kwargs):
        if trace_A.num_frames != trace_B.num_frames:
            raise Exception("trace_A and trace_B must cover an identical "
                            "number of frames for comparison to be valid.")
        return sum(
            (trace_A.photometry(frame=f, photometry_method=photometry_method,
                                **kwargs) -
             trace_B.photometry(frame=f, photometry_method=photometry_method,
                                **kwargs)) ** 2
            for f in range(trace_A.num_frames))

    def total_sum_squares(self, photometry_method="mexican_hat", **kwargs):
        photometries = self.photometries(photometry_min=None,
                                         photometry_method=photometry_method,
                                         **kwargs)
        m = float(np.mean(photometries))
        return sum((p - m) ** 2 for p in photometries)

    @staticmethod
    def coefficient_of_determination(trace_A, trace_B,
                                     photometry_method="mexican_hat",
                                     **kwargs):
        rss = float(Trace.trace_comparison_rss(
            trace_A, trace_B, photometry_method=photometry_method, **kwargs))
        tss = float(trace_A.total_sum_squares(
            photometry_method=photometry_method, **kwargs))
        return 1.0 - rss / tss


class SimpleTrace(Trace):
    """A trace as a list of Spot-or-None."""

    def _trace_hw(self):
        for spot in self.trace:
            if spot is not None:
                return spot.h, spot.w
        raise Exception("flexlibrary.Trace.trace_hw: this Trace is "
                        "composed entirely of None's.")

    def __init__(self, trace):
        self.trace = trace
        self.h, self.w = self._trace_hw()
        self.num_frames = len(trace)

    def photometry(self, frame, photometry_method="mexican_hat", **kwargs):
        spot = self.trace[frame]
        if spot is None:
            return 0
        return spot.photometry(method=photometry_method, **kwargs)

    def coordinates(self, frame):
        if self.trace[frame] is not None:
            return self.trace[frame].h, self.trace[frame].w
        return None, None

    def plateau_starts(self):
        return set(range(self.num_frames))


class PhotometryTrace(Trace):
    """A trace of bare photometry values."""

    def __init__(self, trace, h, w):
        self.trace = trace
        self.h, self.w = h, w
        self.num_frames = len(trace)

    def photometry(self, frame, **kwargs):
        return self.trace[frame]

    def photometries(self, photometry_min=None, **kwargs):
        # The base implementation assumes Spot entries; here the trace IS
        # the photometry sequence (the reference never exercises this
        # combination — its base method would crash on floats).
        if photometry_min is not None:
            return tuple(max(photometry_min, v) for v in self.trace)
        return tuple(self.trace)

    def plateau_starts(self):
        return set(range(self.num_frames))


class PlateauTrace(Trace):
    """A trace represented as fitted plateaus."""

    def __init__(self, trace, h, w):
        self.trace = trace
        self.h, self.w = h, w
        self.num_frames = trace[-1][1] + 1 if len(trace) > 0 else 0

    def photometry(self, frame, **kwargs):
        return stepfitting.plateau_value(self.trace, frame)

    def last_step_info(self, frame):
        return stepfitting.last_step_info(self.trace, frame)

    def frame_plateau(self, frame):
        return stepfitting.frame_plateau(self.trace, frame)

    def plateau_starts(self):
        return stepfitting.plateau_starts(self.trace)
