"""The port's movie front door against the benchmark's plain reference
(``fsbench/reference/``: ``lctrack``, ``stepfit``, ``timetrace_csv`` and
the detection modules), on the CPU.

Seeded random movies (``utils/synth.py::make_movie``, 24 frames of
128x128, 30 bleaching spots) go through ``Pipeline.run_timetrace`` with
the benchmark configuration's settings (uncapped detection, no photometry
floor, the Chung-Kennedy filter, p 0.01) and through the reference.
Stated tolerances: start keys, tracked positions and presence equal;
photometries within float32 rounding (rtol of float32's epsilon: both
sides sum integer-valued float32 windows, so they agree exactly in
practice); CK traces, plateau and t-filtered plateau starts, stops and
heights equal; the CSV equal line for line. One case mirrors the first
ten frames (``mirror_start=10``).
"""

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.config import (DetectConfig,
                                                        PipelineConfig)
from fluorosequencingimageanalysis_torch.utils.synth import make_movie
from fsbench import registry
from fsbench.reference import lctrack, stepfit, timetrace_csv

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

CONFIG = registry.config("timetrace")
CALL = CONFIG["call"]


def _port(movie, mirror_start, csv_path):
    det = DetectConfig(**CONFIG["settings"]["detect"])
    pipe = Pipeline(PipelineConfig(detect=det), device="cpu")
    kw = dict(CALL, mirror_start=mirror_start)
    return pipe.run_timetrace(movie, csv_path=str(csv_path), **kw)


def _reference(movie, mirror_start):
    entry = registry.entry(CONFIG["entry"])
    x = torch.from_numpy(movie.astype(np.float32))
    h0, w0 = entry.frame0_starts(x[0], CONFIG, lambda t: t)
    rec_h, rec_w, present = lctrack.track(
        x, h0, w0, search_radius=CALL["search_radius"],
        s_n_cutoff=CALL["s_n_cutoff"])
    phot = CONFIG["settings"]["photometry"]
    phots = lctrack.photometries(x, rec_h, rec_w, present,
                                 radius=phot["radius"],
                                 brim_size=phot["brim_size"])
    fits = stepfit.stepfit_chain(
        phots, mirror_start=mirror_start,
        chung_kennedy=CALL["chung_kennedy"], p_threshold=CALL["p_threshold"])
    csv = timetrace_csv.csv_text(h0, w0, fits, movie.shape[0])
    return h0, w0, rec_h, rec_w, present, phots, fits, csv


@pytest.mark.parametrize("seed,mirror_start", [(0, 0), (1, 0), (2, 0),
                                               (3, 10)])
def test_run_timetrace_equals_the_plain_reference(seed, mirror_start,
                                                  tmp_path):
    movie = make_movie(T=24, H=128, W=128, n_spots=30, seed=seed)
    out = _port(movie, mirror_start, tmp_path / "tt.csv")
    h0, w0, rec_h, rec_w, present, phots, fits, csv = _reference(
        movie, mirror_start)
    tr = out["traces"]
    assert len(h0) > 10
    np.testing.assert_array_equal(np.asarray(tr["h"]), h0)
    np.testing.assert_array_equal(np.asarray(tr["w"]), w0)
    np.testing.assert_array_equal(tr["rec_h"], rec_h)
    np.testing.assert_array_equal(tr["rec_w"], rec_w)
    np.testing.assert_array_equal(tr["present"], present)
    np.testing.assert_allclose(out["photometries"], phots,
                               rtol=np.finfo(np.float32).eps, atol=0)
    steps = 0
    for hw, (ph, ck, plateaus, t_filtered) in zip(zip(tr["h"], tr["w"]),
                                                  fits):
        inter = out["step_fit_intermediates"][hw]
        assert list(inter["photometries"].trace) == list(ph)
        assert [float(v) for v in inter["ck_filtered_photometries"].trace] \
            == [float(v) for v in ck]
        assert list(inter["plateaus"].trace) == plateaus
        assert list(out["step_fits"][hw].trace) == t_filtered
        steps += len(t_filtered) - 1
    assert steps > 0                   # the movie bleaches: steps are found
    with open(tmp_path / "tt.csv", newline="") as fh:
        lines = fh.read().splitlines()
    assert lines == csv.splitlines()
    assert len(lines) == 1 + len(h0) * movie.shape[0]
