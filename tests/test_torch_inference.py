"""The port's fluor counting against the JAX package's, on the CPU.

The same photometries dicts and track CSVs (numpy seeds) go through
``fluorosequencingimageanalysis_tpu.inference`` / ``api.Pipeline`` and the
port's. Stated tolerances: signals dicts, totals, ``none_count`` and every
field of ``all_fit_info`` equal, types included, except ``best_score``
(``exp`` of a float32 log-score that agrees within rtol 1e-6 + atol 2e-6,
see test_torch_lognormal.py): rtol 2e-5. The calibration of
``fluor_counts_calibrated`` is float64 host code on equal winners: equal.
The native CSV parser against the Python reader: equal.
"""

import csv
import math
import os

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_tpu import api as jax_api
from fluorosequencingimageanalysis_tpu import config as jax_config
from fluorosequencingimageanalysis_tpu.inference import lognormal as jax_il
from fluorosequencingimageanalysis_tpu.inference import (
    photometries as jax_ph)

import fluorosequencingimageanalysis_torch as port
from fluorosequencingimageanalysis_torch import _build, inference
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.config import (LognormalConfig,
                                                        PipelineConfig)
from fluorosequencingimageanalysis_torch.inference import lognormal as il
from fluorosequencingimageanalysis_torch.inference import photometries as ph
from fluorosequencingimageanalysis_torch.native import trackcsv as tc
from fluorosequencingimageanalysis_torch.ops.fused_lognormal import (
    v8_score_fused)
from fluorosequencingimageanalysis_torch.utils import profiling

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

PORT_DIR = os.path.dirname(os.path.abspath(port.__file__))
REPO = os.path.dirname(PORT_DIR)
BETA, BETA_SIGMA = 30000.0, 0.2
QF = (0.0,) * 7


def _assert_same_fit(got, want):
    """(signals, total, none_count, all_fit_info) of the two packages."""
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert len(got[3]) == len(want[3])
    for g, w in zip(got[3], want[3]):
        assert len(g) == len(w) == 14
        for k, (a, b) in enumerate(zip(g, w)):
            if k == 11 and b != -1:  # best_score
                assert type(a) is type(b) is float
                np.testing.assert_allclose(a, b, rtol=2e-5)
            else:
                assert a == b and type(a) is type(b), (k, a, b)
        # intensities carry the reader's types: ints, or floats once an
        # alpha adjustment was taken.
        assert [type(x) for x in g[6]] == [type(x) for x in w[6]]


def _ladder_rows(rng, n, n_frames=5, channels=("ch1",), noise=200.0):
    rows = []
    for t in range(n):
        n0 = int(rng.integers(1, 4))
        counts = [n0]
        for _ in range(n_frames - 1):
            counts.append(max(counts[-1] - int(rng.random() < 0.4), 0))
        ints = [int(rng.lognormal(math.log(BETA * v), BETA_SIGMA)) if v
                else int(rng.normal(0, noise)) for v in counts]
        cat = tuple(v > 0 for v in counts)
        rows.append([channels[t % len(channels)], t % 3, 10 + t, 20 + 2 * t,
                     "(" + ", ".join(str(c) for c in cat) + ")"] + ints)
    return rows


def _write_tracks_csv(path, rows, nf):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                   [f"FRAME {i}" for i in range(nf)])
        for r in rows:
            w.writerow(r)


@pytest.fixture
def tracks_csv(tmp_path):
    path = str(tmp_path / "tracks.csv")
    rows = _ladder_rows(np.random.default_rng(0), 120)
    rows[7][5] = 0            # a zero intensity in an ON frame
    rows[9][4] = "(False, True, True, False, False)"  # contradicts all
    _write_tracks_csv(path, rows, 5)
    return path


def test_inference_package_reexports_the_jax_packages_names():
    from fluorosequencingimageanalysis_tpu import inference as jax_inference
    assert inference.__all__ == jax_inference.__all__
    for name in inference.__all__:
        assert getattr(inference, name) is not None
    assert not any("gmm" in n or "legacy" in n for n in inference.__all__)


def test_photometries_fit_matches_the_jax_package(tracks_csv):
    photometries, _ = ph.read_track_photometries_csv(tracks_csv)
    assert photometries == jax_ph.read_track_photometries_csv(tracks_csv)[0]
    for kw in (dict(), dict(allow_multidrop=False),
               dict(max_possible=3, quench_factors=(0.0, 0.1, 0.1, 0.1, 0.1)),
               dict(max_deviation=2)):
        kw.setdefault("quench_factors", QF)
        got = il.photometries_lognormal_fit_v8(photometries, BETA,
                                               BETA_SIGMA, device="cpu", **kw)
        want = jax_il.photometries_lognormal_fit_v8(photometries, BETA,
                                                    BETA_SIGMA, **kw)
        _assert_same_fit(got, want)
        assert 0 < got[2] < 30 and got[1] == 120
    adjusted = ph.alpha_adjust_photometries(photometries, 150.5)
    assert adjusted == jax_ph.alpha_adjust_photometries(photometries, 150.5)
    _assert_same_fit(
        il.photometries_lognormal_fit_v8(adjusted, BETA, BETA_SIGMA,
                                         quench_factors=QF, device="cpu"),
        jax_il.photometries_lognormal_fit_v8(adjusted, BETA, BETA_SIGMA,
                                             quench_factors=QF))
    assert il.photometries_lognormal_fit_v8(
        {"ch1": {}}, BETA, BETA_SIGMA, quench_factors=QF,
        device="cpu") == ({}, 0, 0, [])
    with pytest.raises(ValueError, match="quench_factors required"):
        il.photometries_lognormal_fit_v8(photometries, BETA, BETA_SIGMA,
                                         device="cpu")
    with pytest.raises(NotImplementedError, match="multiple channels"):
        il.photometries_lognormal_fit_v8({"a": {}, "b": {}}, BETA,
                                         BETA_SIGMA, quench_factors=QF)


@pytest.mark.parametrize("kw", [
    dict(), dict(alpha_adjust=120.0), dict(downstep_filtered=True),
    dict(head_truncate=1, tail_truncate=1), dict(channels=["ch1"]),
    dict(allow_multidrop=False, max_deviation=2)],
    ids=["plain", "alpha", "downstep", "truncate", "channel", "options"])
def test_fit_from_csv_matches_the_jax_package(tracks_csv, kw):
    got = il.lognormal_fit_v8_from_csv(tracks_csv, BETA, BETA_SIGMA,
                                       quench_factors=QF, device="cpu", **kw)
    want = jax_il.lognormal_fit_v8_from_csv(tracks_csv, BETA, BETA_SIGMA,
                                            quench_factors=QF, **kw)
    _assert_same_fit(got, want)
    assert got[1] > 50
    want_type = float if kw.get("alpha_adjust") else int
    assert all(type(x) is want_type for info in got[3] for x in info[6])


def test_lognormal_fit_v8_from_csv(tracks_csv):
    """The dict-free CSV->v8 path must match the dict path's output."""
    a = il.lognormal_fit_v8_from_csv(tracks_csv, BETA, BETA_SIGMA,
                                     quench_factors=QF, device="cpu")
    photometries, _ = ph.read_track_photometries_csv(tracks_csv)
    b = il.photometries_lognormal_fit_v8(photometries, BETA, BETA_SIGMA,
                                         quench_factors=QF, device="cpu")
    assert a[1] == b[1] == 120 and a[2] == b[2] and a[0] == b[0]
    # values and the reader's int types; the dict path orders by field
    assert sorted(a[3]) == sorted(b[3])
    with pytest.raises(ValueError, match="quench_factors required"):
        il.lognormal_fit_v8_from_csv(tracks_csv, BETA, BETA_SIGMA,
                                     device="cpu")


def test_v8_csv_native_multichannel_matches_dict_restriction(tmp_path):
    path = str(tmp_path / "multi.csv")
    cat = "(True, True, False, False)"
    _write_tracks_csv(path, [
        ["ch1", 0, 10, 20, cat, 30000, 29000, 300, 310],
        ["ch2", 0, 11, 21, cat, 30000, 29000, 300, 310]], 4)
    with pytest.raises(NotImplementedError, match="multiple"):
        il.lognormal_fit_v8_from_csv(path, BETA, BETA_SIGMA,
                                     quench_factors=QF, device="cpu")
    one = il.lognormal_fit_v8_from_csv(path, BETA, BETA_SIGMA,
                                       quench_factors=QF, channels=["ch2"],
                                       device="cpu")
    assert one[1] == 1 and one[3][0][0] == "ch2"


def test_v8_csv_native_dedupes_first_wins_like_dict(tmp_path):
    path = str(tmp_path / "dup.csv")
    cat = "(True, True, False, False)"
    _write_tracks_csv(path, [
        ["ch1", 0, 10, 20, cat, 31000, 30000, 300, 310],
        ["ch1", 0, 10, 20, cat, 62000, 61000, 600, 620],  # duplicate key
        ["ch1", 0, 15, 25, cat, 29500, 30500, 280, 305]], 4)
    native = il.lognormal_fit_v8_from_csv(path, BETA, BETA_SIGMA,
                                          quench_factors=QF, device="cpu")
    pdict, _ = ph.read_track_photometries_csv(path)
    viadict = il.photometries_lognormal_fit_v8(pdict, BETA, BETA_SIGMA,
                                               quench_factors=QF,
                                               device="cpu")
    assert native[1] == viadict[1] == 2  # duplicate dropped on both paths
    assert native[0] == viadict[0]
    assert sorted(native[3]) == sorted(viadict[3])
    assert native[3][0][6] == (31000, 30000, 300, 310)  # the first won


def test_v8_csv_malformed_cell_raises(tmp_path):
    """A corrupted numeric cell is loud on both ingestion paths: the strict
    native parser refuses the file and the Python reader raises."""
    path = str(tmp_path / "bad.csv")
    cat = "(True, True, False, False)"
    _write_tracks_csv(path, [
        ["ch1", 0, 10, 20, cat, "12a45", 30000, 300, 310]], 4)
    assert tc.read_track_photometries_arrays(path) is None
    with pytest.raises(ValueError):
        il.lognormal_fit_v8_from_csv(path, BETA, BETA_SIGMA,
                                     quench_factors=QF, device="cpu")


def _write_mixed_track_csv(path, n_rows=200, n_frames=8, seed=0):
    import random
    rng = random.Random(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                   [f"FRAME {i}" for i in range(n_frames)])
        for i in range(n_rows):
            cat = tuple(rng.random() < 0.5 for _ in range(n_frames))
            # .5-valued intensities exercise the Py2 rounding semantics
            w.writerow([f"ch{i % 3}", i % 5, (i * 13) % 512, (i * 29) % 512,
                        "(" + ", ".join(str(c) for c in cat) + ")"] +
                       [round(rng.uniform(0, 60000), 1)
                        for _ in range(n_frames)])
        w.writerow(["ch0", 1, "None", "None",
                    "(" + ", ".join(["True"] * n_frames) + ")"] +
                   [0] * n_frames)


def test_trackcsv_native_equals_python(tmp_path):
    path = str(tmp_path / "tracks.csv")
    _write_mixed_track_csv(path)
    for kwargs in ({}, {"head_truncate": 2}, {"tail_truncate": 3},
                   {"downstep_filtered": True}, {"channels": ["ch1"]}):
        dn = ph.read_track_photometries_csv(path, use_native=True, **kwargs)
        dp = ph.read_track_photometries_csv(path, use_native=False, **kwargs)
        assert dn == dp, kwargs
        assert dn == jax_ph.read_track_photometries_csv(path, **kwargs)
    assert len(dn[1]) > 50


def test_trackcsv_arrays_api(tmp_path):
    path = str(tmp_path / "tracks.csv")
    _write_mixed_track_csv(path, n_rows=50, n_frames=6)
    arrs = tc.read_track_photometries_arrays(path)
    d, d2 = ph.read_track_photometries_csv(path, use_native=False)
    assert arrs["intensities"].shape == (50, 6)
    assert arrs["intensities"].dtype == np.int64
    assert arrs["categories"].dtype == bool
    for i in range(50):
        channel, field, h, w, cat, frames = d2[int(arrs["rows"][i])]
        assert channel == arrs["channels"][i]
        assert (field, h, w) == (int(arrs["fields"][i]),
                                 int(arrs["hs"][i]), int(arrs["ws"][i]))
        assert cat == tuple(arrs["categories"][i].tolist())
        assert frames == tuple(arrs["intensities"][i].tolist())
    empty = tmp_path / "empty.csv"
    empty.write_text("CHANNEL,FIELD,H,W,CATEGORY,FRAME 0\n")
    assert tc.read_track_photometries_arrays(str(empty))["channels"] == []
    assert ph.read_track_photometries_csv(str(empty)) == ({}, {})


def test_trackcsv_edge_cases_abort_to_python(tmp_path):
    """Inputs the native parser cannot reproduce make it refuse the file
    (None, and the Python reader takes over), never diverge or crash."""
    header = "CHANNEL,FIELD,H,W,CATEGORY,FRAME 0,FRAME 1\n"
    row = 'ch1,0,10,20,"(True, False)",100,50\n'

    p = tmp_path / "blank.csv"  # a blank interior line
    p.write_text(header + row + "\n" + row)
    assert tc.parse_track_csv_native(str(p)) is None
    with pytest.raises(Exception):
        ph.read_track_photometries_csv(str(p))

    p = tmp_path / "hex.csv"  # float() rejects hex floats; so must strtod
    p.write_text(header + row.replace("ch1,0", "ch1,0x10"))
    assert tc.parse_track_csv_native(str(p)) is None
    with pytest.raises(ValueError):
        ph.read_track_photometries_csv(str(p))

    p = tmp_path / "zerof.csv"  # no frame columns: valid for the reader
    p.write_text("CHANNEL,FIELD,H,W,CATEGORY\nch1,0,10,20,()\n")
    assert tc.parse_track_csv_native(str(p)) is None
    d, d2 = ph.read_track_photometries_csv(str(p), use_native=True)
    assert len(d2) == 1  # the Python reader kept the row

    p = tmp_path / "ragged.csv"  # ragged frame counts
    p.write_text(header + row + 'ch1,0,11,20,"(True, False)",100\n')
    assert tc.parse_track_csv_native(str(p)) is None
    assert tc.read_track_photometries_arrays(str(p)) is None

    p = tmp_path / "trunc.csv"  # head_truncate eats every frame column
    p.write_text(header + row + row.replace(",10,", ",11,"))
    dn = ph.read_track_photometries_csv(str(p), use_native=True,
                                        head_truncate=5)
    dp = ph.read_track_photometries_csv(str(p), use_native=False,
                                        head_truncate=5)
    assert dn == dp
    arrs = tc.read_track_photometries_arrays(str(p), head_truncate=5)
    assert arrs is not None and arrs["intensities"].shape == (2, 0)
    assert tc.parse_track_csv_native(str(p), downstep_filtered=True,
                                     head_truncate=5) is None
    with pytest.raises(IndexError):
        ph.read_track_photometries_csv(str(p), use_native=False,
                                       downstep_filtered=True,
                                       head_truncate=5)


def test_trackcsv_source_is_the_jax_packages_and_a_failed_build_raises(
        tmp_path, monkeypatch):
    with open(os.path.join(PORT_DIR, "csrc", "trackcsv.cpp"), "rb") as f:
        port_src = f.read()
    with open(os.path.join(REPO, "fluorosequencingimageanalysis_tpu",
                           "native", "trackcsv.cpp"), "rb") as f:
        assert port_src == f.read()
    assert _build.flags("trackcsv") == _build.HOST_FLAGS

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "trackcsv.cpp").write_bytes(port_src)
    gxx = tmp_path / "g++"
    gxx.write_text('#!/bin/sh\necho "error: expected unqualified-id" >&2\n'
                   "exit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    path = str(tmp_path / "t.csv")
    _write_tracks_csv(path, [["ch1", 0, 1, 2, "(True, False)", 100, 5]], 2)
    match = "g\\+\\+ failed to build trackcsv.cpp(.|\\n)*unqualified-id"
    with pytest.raises(RuntimeError, match=match):
        ph.read_track_photometries_csv(path)
    with pytest.raises(RuntimeError, match=match):
        il.lognormal_fit_v8_from_csv(path, BETA, BETA_SIGMA,
                                     quench_factors=QF, device="cpu")
    # The Python reader, asked for by name, needs no build.
    assert len(ph.read_track_photometries_csv(path, use_native=False)[1]) == 1
    assert os.listdir(tmp_path / "_build") == []


def test_photometry_helpers_match_the_jax_package(tracks_csv, tmp_path):
    photometries, _ = ph.read_track_photometries_csv(tracks_csv)
    assert list(ph.unwind_photometries(photometries)) == \
        list(jax_ph.unwind_photometries(photometries))
    out_a, out_b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    assert ph.write_photometries_dict_to_csv(photometries, out_a) == \
        jax_ph.write_photometries_dict_to_csv(photometries, out_b) == 120
    with open(out_a) as a, open(out_b) as b:
        assert a.read() == b.read()
    back = ph.read_track_photometries_csv(out_a)[0]  # rows renumbered
    assert [r[:6] for r in ph.unwind_photometries(back)] == \
        [r[:6] for r in ph.unwind_photometries(photometries)]
    for method in (1, 2, 3, 4):
        got = ph.remainder_correct(photometries, 5, method=method,
                                   minimum_r_per_field=2)
        want = jax_ph.remainder_correct(photometries, 5, method=method,
                                        minimum_r_per_field=2)
        assert got == want
    with pytest.raises(ValueError, match="Unknown method"):
        ph.remainder_correct(photometries, 5, method=5)
    trace = [100, 102, 99, 50, 52, 49, 10, 12]
    assert ph._plateau_fit(trace, 2) == jax_ph._plateau_fit(trace, 2)
    assert ph._all_plateau_fits(trace, 2) == jax_ph._all_plateau_fits(trace,
                                                                      2)
    fit, r2 = ph._plateau_fit([100, 100, 50, 50], 1)
    assert fit == [[100, 100], [50, 50]] and r2 == 1.0


def test_pipeline_fluor_counts_matches_the_jax_pipeline(tracks_csv):
    cfg = dict(max_possible=4, allow_multidrop=True)
    pipe = Pipeline(PipelineConfig(lognormal=LognormalConfig(**cfg)),
                    device="cpu", profile=True)
    ref = jax_api.Pipeline(jax_config.PipelineConfig(
        lognormal=jax_config.LognormalConfig(**cfg)))
    profiling.reset_timings()
    got = pipe.fluor_counts(tracks_csv, BETA, BETA_SIGMA)
    assert "api/fluor_counts" in profiling.timings()
    _assert_same_fit(got, ref.fluor_counts(tracks_csv, BETA, BETA_SIGMA))
    assert v8_score_fused.launches == 0  # the CPU runs the twin
    kw = dict(alpha_adjust=90.0, downstep_filtered=True, channels=["ch1"],
              quench_factors=(0.0, 0.05, 0.05, 0.05, 0.05, 0.05))
    _assert_same_fit(pipe.fluor_counts(tracks_csv, BETA, BETA_SIGMA, **kw),
                     ref.fluor_counts(tracks_csv, BETA, BETA_SIGMA, **kw))
    photometries, _ = ph.read_track_photometries_csv(tracks_csv)
    for alpha in (0.0, 75.0):
        _assert_same_fit(
            pipe.fluor_counts(photometries, BETA, BETA_SIGMA,
                              alpha_adjust=alpha),
            ref.fluor_counts(photometries, BETA, BETA_SIGMA,
                             alpha_adjust=alpha))
    # device= in the keywords names the scoring device (the JAX mesh=).
    assert pipe.fluor_counts(photometries, BETA, BETA_SIGMA,
                             device="cpu")[:3] == got[:3]
    with pytest.raises(TypeError, match="no CSV-reader options: "
                       "downstep_filtered"):
        pipe.fluor_counts(photometries, BETA, BETA_SIGMA,
                          downstep_filtered=True)
    with pytest.raises(TypeError, match="CSV-reader options"):
        ref.fluor_counts(photometries, BETA, BETA_SIGMA,
                         downstep_filtered=True)


def _calibration_tracks(seed=5, n=160, n_cycles=6):
    rng = np.random.default_rng(seed)
    photometries = {"ch1": {0: {}}}
    for t in range(n):
        n0 = int(rng.integers(1, 3))
        drop = int(rng.integers(1, n_cycles))
        counts = [n0] * drop + [n0 - 1] * (n_cycles - drop)
        intensities = tuple(
            float(c * BETA * np.exp(rng.normal(0, 0.18))) if c else
            float(rng.normal(0, 120.0)) for c in counts)
        photometries["ch1"][0][(t, t)] = (tuple(c > 0 for c in counts),
                                          intensities, t)
    return photometries


def test_pipeline_fluor_counts_calibrated_matches_the_jax_pipeline(tmp_path):
    photometries = _calibration_tracks()
    path = str(tmp_path / "tracks.csv")
    ph.write_photometries_dict_to_csv(photometries, path)
    pipe, ref = Pipeline(device="cpu"), jax_api.Pipeline()
    for tracks, kw in ((path, {}), (photometries, {}),
                       (path, dict(beta=28000.0, adjustment=False,
                                   allow_multidrop=False, truncate=1,
                                   ddif=0.05, max_possible=3))):
        got = pipe.fluor_counts_calibrated(tracks, **kw)
        want = ref.fluor_counts_calibrated(tracks, **kw)
        _assert_same_fit(got[:4], want[:4])
        assert got[4] == want[4]
        assert sorted(got[4]) == ["alpha", "beta", "beta_sigma",
                                  "beta_sigma_estimate", "original_beta",
                                  "original_beta_sigma"]
    assert got[4]["beta"] == 28000.0 and got[4]["beta_sigma"] == 0.2
    free = pipe.fluor_counts_calibrated(path)
    assert 0.5 * BETA < free[4]["beta"] < 2.0 * BETA
    assert free[1] == 160 and sum(free[0].values()) > 100
