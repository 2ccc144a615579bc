"""The port's movie front door against the JAX package's, on the CPU.

The same numpy-seeded movies go through both packages. Stated tolerances:

- the tracker (``lc_track``) from the same float start centers: ``rec_h``,
  ``rec_w`` and ``present`` equal, every frame;
- photometries at given positions: rtol 1e-5 (float32 window sums in
  another order);
- the whole ``run_timetrace`` from each package's own detection: start
  centers within 1e-3 px, tracked integers equal, photometries rel 1e-5 /
  abs 1e-2 (a bleached spot's mexican hat is a difference of float32 sums
  near zero), plateau starts and stops equal and heights (means of the
  photometries) at the same tolerance, CSV cells rel 1e-5 / abs 1e-2 and
  Hcoord/Wcoord abs 1e-3;
- the planted traces and movies equal ``bench.py``'s arrays exactly.
"""

import csv
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fluorosequencingimageanalysis_tpu import api as jax_api
from fluorosequencingimageanalysis_tpu import config as jax_config
from fluorosequencingimageanalysis_tpu.inference import (
    photometries as jax_inference)
from fluorosequencingimageanalysis_tpu.ops import photometry as jax_phot
from fluorosequencingimageanalysis_tpu.pipeline import (
    fast_timetrace as jax_ft)

import bench
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.config import (PhotometryConfig,
                                                        PipelineConfig,
                                                        StepfitConfig)
from fluorosequencingimageanalysis_torch.inference.photometries import (
    read_track_photometries_csv)
from fluorosequencingimageanalysis_torch.ops import photometry as phot_ops
from fluorosequencingimageanalysis_torch.pipeline import fast_timetrace as ft
from fluorosequencingimageanalysis_torch.pipeline.experiment import (
    TimetraceExperiment)
from fluorosequencingimageanalysis_torch.pipeline.traces import (
    PhotometryTrace, PlateauTrace)
from fluorosequencingimageanalysis_torch.utils import profiling, synth
from fluorosequencingimageanalysis_torch.utils.convert import (
    timetrace_result_arrays)

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

STEPFIT = dict(mirror_start=10, chung_kennedy=1, p_threshold=0.01)
STAGES = ["upload", "detect", "track+photometry", "stepfit", "assemble",
          "csv"]


def make_movie(T=24, H=96, W=96, n_spots=10, seed=0, beta=2500.0,
               drift=0.08):
    """Bleaching spots: each drops to background in 1-3 steps, with slow
    subpixel wander (the movie of the JAX package's timetrace tests)."""
    rng = np.random.default_rng(seed)
    hh, ww = np.indices((H, W)).astype(np.float32)
    movie = rng.normal(400.0, 6.0, (T, H, W)).astype(np.float32)
    pos = rng.uniform(12, H - 12, (n_spots, 2))
    steps = rng.integers(1, 4, n_spots)
    for s in range(n_spots):
        drops = np.sort(rng.choice(np.arange(4, T - 2), steps[s],
                                   replace=False))
        level = float(steps[s])
        wander = rng.normal(0, drift, (T, 2)).cumsum(axis=0)
        for f in range(T):
            if len(drops) and f >= drops[0]:
                level -= 1.0
                drops = drops[1:]
            if level <= 0:
                break
            h = pos[s, 0] + wander[f, 0]
            w = pos[s, 1] + wander[f, 1]
            movie[f] += level * beta * np.exp(
                -(((hh - h) ** 2) + ((ww - w) ** 2)) / (2 * 1.3 ** 2))
    return movie


def _blob(hh, ww, h, w, amp=3000.0):
    return amp * np.exp(-(((hh - h) ** 2) + ((ww - w) ** 2)) /
                        (2 * 1.3 ** 2))


def _track_both(movie, h0, w0, **kw):
    got = ft.lc_track(movie, h0, w0, device="cpu", **kw)
    want = jax_ft.lc_track(movie, h0, w0, **kw)
    for g, w, name in zip(got, want, ("rec_h", "rec_w", "present")):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def _read_csv(path):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], rows[1:]


def _compare_csvs(header_ref, rows_ref, header_got, rows_got):
    """Cell by cell: numbers rel 1e-5 / abs 1e-2 (Hcoord and Wcoord abs
    1e-3), anything else as text."""
    assert header_got == header_ref
    assert len(rows_got) == len(rows_ref) > 0
    for i, (got, ref) in enumerate(zip(rows_got, rows_ref)):
        assert len(got) == len(ref), i
        for j, (a, b) in enumerate(zip(got, ref)):
            where = (i, header_ref[j], a, b)
            try:
                fb = float(b)
            except ValueError:
                assert a == b, where
                continue
            if header_ref[j] in ("Hcoord", "Wcoord"):
                assert float(a) == pytest.approx(fb, abs=1e-3), where
            else:
                assert float(a) == pytest.approx(fb, rel=1e-5,
                                                 abs=1e-2), where


# ---------------------------------------------------------------------------
# The planted inputs
# ---------------------------------------------------------------------------

def test_planted_traces_and_movies_are_the_benchmarks():
    traces, drops = synth.make_step_traces(40, 100, seed=3,
                                           return_truth=True)
    np.testing.assert_array_equal(traces,
                                  bench.make_step_traces(40, 100, seed=3))
    np.testing.assert_array_equal(synth.make_step_traces(40, 100, seed=3),
                                  traces)
    assert len(drops) == 40 and all(1 <= len(d) <= 4 and d == sorted(d)
                                    for d in drops)
    # Each planted drop lowers the noiseless level by beta at its frame.
    clean = synth.make_step_traces(4, 60, seed=1, noise=0.0)
    _, d = synth.make_step_traces(4, 60, seed=1, noise=0.0,
                                  return_truth=True)
    for row, frames in zip(clean, d):
        assert np.flatnonzero(np.diff(row) < 0).tolist() == \
            [f - 1 for f in frames]
    movie, truth = synth.make_movie(T=10, H=64, W=64, n_spots=9, seed=2,
                                    return_truth=True)
    ref = bench.make_movie(T=10, H=64, W=64, n_spots=9, seed=2)
    assert movie.dtype == ref.dtype == np.uint16
    np.testing.assert_array_equal(movie, ref)
    np.testing.assert_array_equal(
        synth.make_movie(T=10, H=64, W=64, n_spots=9, seed=2), movie)
    pos, levels = truth["positions"], truth["levels"]
    assert pos.shape == (9, 10, 2) and levels.shape == (9, 10)
    assert (np.isnan(pos[..., 0]) == (levels == 0)).all()
    assert (levels[:, 0] >= 1).all() and (np.diff(levels, axis=1) <= 0).all()
    for s, frames in enumerate(truth["drops"]):
        assert np.flatnonzero(np.diff(levels[s]) < 0).tolist() == \
            [f - 1 for f in frames]
    # A bright planted spot is the brightest thing near its position.
    s = int(np.argmax(levels[:, 0]))
    h, w = np.round(pos[s, 0]).astype(int)
    assert movie[0, h, w] > 400 + 0.5 * 2500
    np.testing.assert_array_equal(
        synth.make_chisq_traces(5, 40, seed=4).shape, (5, 40))


# ---------------------------------------------------------------------------
# The tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_sn", [True, False])
def test_luminosity_centroid_batch_matches_jax(with_sn):
    movie = make_movie(seed=4, T=10, n_spots=8)
    rng = np.random.default_rng(0)
    hs = rng.integers(3, 93, 40)
    ws = rng.integers(3, 93, 40)
    for radius in (3, 2):
        got = phot_ops.luminosity_centroid_batch(
            torch.from_numpy(movie[0]), torch.from_numpy(hs),
            torch.from_numpy(ws), radius=radius, with_sn=with_sn)
        want = jax_phot.luminosity_centroid_batch(
            jnp.asarray(movie[0]), jnp.asarray(hs), jnp.asarray(ws),
            radius=radius, with_sn=with_sn)
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        if with_sn:
            # A ratio over a float32 standard deviation of 16 pixels.
            np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                       rtol=1e-4)
        else:
            assert got[2] is None and want[2] is None


def test_lc_track_equals_jax_from_the_same_starts():
    movie = make_movie(seed=7, T=16, n_spots=8)
    from fluorosequencingimageanalysis_tpu.models.detect import (
        find_peptide_centers)
    h0, w0, _, _ = find_peptide_centers(jnp.asarray(movie[0]),
                                        max_candidates=256)
    assert len(h0) >= 6
    # The detector's keys are rounded centers; float starts (as the class
    # path's fitted centers are) truncate and round on the host.
    rng = np.random.default_rng(0)
    _track_both(movie, h0, w0)
    h0 = np.asarray(h0) + rng.uniform(-0.45, 0.45, len(h0))
    w0 = np.asarray(w0) + rng.uniform(-0.45, 0.45, len(w0))
    rec_h, rec_w, present = _track_both(movie, h0, w0)
    assert rec_h.shape == (16, len(h0)) and rec_h.dtype == np.int32
    np.testing.assert_array_equal(rec_h[0], np.trunc(h0).astype(np.int32))
    assert present[0].all() and present[1:].any()
    assert (rec_h[~present] == -1).all() and (rec_w[~present] == -1).all()
    # Other gate settings and the raw camera dtype.
    _track_both(movie, h0, w0, search_radius=2, s_n_cutoff=8.0)
    as_u16 = np.clip(movie, 0, 65535).astype(np.uint16)
    a = ft.lc_track(as_u16, h0, w0, device="cpu")
    b = ft.lc_track(torch.from_numpy(as_u16.astype(np.float32)), h0, w0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # No spots, and a single frame.
    empty = ft.lc_track(movie, [], [], device="cpu")
    assert [x.shape for x in empty] == [(16, 0)] * 3
    one = ft.lc_track(movie[:1], h0, w0, device="cpu")
    assert one[0].shape == (1, len(h0)) and one[2].all()


def test_lc_track_saturated_flat_region_keeps_the_candidate():
    """A tracked spot whose 5x5 slice goes exactly flat (a saturated
    region: edge std 0 and max == mean) has a NaN S/N; the gate is "fall
    back if S/N < cutoff" and NaN < x is False, so the candidate stays."""
    rng = np.random.default_rng(21)
    T, H, W = 8, 64, 64
    hh, ww = np.indices((H, W)).astype(np.float32)
    movie = rng.normal(400.0, 6.0, (T, H, W)).astype(np.float32)
    for f in range(T):
        movie[f] += _blob(hh, ww, 44.3, 44.6)
        if f == 0:
            movie[f] += _blob(hh, ww, 20.2, 20.4)
        else:
            movie[f, 8:33, 8:33] = 50000.0
    _, _, present = _track_both(movie, [20.2, 44.3], [20.4, 44.6])
    assert present.all()


def test_lc_track_edge_spot_goes_none():
    rng = np.random.default_rng(11)
    T, H, W = 10, 64, 64
    hh, ww = np.indices((H, W)).astype(np.float32)
    movie = rng.normal(400.0, 6.0, (T, H, W)).astype(np.float32)
    for f in range(T):
        movie[f] += _blob(hh, ww, 32.3, 40.6)
        h_edge = 6.0 - 1.2 * f
        if h_edge > -4:
            movie[f] += _blob(hh, ww, h_edge, 20.4)
    rec_h, _, present = _track_both(movie, [32.3, 6.0], [40.6, 20.4])
    assert present[:, 0].all() and not present[:, 1].all()
    assert (rec_h[~present[:, 1], 1] == -1).all()


def test_tracker_loop_reads_nothing_back():
    """On meta tensors (no data) any host read inside the loop raises."""
    movie = torch.zeros((5, 32, 32), dtype=torch.uint16, device="meta")
    state = torch.zeros(3, dtype=torch.int32, device="meta")
    rec_h, rec_w, present = ft._lc_track_scan(movie, state, state, state,
                                              state)
    assert rec_h.shape == rec_w.shape == present.shape == (4, 3)
    assert rec_h.dtype == torch.int32 and present.dtype == torch.bool


# ---------------------------------------------------------------------------
# Photometry of the tracks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["mexican_hat", "simple", "maximum"])
def test_fused_track_photometry_equals_two_step_and_jax(method):
    movie = make_movie(seed=9, T=12, n_spots=8, H=64, W=64)
    # Starts near the frame edge take the host fallbacks.
    h0 = np.array([12.4, 30.6, 50.2, 3.1, 60.7])
    w0 = np.array([20.3, 40.8, 10.5, 61.2, 4.4])
    movie_dev = torch.from_numpy(movie)
    rec_h, rec_w, present = ft.lc_track(movie_dev, h0, w0)
    ref = ft.timetrace_photometries(movie_dev, rec_h, rec_w, present,
                                    method, photometry_min=100.0)
    for chunk in (65536, 32):  # T * N = 60: one dispatch, then two
        profiling.reset_counters()
        fh, fw, fp, phot = ft.lc_track_and_photometry(
            movie_dev, h0, w0, method, photometry_min=100.0, chunk=chunk)
        np.testing.assert_array_equal(fh, rec_h)
        np.testing.assert_array_equal(fw, rec_w)
        np.testing.assert_array_equal(fp, present)
        np.testing.assert_allclose(phot, ref, rtol=1e-6, atol=1e-4)
        c = profiling.counters()
        assert c["ledger/photometry_dispatches"] == -(-60 // chunk)
        assert c["ledger/result_fetches"] == 4
    assert phot.shape == (5, 12) and phot.dtype == np.float64
    assert (phot >= 100.0).all()
    jh, jw, jp, jphot = jax_ft.lc_track_and_photometry(
        jnp.asarray(movie), h0, w0, method, photometry_min=100.0)
    np.testing.assert_array_equal(fh, jh)
    np.testing.assert_array_equal(fp, jp)
    np.testing.assert_allclose(phot, jphot, rtol=1e-5)
    edge = present & ((rec_h < 9) | (rec_h >= 55) | (rec_w < 9) |
                      (rec_w >= 55))
    assert edge.any() and (present & ~edge).any()


@pytest.mark.parametrize("method", ["gaussian_volume", "sigmas",
                                    "sextractor"])
def test_timetrace_photometries_other_methods_match_jax(method):
    movie = make_movie(seed=3, T=10, n_spots=6, H=64, W=64)[:6]
    h0 = np.array([14.2, 30.6, 48.9, 40.0])
    w0 = np.array([20.3, 44.8, 12.5, 40.0])
    fits = [(14.2, 20.3, 400.0, 2500.0, 1.3, 1.25, 0.1), None,
            (48.9, 12.5, 401.0, 1800.0, 1.4, 1.2, 0.0),
            (40.0, 40.0, 399.0, 900.0, 1.1, 1.3, 0.3)]
    rec_h, rec_w, present = ft.lc_track(movie, h0, w0, device="cpu")
    present[3:, 2] = False
    kw = dict(initial_fits=fits, photometry_min=None, aperture_radius=3,
              box_size=16, filter_size=3)
    got = ft.timetrace_photometries(torch.from_numpy(movie), rec_h, rec_w,
                                    present, method, **kw)
    want = jax_ft.timetrace_photometries(jnp.asarray(movie), rec_h, rec_w,
                                         present, method, **kw)
    assert got.shape == (4, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got[2, 3:] == 0).all()
    floored = ft.timetrace_photometries(
        torch.from_numpy(movie), rec_h, rec_w, present, method,
        **dict(kw, photometry_min=50.0))
    np.testing.assert_array_equal(floored, np.maximum(got, 50.0))


# ---------------------------------------------------------------------------
# The front door
# ---------------------------------------------------------------------------

def _configs(method="mexican_hat", **stepfit):
    sf = dict(STEPFIT, **stepfit)
    return (PipelineConfig(stepfit=StepfitConfig(**sf),
                           photometry=PhotometryConfig(method=method)),
            jax_config.PipelineConfig(
                stepfit=jax_config.StepfitConfig(**sf),
                photometry=jax_config.PhotometryConfig(method=method)))


def _assert_results_agree(got, want):
    g, w = timetrace_result_arrays(got), timetrace_result_arrays(want)
    assert got["trace_count"] == want["trace_count"] == len(g["h0"])
    np.testing.assert_allclose(g["h0"], w["h0"], atol=1e-3)
    np.testing.assert_allclose(g["w0"], w["w0"], atol=1e-3)
    for k in ("rec_h", "rec_w", "present"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    np.testing.assert_allclose(g["photometries"], w["photometries"],
                               rtol=1e-5, atol=1e-2)
    for k in ("step_fits", "plateaus"):
        for (gs, ge, gh), (ws, we, wh) in zip(g[k], w[k]):
            np.testing.assert_array_equal(gs, ws, err_msg=k)
            np.testing.assert_array_equal(ge, we, err_msg=k)
            np.testing.assert_allclose(gh, wh, rtol=1e-5, atol=1e-2,
                                       err_msg=k)
    for gc, wc in zip(g["ck"], w["ck"]):
        np.testing.assert_allclose(gc, wc, rtol=1e-5, atol=1e-2)
    return g


@pytest.mark.parametrize("seed,ck,mirror", [(0, 1, 10), (5, 0, 0)])
def test_run_timetrace_matches_the_jax_packages(seed, ck, mirror, tmp_path,
                                                capsys):
    movie = make_movie(seed=seed)
    cfg, jcfg = _configs(chung_kennedy=ck, mirror_start=mirror)
    profiling.reset_timings()
    profiling.reset_counters()
    import time
    t0 = time.perf_counter()
    got = Pipeline(cfg, device="cpu", profile=True).run_timetrace(
        movie, csv_path=str(tmp_path / "port.csv"), max_candidates=256)
    wall = time.perf_counter() - t0
    stages = profiling.timings()
    assert [s for s in STAGES
            if "api/run_timetrace/" + s in stages] == STAGES
    named = sum(stages["api/run_timetrace/" + s]["total"] for s in STAGES)
    with capsys.disabled():
        print(f"\nrun_timetrace on the CPU: wall {wall:.3f} s, named "
              f"{named:.3f} s, unnamed share {1 - named / wall:.1%}")
    assert named <= wall
    c = profiling.counters()
    # On the CPU the movie is used where it lies: the one upload is the
    # step fitter's; the tracker and the step fitter dispatch once each.
    assert c["ledger/uploads"] == 1 and c["ledger/step_dispatches"] == 2
    assert c["ledger/result_fetches"] == 4 + 1 + (ck > 0)
    want = jax_api.Pipeline(jcfg).run_timetrace(
        movie, csv_path=str(tmp_path / "jax.csv"), max_candidates=256)
    assert list(got) == list(want)
    assert list(got["traces"]) == list(want["traces"])
    g = _assert_results_agree(got, want)
    assert got["trace_count"] > 3 and got["csv_path"].endswith("port.csv")
    assert any(len(s[0]) > 1 for s in g["step_fits"])
    # The same Python types, keyed by the float start centers.
    key = (got["traces"]["h"][0], got["traces"]["w"][0])
    assert type(key[0]) is type(want["traces"]["h"][0])
    assert isinstance(got["step_fits"][key], PlateauTrace)
    inter = got["step_fit_intermediates"][key]
    assert sorted(inter) == sorted(want["step_fit_intermediates"][
        (want["traces"]["h"][0], want["traces"]["w"][0])])
    assert isinstance(inter["photometries"], PhotometryTrace)
    assert isinstance(inter["t_filtered_plateaus"], PlateauTrace)
    for a, b, h in got["step_fits"][key].trace:
        assert isinstance(a, int) and isinstance(b, int) and \
            isinstance(h, float)
    header_ref, rows_ref = _read_csv(tmp_path / "jax.csv")
    header_got, rows_got = _read_csv(tmp_path / "port.csv")
    assert len(rows_got) == got["trace_count"] * movie.shape[0]
    _compare_csvs(header_ref, rows_ref, header_got, rows_got)


def test_run_timetrace_csv_options_and_sextractor(tmp_path):
    movie = make_movie(seed=3, T=12, n_spots=6)
    cfg, jcfg = _configs(method="sextractor")
    profiling.reset_timings()
    got = Pipeline(cfg, device="cpu", profile=True).run_timetrace(
        movie, csv_path=str(tmp_path / "port.csv"), max_candidates=256,
        include_intermediates=None, photometry_min=None)
    assert {"api/run_timetrace/track", "api/run_timetrace/photometry"} <= \
        set(profiling.timings())
    want = jax_api.Pipeline(jcfg).run_timetrace(
        movie, csv_path=str(tmp_path / "jax.csv"), max_candidates=256,
        include_intermediates=None, photometry_min=None)
    _assert_results_agree(got, want)
    assert got["trace_count"] > 2
    header, rows = _read_csv(tmp_path / "port.csv")
    assert header == ["Trace #", "Hcoord", "Wcoord", "Frame #", "Photometry",
                      "Step #", "Plateau Height", "Step Size",
                      "Plateau Length", "Overall Fit R^2"]
    _compare_csvs(*_read_csv(tmp_path / "jax.csv"), header, rows)
    with pytest.raises(ValueError, match="frames, H, W"):
        Pipeline(cfg, device="cpu").run_timetrace(movie[0])


def test_run_timetrace_uint16_equals_float32(tmp_path):
    movie_u = np.clip(make_movie(seed=2, T=12, n_spots=8), 0,
                      65535).astype(np.uint16)
    pipe = Pipeline(device="cpu")
    kw = dict(max_candidates=256, chung_kennedy=1)
    out_u = pipe.run_timetrace(movie_u, csv_path=str(tmp_path / "u.csv"),
                               **kw)
    out_f = pipe.run_timetrace(movie_u.astype(np.float32),
                               csv_path=str(tmp_path / "f.csv"), **kw)
    out_t = pipe.run_timetrace(torch.from_numpy(movie_u),
                               csv_path=str(tmp_path / "t.csv"), **kw)
    assert out_u["trace_count"] == out_f["trace_count"] > 3
    text = (tmp_path / "u.csv").read_text()
    assert text == (tmp_path / "f.csv").read_text()
    assert text == (tmp_path / "t.csv").read_text()
    np.testing.assert_array_equal(out_t["photometries"],
                                  out_u["photometries"])


def test_run_timetrace_empty_movie_writes_a_header_only_csv(tmp_path):
    rng = np.random.default_rng(0)
    blank = rng.normal(400.0, 6.0, (4, 64, 64)).astype(np.float32)
    got = Pipeline(device="cpu").run_timetrace(
        blank, csv_path=str(tmp_path / "port.csv"), max_candidates=64)
    want = jax_api.Pipeline().run_timetrace(
        blank, csv_path=str(tmp_path / "jax.csv"), max_candidates=64)
    assert got["trace_count"] == want["trace_count"] == 0
    assert got["photometries"].shape == want["photometries"].shape == (0, 4)
    assert got["traces"] == want["traces"]
    assert got["step_fits"] == {} and got["step_fit_intermediates"] == {}
    text = (tmp_path / "port.csv").read_text()
    assert text == (tmp_path / "jax.csv").read_text()
    assert len(text.splitlines()) == 1 and text.startswith("Trace #")
    assert Pipeline(device="cpu").run_timetrace(
        blank, max_candidates=64)["csv_path"] is None


def test_run_timetraces_equals_per_movie_calls(tmp_path):
    movies = [make_movie(seed=s, T=10, n_spots=6) for s in (0, 3)]
    movies[1] = np.clip(movies[1], 0, 65535).astype(np.uint16)
    pipe = Pipeline(device="cpu")
    kw = dict(max_candidates=256, chung_kennedy=1)
    singles = []
    for i, m in enumerate(movies):
        p = tmp_path / f"single_{i}.csv"
        pipe.run_timetrace(m, csv_path=str(p), **kw)
        singles.append(p.read_text())
    for prefetch in (None, False, True):
        paths = [tmp_path / f"batch_{prefetch}_{i}.csv" for i in range(2)]
        outs = pipe.run_timetraces(movies, csv_paths=[str(p) for p in paths],
                                   prefetch=prefetch, **kw)
        assert len(outs) == 2
        for i, p in enumerate(paths):
            assert p.read_text() == singles[i], (prefetch, i)
    assert [o["csv_path"] for o in pipe.run_timetraces(movies, **kw)] == \
        [None, None]
    assert pipe.run_timetraces([], **kw) == []
    with pytest.raises(ValueError, match="one entry per movie"):
        pipe.run_timetraces(movies, csv_paths=["only_one.csv"], **kw)
    with pytest.raises(TypeError, match="csv_paths"):
        pipe.run_timetraces(movies[:1], csv_path="out.csv")
    with pytest.raises(ValueError, match="frames, H, W"):
        pipe.run_timetraces([movies[0][0]], prefetch=True)


# ---------------------------------------------------------------------------
# The container and the track CSV reader
# ---------------------------------------------------------------------------

def test_timetrace_experiment_container_matches_jax(tmp_path):
    from fluorosequencingimageanalysis_tpu.pipeline import (
        experiment as jax_experiment, traces as jax_traces)

    def build(traces_mod, cls):
        a = traces_mod.PhotometryTrace((5.0, 5.5, 1.0, 1.5), 3.25, 4.0)
        b = traces_mod.PhotometryTrace((2.0, 2.0, 2.5, 2.0), 9.0, 1.5)
        fits = {(3.25, 4.0): traces_mod.PlateauTrace(
                    [(0, 1, 5.25), (2, 3, 1.25)], 3.25, 4.0),
                (9.0, 1.5): traces_mod.PlateauTrace([(0, 3, 2.125)], 9.0,
                                                    1.5)}
        inter = {hw: {"photometries": t, "t_filtered_plateaus": fits[hw]}
                 for hw, t in (((3.25, 4.0), a), ((9.0, 1.5), b))}
        return cls([None] * 4, [a, b], fits, inter), inter

    import fluorosequencingimageanalysis_torch.pipeline.traces as traces
    tte, inter = build(traces, TimetraceExperiment)
    ref, _ = build(jax_traces, jax_experiment.TimetraceExperiment)
    assert tte._get_all_intermediates() == {"photometries",
                                            "t_filtered_plateaus"}
    for k, kw in enumerate((dict(), dict(include_step_fits=True),
                            dict(include_step_fits=True,
                                 include_intermediates=True),
                            dict(include_intermediates=["photometries"],
                                 photometry_method="simple"))):
        n = tte.save_experiment_as_csv(str(tmp_path / f"t{k}.csv"), **kw)
        assert n == ref.save_experiment_as_csv(str(tmp_path / f"r{k}.csv"),
                                               **kw) == 9
        assert (tmp_path / f"t{k}.csv").read_text() == \
            (tmp_path / f"r{k}.csv").read_text()
    header, rows = _read_csv(tmp_path / "t2.csv")
    assert header[-2:] == ["photometries", "t_filtered_plateaus"]
    assert rows[0][:5] == ["0", "3.25", "4.0", "0", "5.0"]
    assert rows[2][-1] == "1.25" and rows[3][-1] == "1.25"
    assert TimetraceExperiment([None], [tte.spot_traces[0]]
                               ).step_fit_intermediates == {}
    inter[(9.0, 1.5)].pop("photometries")
    with pytest.raises(Exception, match="identical intermediates"):
        tte._get_all_intermediates()
    tte.save_traces_pkl(str(tmp_path / "t.pkl"))
    with open(tmp_path / "t.pkl", "rb") as fh:
        back = pickle.load(fh)
    assert [t.trace for t in back] == [t.trace for t in tte.spot_traces]
    # The whole class is ported since the Spot classes are
    # (tests/test_torch_objects.py drives the rest of it).
    for name in ("lc_create_traces", "stepfit_tracks",
                 "wildcolor_plot_tracks", "save_stepfits_as_csv"):
        assert callable(getattr(tte, name)) and hasattr(ref, name)


def test_read_track_photometries_csv_matches_jax(tmp_path):
    path = tmp_path / "tracks.csv"
    path.write_text(
        "CHANNEL,FIELD,H,W,CATEGORY,FRAME 0,FRAME 1,FRAME 2\n"
        "ch1,0,10.5,20.49,\"(True, True, False)\",100.5,90.2,3.0\n"
        "ch1,1,11.0,None,\"(True, False, False)\",1,2,3\n"
        "ch2,0,12.5,7.0,\"(False, True, False)\",7.5,8.5,-0.5\n"
        "ch1,0,30.0,31.0,\"(True, False, False)\",55.0,1.0,2.0\n")
    for kw in (dict(), dict(channels=["ch1"]), dict(downstep_filtered=True),
               dict(head_truncate=1), dict(tail_truncate=1)):
        got = read_track_photometries_csv(str(path), **kw)
        want = jax_inference.read_track_photometries_csv(
            str(path), use_native=False, **kw)
        assert got == want, kw
    d, d2 = read_track_photometries_csv(str(path))
    assert d["ch1"][0][(11, 20)] == ((True, True, False), (101, 90, 3), 1)
    assert d2[3] == ("ch2", 0, 13, 7, (False, True, False), (8, 9, -1))
    assert 2 not in d2  # the row without a position is skipped
