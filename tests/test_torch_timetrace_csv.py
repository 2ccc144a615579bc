"""The native timetrace CSV writer (native/timetrace_csv.py over
csrc/timetrace_csv.cpp) against the class path it replaces on
``run_timetrace``'s path: ``TimetraceExperiment.save_experiment_as_csv``
over the same step fits, byte for byte; its float layout against
``repr(float)`` and ``str(numpy.float64)``; its R^2 and mean against
``Trace.coefficient_of_determination`` and ``np.mean``, bit for bit.

Imports no JAX, so it also runs where the port runs:

    python -m pytest --noconftest tests/test_torch_timetrace_csv.py -q
"""

import math
import struct

import numpy as np
import pytest

from fluorosequencingimageanalysis_torch.native import timetrace_csv
from fluorosequencingimageanalysis_torch.ops.stepfit_batch import (
    StepfitArrays, stepfit_arrays, stepfit_lists)
from fluorosequencingimageanalysis_torch.pipeline.experiment import (
    TimetraceExperiment)
from fluorosequencingimageanalysis_torch.pipeline.traces import (
    PhotometryTrace, PlateauTrace, Trace)


def bleaching_traces(N, T, seed):
    """(N, T) float64 photometries of 1-3 dyes bleaching at random frames
    under noise, some traces below zero (a background-subtracted
    photometry can be)."""
    rng = np.random.default_rng(seed)
    out = np.empty((N, T))
    for i in range(N):
        dyes = int(rng.integers(1, 4))
        drops = np.sort(rng.integers(1, T, dyes))
        level = np.full(T, float(dyes))
        for d in drops:
            level[d:] -= 1.0
        offset = rng.choice([0.0, -2500.0, 400.0])
        out[i] = level * 5000.0 + offset + rng.normal(0, 600.0, T)
    return out


def start_keys(N, seed):
    """N distinct integer (h, w) start keys, as the detector gives them."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(512 * 512, N, replace=False)
    return flat // 512, flat % 512


def class_csv(path, h0, w0, fits, include_step_fits, include_intermediates):
    """The class path's file for the fits, built as run_timetrace built
    it before the native writer."""
    step_fits, intermediates, traces = {}, {}, []
    for hh, ww, (phots, ck, plateaus, t_filtered) in zip(
            h0.tolist(), w0.tolist(), stepfit_lists(fits)):
        hw = (hh, ww)
        step_fits[hw] = PlateauTrace(t_filtered, hh, ww)
        intermediates[hw] = {
            "photometries": PhotometryTrace(phots, hh, ww),
            "ck_filtered_photometries": PhotometryTrace(ck, hh, ww),
            "plateaus": PlateauTrace(plateaus, hh, ww),
            "t_filtered_plateaus": PlateauTrace(t_filtered, hh, ww)}
        traces.append(PhotometryTrace(phots, hh, ww))
    return TimetraceExperiment(
        frames=[None] * fits.phot.shape[1], spot_traces=traces,
        step_fits=step_fits, step_fit_intermediates=intermediates
    ).save_experiment_as_csv(path, include_step_fits=include_step_fits,
                             include_intermediates=include_intermediates)


_FITS = {}


def fits_of(N, T, mirror_start, chung_kennedy):
    key = (N, T, mirror_start, chung_kennedy)
    if key not in _FITS:
        phot = bleaching_traces(N, T, seed=N * 1000 + T)
        _FITS[key] = stepfit_arrays(
            phot, mirror_start=mirror_start, chung_kennedy=chung_kennedy,
            p_threshold=0.01, device="cpu", n_threads=1)
    return _FITS[key]


# ---------------------------------------------------------------------------
# Floats as Python writes them
# ---------------------------------------------------------------------------

EDGES = [0.0, -0.0, 1e-4, -1e-4, 9.999e-5, 1e-5, 1e15, 1e16, 1e22, 5e-324,
         -5e-324, 2.2250738585072014e-308, 1.7976931348623157e308,
         -1.7976931348623157e308, math.nan, -math.nan, math.inf, -math.inf,
         1.0, -1.0, 2.0, 100.0, 123456.0, -2500.0, 1e15 + 1, 1e16 - 2,
         9999999999999998.0, 0.1, 0.2 + 0.1, 1 / 3, -1234.5678,
         0.00012345, 0.000999, 123456789012345.6, 1234567890123456.7,
         2.0 ** 53, 2.0 ** 53 + 2, 2.0 ** 70, 2.0 ** -20, 1e100, 1e-100,
         np.nextafter(1e-4, 0.0), np.nextafter(1e-4, 1.0),
         np.nextafter(1e16, 0.0), np.nextafter(1e16, 1e17)]


def test_floats_equal_repr_on_edge_cases():
    got = timetrace_csv.format_doubles(EDGES)
    for g, v in zip(got, EDGES):
        assert g == repr(float(v)) == str(np.float64(v)), v


@pytest.mark.parametrize("seed", range(4))
def test_floats_equal_repr_on_random_bit_patterns(seed):
    """50,000 random float64 bit patterns a seed (200,000 in all), which
    mostly have large exponents, and as many values spread over the
    exponents where Python switches between fixed and exponent notation,
    integral values and short decimals among them."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2 ** 64, 50_000, dtype=np.uint64,
                        endpoint=False)
    near = np.concatenate([
        10.0 ** rng.uniform(-7, 19, 30_000) * rng.choice([-1, 1], 30_000),
        np.round(rng.uniform(-1e6, 1e6, 10_000)),
        np.round(rng.uniform(-1e4, 1e4, 10_000), int(rng.integers(1, 6)))])
    values = np.concatenate([bits.view(np.float64), near])
    got = timetrace_csv.format_doubles(values)
    want = [repr(v) for v in values.tolist()]
    assert got == want
    assert got[:2000] == [str(v) for v in values[:2000]]


def test_floats_equal_repr_around_every_notation_switch():
    """The doubles next to each power of ten that Python can print, where
    the shortest digits and the notation change."""
    values = []
    for e in range(-323, 309):
        p = float(f"1e{e}")
        values += [p, np.nextafter(p, 0.0), np.nextafter(p, math.inf),
                   -p, 9.5 * p / 10]
    got = timetrace_csv.format_doubles(values)
    assert got == [repr(float(v)) for v in values]


# ---------------------------------------------------------------------------
# R^2 and the mean, bit for bit
# ---------------------------------------------------------------------------

def _bits(x):
    return struct.pack("<d", x)


@pytest.mark.parametrize("T", [7, 100, 128, 129])
def test_r_squared_and_mean_are_the_class_paths_bit_for_bit(T):
    fits = fits_of(64, T, 0, 1)
    r2, mean, codes = timetrace_csv.r_squared(fits.phot, fits.t_filtered)
    assert not codes.any()
    for i, (phots, _ck, _pl, t_filtered) in enumerate(stepfit_lists(fits)):
        want = Trace.coefficient_of_determination(
            PhotometryTrace(phots, 0, 0), PlateauTrace(t_filtered, 0, 0))
        assert _bits(float(r2[i])) == _bits(want), (i, r2[i], want)
        assert _bits(float(mean[i])) == _bits(float(np.mean(phots))), i


@pytest.mark.parametrize("T", [7, 100, 128, 129, 1000, 4097])
def test_mean_is_numpys_on_wide_ranging_rows(T):
    """Rows whose values span many magnitudes, where any other order of
    summation rounds differently."""
    rng = np.random.default_rng(T)
    phot = (rng.standard_normal((200, T)) *
            10.0 ** rng.uniform(-3, 9, (200, T)))
    one = (np.ones(200, np.int32), np.zeros((200, 1), np.int32),
           np.full((200, 1), T - 1, np.int32), phot.mean(axis=1)[:, None])
    r2, mean, codes = timetrace_csv.r_squared(phot, one)
    assert not codes.any()
    for i, row in enumerate(phot.tolist()):
        assert _bits(float(mean[i])) == _bits(float(np.mean(row))), i
        fit = PlateauTrace([(0, T - 1, float(one[3][i, 0]))], 0, 0)
        want = Trace.coefficient_of_determination(PhotometryTrace(row, 0, 0),
                                                  fit)
        assert _bits(float(r2[i])) == _bits(want), i


# ---------------------------------------------------------------------------
# The file, byte for byte
# ---------------------------------------------------------------------------

CASES = [(1, 7, 0, 0), (1, 100, 3, 1), (37, 7, 3, 1), (37, 100, 0, 1),
         (37, 128, 3, 0), (37, 129, 0, 1), (37, 129, 3, 1)]
FLAGS = [(True, True), (True, None), (False, True), (False, None),
         (True, ["t_filtered_plateaus", "ck_filtered_photometries"]),
         (False, ["plateaus", "plateaus"])]


@pytest.mark.parametrize("N,T,mirror_start,chung_kennedy", CASES)
def test_file_equals_the_class_methods(N, T, mirror_start, chung_kennedy,
                                       tmp_path):
    fits = fits_of(N, T, mirror_start, chung_kennedy)
    h0, w0 = start_keys(N, seed=T)
    for steps, inter in FLAGS:
        want = tmp_path / "class.csv"
        rows = class_csv(str(want), h0, w0, fits, steps, inter)
        for threads in (1, 5):
            got = tmp_path / f"native_{threads}.csv"
            assert timetrace_csv.write(
                str(got), h0, w0, fits, include_step_fits=steps,
                include_intermediates=inter, n_threads=threads) == rows
            assert got.read_bytes() == want.read_bytes(), (steps, inter,
                                                           threads)


@pytest.mark.parametrize("T,mirror_start", [(100, 0), (129, 3)])
def test_file_equals_the_class_methods_at_the_cells_trace_count(
        T, mirror_start, tmp_path):
    """744 traces, as many as the benchmark's movie tracks, on one thread
    and on many."""
    fits = fits_of(744, T, mirror_start, 1)
    h0, w0 = start_keys(744, seed=T)
    want = tmp_path / "class.csv"
    rows = class_csv(str(want), h0, w0, fits, True, True)
    assert rows == 744 * T + 1
    for threads in (1, 16):
        got = tmp_path / f"native_{threads}.csv"
        assert timetrace_csv.write(str(got), h0, w0, fits,
                                   include_step_fits=True,
                                   include_intermediates=True,
                                   n_threads=threads) == rows
        assert got.read_bytes() == want.read_bytes(), threads


def test_a_long_file_is_written_in_rounds_that_continue_it(tmp_path):
    """5,328 traces of 100 frames are more rows than the core formats at a
    time: every trace's rows are its rows when written alone, under its
    own number, in order."""
    small = fits_of(37, 100, 0, 1)
    reps = 144
    n, s, e, h = small.t_filtered
    rn, rs, re_, rh = small.refit
    big = StepfitArrays(
        np.tile(small.phot, (reps, 1)), np.tile(small.ck, (reps, 1)),
        tuple(np.tile(a, (reps,) + (1,) * (a.ndim - 1))
              for a in (rn, rs, re_, rh)),
        tuple(np.tile(a, (reps,) + (1,) * (a.ndim - 1))
              for a in (n, s, e, h)))
    h0, w0 = start_keys(37, seed=5)
    H, W = np.tile(h0, reps), np.tile(w0, reps)
    path = tmp_path / "big.csv"
    assert timetrace_csv.write(str(path), H, W, big, include_step_fits=True,
                               include_intermediates=True,
                               n_threads=4) == 37 * reps * 100 + 1
    one = tmp_path / "one.csv"
    timetrace_csv.write(str(one), h0, w0, small, include_step_fits=True,
                        include_intermediates=True, n_threads=1)
    lines = path.read_bytes().split(b"\r\n")
    alone = one.read_bytes().split(b"\r\n")
    assert lines[0] == alone[0] and lines[-1] == alone[-1] == b""
    body, alone = lines[1:-1], alone[1:-1]
    assert len(body) == 37 * reps * 100
    for rep in (0, 1, 141, 142, 143):      # rounds end inside rep 141
        for k, row in enumerate(alone):
            t, rest = row.split(b",", 1)
            got = body[rep * 3700 + k]
            assert got == str(rep * 37 + int(t)).encode() + b"," + rest


def test_no_traces_writes_the_header_alone(tmp_path):
    fits = stepfit_arrays(np.zeros((0, 12)))
    for steps in (True, False):
        want, got = tmp_path / "class.csv", tmp_path / "native.csv"
        TimetraceExperiment(
            frames=[None] * 12, spot_traces=[], step_fits={},
            step_fit_intermediates={}).save_experiment_as_csv(
                str(want), include_step_fits=steps,
                include_intermediates=["photometries"])
        assert timetrace_csv.write(
            str(got), np.zeros(0, np.int64), np.zeros(0, np.int64), fits,
            include_step_fits=steps,
            include_intermediates=["photometries"]) == 1
        assert got.read_bytes() == want.read_bytes()


# ---------------------------------------------------------------------------
# Where the class method raises, so does the writer
# ---------------------------------------------------------------------------

def _with_plateaus(fits, row, plateaus):
    """``fits`` with row ``row``'s t-filtered plateaus replaced."""
    n, s, e, h = (a.copy() for a in fits.t_filtered)
    width = max(s.shape[1], len(plateaus))
    s, e, h = (np.pad(a, ((0, 0), (0, width - a.shape[1]))) for a in (s, e, h))
    n[row] = len(plateaus)
    for k, (a, b, v) in enumerate(plateaus):
        s[row, k], e[row, k], h[row, k] = a, b, v
    return fits._replace(t_filtered=(n, s, e, h))


def _raises_alike(fits, h0, w0, tmp_path, **kw):
    with pytest.raises(Exception) as want:
        class_csv(str(tmp_path / "class.csv"), h0, w0, fits, **kw)
    with pytest.raises(Exception) as got:
        timetrace_csv.write(str(tmp_path / "native.csv"), h0, w0, fits,
                            n_threads=3, **kw)
    assert type(got.value) is type(want.value), (got.value, want.value)
    return want.value


def test_a_constant_trace_raises_zero_division(tmp_path):
    phot = bleaching_traces(9, 30, seed=1)
    phot[4] = 1234.5
    fits = stepfit_arrays(phot, chung_kennedy=1, device="cpu", n_threads=1)
    h0, w0 = start_keys(9, seed=1)
    err = _raises_alike(fits, h0, w0, tmp_path, include_step_fits=True,
                        include_intermediates=True)
    assert isinstance(err, ZeroDivisionError)
    _, _, codes = timetrace_csv.r_squared(fits.phot, fits.t_filtered)
    assert codes.tolist() == [0, 0, 0, 0, 5, 0, 0, 0, 0]


@pytest.mark.parametrize("plateaus,kind", [
    ([(2, 29, 10.0)], TypeError),                    # frame 0 in none
    ([(0, 9, 10.0), (12, 29, 5.0)], ValueError),     # frames 10-11 in none
    ([(0, 9, 10.0), (10, 20, 5.0)], Exception),      # ends before the trace
])
def test_plateaus_that_miss_a_frame_raise_as_the_class_method(
        plateaus, kind, tmp_path):
    fits = _with_plateaus(
        stepfit_arrays(bleaching_traces(6, 30, seed=2), chung_kennedy=1,
                       device="cpu", n_threads=1), 3, plateaus)
    h0, w0 = start_keys(6, seed=2)
    err = _raises_alike(fits, h0, w0, tmp_path, include_step_fits=True,
                        include_intermediates=True)
    assert type(err) is kind


def test_an_unknown_intermediate_raises_key_error(tmp_path):
    fits = fits_of(1, 7, 0, 0)
    h0, w0 = start_keys(1, seed=0)
    err = _raises_alike(fits, h0, w0, tmp_path, include_step_fits=False,
                        include_intermediates=["photometries", "heights"])
    assert isinstance(err, KeyError) and err.args == ("heights",)


def test_arrays_are_validated(tmp_path):
    fits = fits_of(1, 7, 0, 0)
    path = str(tmp_path / "x.csv")
    with pytest.raises(ValueError, match="integer start keys"):
        timetrace_csv.write(path, np.array([1.0]), np.array([2.0]), fits)
    with pytest.raises(ValueError, match="CK traces"):
        timetrace_csv.write(path, np.array([1]), np.array([2]),
                            fits._replace(ck=fits.ck[:, :3]))
    n, s, e, h = fits.refit
    with pytest.raises(ValueError, match="plateaus must be"):
        timetrace_csv.write(path, np.array([1]), np.array([2]),
                            fits._replace(refit=(n + 50, s, e, h)))
    assert isinstance(fits, StepfitArrays)
