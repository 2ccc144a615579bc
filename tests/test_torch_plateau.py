"""The port's batched plateau fitter against the JAX package's and the host
``_plateau_fit``, on the CPU.

``ops/plateau_batch.py`` keeps the JAX package's segmentation tables, host
scorer, selection replay and output formatting (tests/test_torch_import.py
holds them equal by AST); its device scorer is two torch matrix products,
float64 by default. Stated tolerances:

- ``scores="exact"``: the output of ``plateau_fit_batched`` and
  ``all_plateau_fits_batched`` equals the JAX package's bit for bit, and
  the host ``_plateau_fit``'s, ties and rejections included;
- ``scores="device"`` in float64: R^2 within 1e-12 of the exact scores
  and of the JAX device scorer's (x64, as the suite runs JAX), the
  downstep flags equal on every trace that is not constant (a constant
  trace's segment means tie, and its flags are rounding in both
  packages' device scorers), and the selections equal on these seeds
  (the sums run in another order than the host's, so only segmentations
  tied to the last ulp could select differently);
- float32 (the JAX package's production TPU configuration): scores within
  1e-5 of the exact ones on raw-magnitude traces (rows are mean-centred on
  the host first) and selections equal on non-tied data.
"""

import functools

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_tpu.inference.photometries import (
    _all_plateau_fits, _plateau_fit)
from fluorosequencingimageanalysis_tpu.ops import plateau_batch as jax_pb

from fluorosequencingimageanalysis_torch.inference import (
    photometries as port_phot)
from fluorosequencingimageanalysis_torch.ops import plateau_batch as pb

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

FLAGS = [{}, {"downsteps_only": True}, {"use_adjusted_r_2": True},
         {"original_intensities_only": False},
         {"include_original_intensities": True,
          "original_intensities_only": False},
         {"delta_r_2": 0.0}, {"delta_r_2": 0.3}]
R2_TOL = 1e-12


def _traces(n=30, t=8, seed=0):
    rng = np.random.default_rng(seed)
    levels = np.where(np.arange(t) < 3, 50000.0,
                      np.where(np.arange(t) < 6, 25000.0, 1000.0))
    x = levels[None] + rng.normal(0, 800, (n, t))
    x[min(5, n - 1)] = 7.0  # constant trace exercises the special case
    return x


def _selections(fits):
    return [(None if f is None else [len(p) for p in f]) for f, _ in fits]


@pytest.mark.parametrize("kwargs", FLAGS)
def test_plateau_fit_batched_exact_equals_the_jax_package_and_the_host(
        kwargs):
    x = _traces()
    got = pb.plateau_fit_batched(x, max_num_drops=3, **kwargs)
    assert got == jax_pb.plateau_fit_batched(x, max_num_drops=3, **kwargs)
    for i in range(x.shape[0]):
        want = _plateau_fit(list(x[i]), max_num_drops=3, **kwargs)
        assert got[i] == want, (i, kwargs)
        assert port_phot._plateau_fit(list(x[i]), max_num_drops=3,
                                      **kwargs) == want


@pytest.mark.parametrize("kwargs", FLAGS)
def test_plateau_fit_batched_device_scores_select_like_the_host(kwargs):
    x = _traces(seed=1)
    exact = pb.plateau_fit_batched(x, max_num_drops=3, **kwargs)
    got = pb.plateau_fit_batched(x, max_num_drops=3, scores="device",
                                 device="cpu", **kwargs)
    want = jax_pb.plateau_fit_batched(x, max_num_drops=3, scores="device",
                                      **kwargs)
    assert _selections(got) == _selections(exact) == _selections(want)
    for (gf, gr), (ef, er), (wf, wr) in zip(got, exact, want):
        assert gf == ef
        assert abs(gr - er) <= R2_TOL and abs(gr - wr) <= R2_TOL


@pytest.mark.parametrize("T,drops,seed", [(8, 3, 2), (7, 2, 3), (12, 3, 4),
                                          (5, 1, 5)])
def test_scorers_equal_the_jax_packages(T, drops, seed):
    x = _traces(n=40, t=T, seed=seed)
    exact = pb._all_scores(x, T, drops, "exact")
    want = jax_pb._all_scores(x, T, drops, "exact")
    for a, b in zip(exact, want):
        np.testing.assert_array_equal(a, b)
    dev = pb._all_scores(x, T, drops, "device", chunk=16, device="cpu")
    jdev = jax_pb._all_scores(x, T, drops, "device", chunk=16)
    np.testing.assert_array_equal(dev[1], exact[1])
    # A constant trace's segment means tie exactly on the host and to the
    # last ulp on a device, so its downstep flags are rounding; its R^2 is
    # 0/0 on the host, and the device forces the single plateau's to 0
    # (the selection treats a constant trace on its own).
    varied = x.min(axis=1) < x.max(axis=1)
    np.testing.assert_array_equal(dev[2][varied], exact[2][varied])
    np.testing.assert_array_equal(dev[2][varied], jdev[2][varied])
    finite = np.isfinite(exact[0])
    np.testing.assert_array_equal(np.isfinite(dev[0])[varied],
                                  finite[varied])
    assert np.abs(dev[0] - exact[0])[finite].max() <= R2_TOL
    assert np.abs(dev[0] - jdev[0])[finite].max() <= R2_TOL
    assert dev[0].dtype == np.float64
    combos, _ = pb._segmentations(T, drops)
    single = [c for c, starts in enumerate(combos) if len(starts) == 1]
    assert (dev[0][:, single][finite[:, single]] == 0.0).all()
    assert pb._segmentations(T, drops)[0] == \
        jax_pb._segmentations(T, drops)[0]
    for a, b in zip(pb._combo_structure(T, drops),
                    jax_pb._combo_structure(T, drops)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="scores"):
        pb._all_scores(x, T, drops, "fast")


def test_all_plateau_fits_batched_equals_the_jax_package_and_the_host():
    x = _traces(n=10, t=7)
    for scores in ("exact", "device"):
        got = pb.all_plateau_fits_batched(x, max_num_drops=2,
                                          storage_r_2_cutoff=0.7,
                                          scores=scores, device="cpu")
        want = jax_pb.all_plateau_fits_batched(
            x, max_num_drops=2, storage_r_2_cutoff=0.7, scores=scores)
        for i in range(x.shape[0]):
            host = _all_plateau_fits(list(x[i]), max_num_drops=2,
                                     storage_r_2_cutoff=0.7)
            if scores == "exact":
                assert got[i] == want[i] == host, i
                continue
            assert [f for f, _, _ in got[i]] == [f for f, _, _ in host]
            for (_, r, a), (_, hr, ha) in zip(got[i], host):
                assert abs(r - hr) <= R2_TOL and abs(a - ha) <= 1e-11


def test_exact_scoring_matches_host_on_ties_and_rejections():
    rows = [
        [0.0, 3.0, 0.0, 2.8, 1.6, 0.0],
        [1.0, 3.0, 0.0, 0.0, 2.0, 8.4, 0.0],
        [5.0, 5.0, 1.0, 1.0, 3.0, 3.0, 0.0],  # integer plateaus: many ties
        [2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 0.0],
    ]
    for kwargs in ({"max_num_drops": 1},
                   {"max_num_drops": 3, "use_adjusted_r_2": True},
                   {"max_num_drops": 2, "downsteps_only": True}):
        for i, row in enumerate(rows):
            got = pb.plateau_fit_batched(np.asarray([row]), **kwargs)
            host = _plateau_fit(tuple(row), **kwargs)
            assert got == jax_pb.plateau_fit_batched(np.asarray([row]),
                                                     **kwargs)
            assert got[0][0] == host[0], (i, kwargs)
            assert got[0][1] == host[1] or (
                np.isnan(got[0][1]) and np.isnan(host[1])), (i, kwargs)
    # Every combo rejected: the host's TypeError when a formatting flag
    # iterates the None fit, and (None, -1) with both flags off.
    bad = np.asarray([[0.0, 1.0, 2.0]])
    reject_kw = dict(max_num_drops=1, use_adjusted_r_2=True,
                     downsteps_only=True)
    for scores in ("exact", "device"):
        with pytest.raises(TypeError):
            pb.plateau_fit_batched(bad, scores=scores, device="cpu",
                                   **reject_kw)
        got = pb.plateau_fit_batched(bad, original_intensities_only=False,
                                     scores=scores, device="cpu",
                                     **reject_kw)
        assert got[0] == (None, -1)
    with pytest.raises(Exception):
        pb.plateau_fit_batched(bad, 1, include_original_intensities=True)


def test_device_scoring_float32_configuration(monkeypatch):
    """float32 on the device, as the JAX package's production TPU
    configuration scored: with host-side float64 row centring the scores
    stay within 1e-5 of the exact ones at raw photometry magnitudes, and
    the selections equal the host's on non-tied data."""
    rng = np.random.default_rng(7)
    T = 8
    levels = rng.integers(1, 4, 32)
    x = np.empty((32, T))
    for i in range(32):
        drop = rng.integers(2, T - 1)
        x[i, :drop] = 30000.0 * levels[i]
        x[i, drop:] = 30000.0 * (levels[i] - 1)
        x[i] += rng.normal(0, 400.0, T)
    exact, _, ok_e = pb._all_scores(x, T, 2, "exact")
    for dtype in (np.float32, torch.float32):
        f32, _, ok_32 = pb._all_scores(x, T, 2, "device", dtype=dtype,
                                       device="cpu")
        jf32, _, _ = jax_pb._all_scores(x, T, 2, "device", dtype=np.float32)
        finite = np.isfinite(exact)
        assert np.abs(f32 - exact)[finite].max() < 1e-5
        assert np.abs(f32 - jf32)[finite].max() < 1e-5
        assert (ok_e == ok_32).all()
    host_fits = pb.plateau_fit_batched(x, 2, scores="exact")
    monkeypatch.setattr(pb, "_all_scores", functools.partial(
        pb._all_scores, dtype=torch.float32))
    dev_fits = pb.plateau_fit_batched(x, 2, scores="device", device="cpu")
    for (hf, hr), (df, dr) in zip(host_fits, dev_fits):
        assert hf == df
        assert abs(hr - dr) < 1e-5
