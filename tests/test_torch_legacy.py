"""The port's legacy lognormal fitters (v1-v7, the nearest-neighbour fitter
and their serial _MP drivers) against the JAX package's, on the CPU.

``inference/lognormal_legacy.py`` is a copy of the JAX package's host
numpy/scipy module (tests/test_torch_import.py holds the two equal by
AST); here both run on the inputs of tests/test_legacy_fitters.py and on
a few more seeded traces, and every result must be equal: the same
sequences, signals, scores and dicts, float for float.
"""

import math

import numpy as np
import pytest

from fluorosequencingimageanalysis_tpu.inference import (
    lognormal_legacy as jax_legacy)

from fluorosequencingimageanalysis_torch.inference import (
    lognormal_legacy as legacy)

BETA, ALPHA, GAMMA = 30000.0, 1000.0, 8000.0
BETA_SIGMA, ALPHA_SIGMA = 0.2, 2000.0
SEQS = [(1, 1, 0, 0), (2, 1, 1, 0), (1, 1, 1, 0), (1, 0, 0), (2, 1, 0),
        (3, 2, 1, 0), (0, 0, 0), (2, 2, 2, 2)]


def _trace(rng, seq, beta=BETA, alpha=0.0):
    return [float(rng.lognormal(math.log(beta) + math.log(v), BETA_SIGMA))
            + alpha if v > 0 else alpha + float(rng.normal(0, 500))
            for v in seq]


def _traces(seed, alpha=0.0, beta=BETA):
    rng = np.random.default_rng(seed)
    return [(seq, _trace(rng, seq, beta=beta, alpha=alpha)) for seq in SEQS]


def _photometries(seed, alpha=ALPHA, n=12, beta=BETA):
    rng = np.random.default_rng(seed)
    phot = {"ch1": {0: {}, 1: {}}}
    for t in range(n):
        seq = SEQS[t % len(SEQS)]
        phot["ch1"][t % 2][(t, 0)] = (tuple(v > 0 for v in seq),
                                      tuple(_trace(rng, seq, beta=beta,
                                                   alpha=alpha)),
                                      t)
    return phot


def _both(name, *args, **kwargs):
    got = getattr(legacy, name)(*args, **kwargs)
    want = getattr(jax_legacy, name)(*args, **kwargs)
    return got, want


@pytest.mark.parametrize("allow_multidrop", [False, True])
def test_v1_equals_the_jax_packages(allow_multidrop):
    for seq, ints in _traces(0, beta=60000.0):
        got, want = _both("_intensities_to_signal_lognormal", ints,
                          mu_zero=0, sigma_zero=2000, mu_one=60000,
                          allow_multidrop=allow_multidrop)
        assert got == want, seq
    got, want = _both("_photometries_lognormal_fit_MP", _photometries(1),
                      mu_zero=ALPHA, sigma_zero=2000, mu_one=BETA + ALPHA)
    assert got == want
    with pytest.raises(NotImplementedError):
        legacy._per_cycle_intensities_to_signal_lognormal([1.0], {})
    with pytest.raises(NotImplementedError):
        legacy._photometries_lognormal_fit_MP({}, per_cycle_parameters={})


@pytest.mark.parametrize("kw", [{}, {"allow_multidrop": True},
                                {"allow_upsteps": True},
                                {"allow_upsteps": True,
                                 "upstep_rapid_classify": False}])
def test_v2_equals_the_jax_packages(kw):
    for seq, ints in _traces(2, alpha=ALPHA):
        got, want = _both("_intensities_to_signal_lognormal_v2", ints,
                          ALPHA, BETA + ALPHA, GAMMA + ALPHA, **kw)
        assert got == want, seq
    got, want = _both("_photometries_lognormal_fit_MP_v2", _photometries(3),
                      ALPHA, BETA + ALPHA, GAMMA + ALPHA, max_possible=5,
                      **kw)
    assert got == want


def test_nearest_neighbor_equals_the_jax_packages():
    for seq, ints in _traces(4, alpha=ALPHA):
        got, want = _both("_lognormal_nearest_neighbor", ints, ALPHA,
                          BETA + ALPHA, GAMMA + ALPHA)
        assert got == want, seq
    rng = np.random.default_rng(4)
    ints = _trace(rng, (2, 1, 0), alpha=ALPHA)
    signal, is_zero, nn = legacy._lognormal_nearest_neighbor(
        ints, ALPHA, BETA + ALPHA, GAMMA + ALPHA)
    assert nn == [2, 1, 0] and signal == (("A", 1), ("A", 2)) and is_zero
    got, want = _both("_lognormal_nearest_neighbor_MP", _photometries(5),
                      ALPHA, BETA + ALPHA, GAMMA + ALPHA, max_possible=6)
    assert got == want


@pytest.mark.parametrize("version", ["v3", "v4", "v5"])
@pytest.mark.parametrize("kw", [{}, {"allow_multidrop": True},
                                {"allow_upsteps": True}])
def test_v3_to_v5_equal_the_jax_packages(version, kw):
    extra = {"v5": {"quench_factor": 0.1, "max_deviation": 4}}.get(version,
                                                                   {})
    fit = "_intensities_to_signal_lognormal_" + version
    alpha = ALPHA if version == "v3" else 0.0
    for seq, ints in _traces(6, alpha=alpha):
        a, b, g = ((ALPHA, BETA + ALPHA, GAMMA + ALPHA) if version == "v3"
                   else (0.0, BETA, GAMMA))
        got, want = _both(fit, ints, a, b, g, ALPHA_SIGMA, BETA_SIGMA,
                          **kw, **extra)
        assert got == want, seq
    if version == "v5":
        assert legacy._quench_tables(BETA, 0.1, 5) == \
            jax_legacy._quench_tables(BETA, 0.1, 5)
    got, want = _both("_photometries_lognormal_fit_MP_" + version,
                      _photometries(7, alpha=alpha), alpha, BETA + alpha,
                      GAMMA + alpha, ALPHA_SIGMA, BETA_SIGMA, **kw, **extra)
    assert got == want


@pytest.fixture(scope="module")
def deltas():
    """_find_deltas of both packages at the test's beta (a scan of ~17,000
    scipy pdfs each: computed once)."""
    return _both("_find_deltas", ALPHA_SIGMA, BETA, BETA_SIGMA,
                 gamma_score=0.05)


def test_find_deltas_equals_the_jax_packages(deltas):
    got, want = deltas
    assert got == want
    d0, d1 = got
    assert d0 is not None and 0 < d0 <= d1 <= BETA
    # A smaller beta ends the scan sooner; the same values either way.
    assert _both("_find_deltas", 200.0, 3000.0, 0.3, gamma_score=0.2)[0] \
        == jax_legacy._find_deltas(200.0, 3000.0, 0.3, gamma_score=0.2)


@pytest.mark.parametrize("gamma_score", [0.05, 0.2])
def test_v6_equals_the_jax_packages(deltas, gamma_score):
    for seq, ints in _traces(8):
        for d in (None, deltas[0]):
            got, want = _both("_intensities_to_signal_lognormal_v6", ints,
                              0.0, BETA, GAMMA, ALPHA_SIGMA, BETA_SIGMA,
                              deltas=d, gamma_score=gamma_score)
            assert got == want, (seq, d)
    # The driver computes its own deltas: at beta 3,000 the scan is short.
    phot = _photometries(9, alpha=0.0, beta=3000.0)
    got, want = _both("_photometries_lognormal_fit_MP_v6", phot, 0.0, 3000.0,
                      800.0, 200.0, BETA_SIGMA, gamma_score=gamma_score)
    assert got == want


@pytest.mark.parametrize("kw", [{}, {"allow_multidrop": True},
                                {"quench_factor": 0.1}])
def test_v7_equals_the_jax_packages(kw):
    for seq, ints in _traces(10):
        cats = tuple(v > 0 for v in seq)
        got, want = _both("_intensities_to_signal_lognormal_v7", ints, 0.0,
                          BETA, GAMMA, ALPHA_SIGMA, BETA_SIGMA,
                          categories=cats, **kw)
        assert got == want, seq
    rng = np.random.default_rng(2)
    seq = (1, 1, 1, 0)
    adj = [i - ALPHA for i in _trace(rng, seq, alpha=ALPHA)]
    out = legacy._intensities_to_signal_lognormal_v7(
        adj, 0.0, BETA, GAMMA, ALPHA_SIGMA, BETA_SIGMA, categories=(
            True, True, True, False))
    assert out[2] == seq and out[0] == (("A", 3),)
    phot = _photometries(11, alpha=0.0, beta=3000.0)
    got, want = _both("_photometries_lognormal_fit_MP_v7", phot, 0.0, 3000.0,
                      800.0, 200.0, BETA_SIGMA, gamma_score=0.2, **kw)
    assert got == want
    with pytest.raises(ValueError, match="categories"):
        legacy._intensities_to_signal_lognormal_v7(
            adj, 0.0, BETA, GAMMA, ALPHA_SIGMA, BETA_SIGMA)
    with pytest.raises(DeprecationWarning):
        legacy._intensities_to_signal_lognormal_v7(
            adj, 0.0, BETA, GAMMA, ALPHA_SIGMA, BETA_SIGMA, deltas=(1, 2),
            categories=(True,) * 4)


def test_the_mp_drivers_refuse_several_channels_like_the_jax_packages():
    two = {"ch1": {}, "ch2": {}}
    for name, args in (("_photometries_lognormal_fit_MP", ()),
                       ("_photometries_lognormal_fit_MP_v2",
                        (ALPHA, BETA, GAMMA))):
        with pytest.raises(NotImplementedError, match="channels"):
            getattr(legacy, name)(two, *args)
        with pytest.raises(NotImplementedError, match="channels"):
            getattr(jax_legacy, name)(two, *args)
