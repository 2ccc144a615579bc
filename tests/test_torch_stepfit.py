"""The port's step fitting against the JAX package's, on the CPU.

The same numpy-seeded traces go through the JAX functions (float64 here:
``tests/conftest.py`` turns x64 on) and the port's. Stated tolerances:

- ``betainc`` vs ``scipy.special.betainc``: 1e-12 in float64, 1e-5 in
  float32 (absolute; the values lie in [0, 1]);
- Chung-Kennedy traces: atol 1e-9 + rtol 1e-12 on float64 input (the two
  cumulative sums associate differently: last-bit differences at
  photometry magnitudes of 1e5), rtol 1e-4 on float32;
- step masks: equal, except where the host chain's p-value lies within
  1e-9 (float64) or 1e-4 (float32) relative of the threshold; 1e-3 for
  the float32 detector on the smooth Chung-Kennedy trace, whose window
  variances are small against its cumulative sums;
- plateau lists: starts and stops equal, heights within 1e-9 relative;
- chi-squared fits: equal to the host oracle exactly.
"""

import numpy as np
import pytest
import scipy.special
import torch

import jax.numpy as jnp
from fluorosequencingimageanalysis_tpu import api as jax_api
from fluorosequencingimageanalysis_tpu import config as jax_config
from fluorosequencingimageanalysis_tpu import stepfitting as jax_sf
from fluorosequencingimageanalysis_tpu.ops import stepfit_batch as jax_sb

from fluorosequencingimageanalysis_torch import stepfitting as sf
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.config import (PipelineConfig,
                                                        StepfitConfig)
from fluorosequencingimageanalysis_torch.native import stepchain
from fluorosequencingimageanalysis_torch.ops import stepfit_batch as sb
from fluorosequencingimageanalysis_torch.ops.special import betainc
from fluorosequencingimageanalysis_torch.utils import profiling, synth

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32)}


def _step_traces(rng, n=5, t=40, noise=800.0):
    levels = np.where(np.arange(t) < 15, 60000.0,
                      np.where(np.arange(t) < 28, 30000.0, 1000.0))
    return levels[None] + rng.normal(0, noise, (n, t))


def _same_plateaus(got, want):
    assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in want]
    np.testing.assert_allclose([h for _, _, h in got],
                               [h for _, _, h in want], rtol=1e-9)


# ---------------------------------------------------------------------------
# betainc
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_betainc_matches_scipy(dtype, tol):
    np_dt, t_dt = DTYPES[dtype]
    df = np.concatenate([np.arange(1, 61, dtype=np.float64),
                         [1.5, 2.25, 7.75, 33.3]])
    x = np.concatenate([[0.0, 1.0, 1e-12, 1e-6, 1 - 1e-6],
                        np.linspace(0, 1, 41)])
    a, xx = (g.astype(np_dt) for g in np.meshgrid(df / 2.0, x,
                                                  indexing="ij"))
    got = betainc(torch.from_numpy(a), 0.5, torch.from_numpy(xx))
    assert got.dtype == t_dt and got.shape == a.shape
    want = scipy.special.betainc(a.astype(np.float64), 0.5,
                                 xx.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert got[:, 0].eq(0).all() and got[:, 1].eq(1).all()
    # The general function, both arguments tensors, and the reflection.
    rng = np.random.default_rng(0)
    a = rng.uniform(0.3, 40, 500).astype(np_dt)
    b = rng.uniform(0.3, 40, 500).astype(np_dt)
    xx = rng.uniform(0, 1, 500).astype(np_dt)
    got = betainc(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(xx)).numpy()
    want = scipy.special.betainc(a.astype(np.float64), b.astype(np.float64),
                                 xx.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=0, atol=10 * tol)


def test_betainc_propagates_nan_and_reads_nothing_back():
    x = torch.tensor([0.2, float("nan"), 0.7], dtype=torch.float64)
    got = betainc(torch.tensor([2.0, 2.0, float("nan")],
                               dtype=torch.float64), 0.5, x)
    assert torch.isfinite(got[0]) and torch.isnan(got[1:]).all()
    # A meta tensor has no data: any host read inside the loop raises.
    meta = torch.ones(7, dtype=torch.float64, device="meta")
    assert betainc(meta, 0.5, meta * 0.5).shape == (7,)
    assert betainc(3.0, 0.5, torch.tensor(0.25)).dtype == torch.float32


# ---------------------------------------------------------------------------
# Chung-Kennedy and the sliding-t masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chung_kennedy_batch_matches_jax_and_host(dtype):
    np_dt, t_dt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    for t in (20, 40, 61):
        traces = (rng.normal(0, 1, (3, t)) + np.where(
            np.arange(t) < t // 2, 10.0, 4.0)).astype(np_dt)
        got = sb.chung_kennedy_batch(torch.from_numpy(traces))
        assert got.dtype == t_dt
        want = np.asarray(jax_sb.chung_kennedy_batch(jnp.asarray(traces)))
        assert want.dtype == np_dt
        if dtype == "float64":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=1e-9)
            for i in range(traces.shape[0]):
                ref = sf.chung_kennedy_filter(list(traces[i]),
                                              window_lengths=(2, 4, 8, 16))
                np.testing.assert_allclose(got[i].numpy(), ref, atol=1e-9)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def test_chung_kennedy_batch_needs_more_than_two_frames():
    for t in (1, 2):
        with pytest.raises(ValueError, match="len\\(luminosities\\) > 2"):
            sb.chung_kennedy_batch(torch.zeros((3, t), dtype=torch.float64))
        with pytest.raises(ValueError, match="len\\(luminosities\\) > 2"):
            jax_sb.chung_kennedy_batch(np.zeros((3, t)))
    assert sb.chung_kennedy_batch(torch.ones((2, 3))).shape == (2, 3)


def _host_p(seq, f, radius):
    """The host chain's p-value of frame f (NaN for a short left window)."""
    if f < radius:
        return float("nan")
    return jax_sf._welch_t(list(seq[f - radius:f]),
                           list(seq[f:f + radius]))[1]


def _assert_masks_equal_away_from_threshold(got, want, traces, radii, thr,
                                            rel):
    """Masks equal, except at elements where some radius's host p-value
    lies within ``rel`` relative of the threshold."""
    assert got.shape == want.shape and got.dtype == want.dtype == bool
    for i, f in zip(*np.nonzero(got != want)):
        seq = traces[i].astype(np.float64)
        ps = [_host_p(seq, f, r) for r in radii]
        assert any(abs(p - thr) <= rel * thr for p in ps), (i, f, ps)


@pytest.mark.parametrize("dtype,rel", [("float64", 1e-9), ("float32", 1e-4)])
def test_sliding_t_masks_match_jax(dtype, rel):
    np_dt, _ = DTYPES[dtype]
    rng = np.random.default_rng(1)
    traces = _step_traces(rng, n=24, t=50, noise=300.0).astype(np_dt)
    for window_radius, thr in ((6, 0.01), (8, 0.001)):
        got = sb.sliding_t_masks(torch.from_numpy(traces),
                                 window_radius=window_radius,
                                 p_threshold=thr).numpy()
        want = np.asarray(jax_sb.sliding_t_masks(
            jnp.asarray(traces), window_radius=window_radius,
            p_threshold=thr))
        assert got.any() and not got[:, :5].any()
        _assert_masks_equal_away_from_threshold(
            got, want, traces, range(5, window_radius), thr, rel)
    # Against the host chain's own Welch test, frame by frame.
    if dtype == "float64":
        got = sb.sliding_t_masks(torch.from_numpy(traces[:4]),
                                 window_radius=6, p_threshold=0.01).numpy()
        for i in range(4):
            expected = [_host_p(traces[i], f, 5) < 0.01 for f in range(50)]
            assert list(got[i]) == expected


def test_sliding_t_masks_degenerate_windows():
    """window_radius <= 5 (no radius at all) gives no step, and windows of
    fewer than 2 samples give NaN (no step): equal to the JAX function. A
    flat trace has zero pooled variance and equal means (NaN p: no step)
    and a noiseless step has zero pooled variance and differing means
    (p = 0: a step): equal to the host chain. (The JAX function centers
    with a reciprocal of the trace length, so on exactly constant windows
    its variances, and with them its p-values, are rounding noise; so
    are both packages' on a constant run away from the trace mean, such as
    a tail of absent frames: ROADMAP.md Queue 3.)"""
    rng = np.random.default_rng(7)
    levels = np.where(np.arange(40) < 18, 50000.0, 2000.0)
    noisy = levels[None] + rng.normal(0, 400, (8, 40))
    tails = np.concatenate([noisy[:2, :30], np.full((2, 10), 0.0)], axis=1)
    for traces in (noisy, tails[:, :33], noisy[:, :7]):
        for window_radius in (5, 3, 6, 7):
            got = sb.sliding_t_masks(torch.from_numpy(traces),
                                     window_radius=window_radius,
                                     p_threshold=0.01).numpy()
            want = np.asarray(jax_sb.sliding_t_masks(
                traces, window_radius=window_radius, p_threshold=0.01))
            np.testing.assert_array_equal(got, want)
            if window_radius <= 5:
                assert not got.any()
    for traces in (np.full((3, 40), 5.0), np.full((3, 40), 777.25),
                   np.tile(levels, (2, 1))):
        got = sb.sliding_t_masks(torch.from_numpy(traces), window_radius=7,
                                 p_threshold=0.01).numpy()
        host = np.array([[all(_host_p(seq, f, r) < 0.01 for r in (5, 6))
                          for f in range(40)] for seq in traces])
        np.testing.assert_array_equal(got, host)
    step = sb.sliding_t_masks(torch.from_numpy(np.tile(levels, (2, 1))),
                              p_threshold=0.01).numpy()
    assert step[:, 18].all() and not step[:, :14].any()


def test_welch_p_special_values_match_jax():
    """denom == 0 gives p = 0 for differing means and NaN for equal ones;
    fewer than 2 samples on either side gives NaN; NaN < threshold is
    False."""
    mean_l = np.array([1.0, 1.0, 1.0, 3.0, 2.0, 0.5])
    mean_r = np.array([2.0, 1.0, 2.0, 1.0, 2.5, 0.5])
    var_l = np.array([0.0, 0.0, 1.0, 2.0, 0.5, 0.3])
    var_r = np.array([0.0, 0.0, 1.0, 0.0, 0.25, 0.3])
    n_l = np.array([5.0, 5.0, 1.0, 5.0, 5.0, 5.0])
    n_r = np.array([5.0, 5.0, 5.0, 5.0, 3.0, 1.0])
    args = (mean_l, var_l, n_l, mean_r, var_r, n_r)
    got = sb._welch_p(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(jax_sb._welch_p(*(jnp.asarray(a) for a in args)))
    assert got[0] == 0.0 and np.isnan(got[[1, 2, 5]]).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, equal_nan=True)
    assert not (torch.from_numpy(got) < 0.01)[[1, 2, 5]].any()


def test_sliding_t_masks_float32_high_dc_matches_jax_and_host():
    """At real photometry magnitudes (DC ~6e4, steps ~1e3) an uncentered
    float32 cumulative sum of squares cancels and flips borderline steps;
    centered per trace, the float32 masks equal the float64 host chain's
    on the float32-rounded data."""
    rng = np.random.default_rng(17)
    N, T, radius = 60, 60, 5
    traces = np.full((N, T), 60000.0) + rng.normal(0, 700.0, (N, T))
    traces[:, T // 2:] -= 1200.0  # borderline step at p ~ 0.01
    traces_f32 = traces.astype(np.float32)
    got = sb.sliding_t_masks(torch.from_numpy(traces_f32),
                             window_radius=radius + 1,
                             p_threshold=0.01).numpy()
    want = np.asarray(jax_sb.sliding_t_masks(
        jnp.asarray(traces_f32), window_radius=radius + 1, p_threshold=0.01))
    _assert_masks_equal_away_from_threshold(got, want, traces_f32, [radius],
                                            0.01, 1e-4)
    seq = traces_f32.astype(np.float64)
    host = np.array([[_host_p(seq[i], f, radius) < 0.01 for f in range(T)]
                     for i in range(N)])
    assert 0 < host.sum() < N * T
    _assert_masks_equal_away_from_threshold(got, host, traces_f32, [radius],
                                            0.01, 1e-4)


@pytest.mark.parametrize("dtype,rel", [("float64", 1e-9), ("float32", 1e-3)])
def test_ck_and_masks_match_jax(dtype, rel):
    np_dt, t_dt = DTYPES[dtype]
    # float32 keeps the steps within a few times the noise: with steps of
    # 3e4 the float32 cumulative sum of squares of the smooth CK trace
    # cancels (in both packages) and borderline frames are rounding noise.
    beta = 30000.0 if dtype == "float64" else 3000.0
    traces = synth.make_step_traces(48, 60, seed=3, beta=beta).astype(np_dt)
    ck, masks = sb._ck_and_masks(torch.from_numpy(traces), p_threshold=0.01)
    jck, jmasks = jax_sb._ck_and_masks(jnp.asarray(traces), p_threshold=0.01)
    assert ck.dtype == t_dt and masks.dtype == torch.bool
    if dtype == "float64":
        np.testing.assert_allclose(ck.numpy(), np.asarray(jck), rtol=1e-12,
                                   atol=1e-9)
    else:
        np.testing.assert_allclose(ck.numpy(), np.asarray(jck), rtol=1e-4)
    # The detector reads its own CK trace (the two packages' float32 CK
    # traces differ by rounding), so the masks are held against the JAX
    # detector on the port's CK trace; in float64 also against the JAX
    # function as a whole.
    want = np.asarray(jax_sb.sliding_t_masks(jnp.asarray(ck.numpy()),
                                             p_threshold=0.01))
    _assert_masks_equal_away_from_threshold(
        masks.numpy(), want, ck.numpy(), [5], 0.01, rel)
    if dtype == "float64":
        _assert_masks_equal_away_from_threshold(
            masks.numpy(), np.asarray(jmasks), np.asarray(jck), [5], 0.01,
            rel)
    assert masks.any()
    # Nothing is read back from the device between the two stages.
    meta = torch.ones((4, 30), dtype=t_dt, device="meta")
    assert sb._ck_and_masks(meta)[1].shape == (4, 30)


# ---------------------------------------------------------------------------
# stepfit_batched
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mirror_start,ck_n", [(0, 0), (10, 1), (0, 1),
                                               (10, 0)])
def test_stepfit_batched_matches_jax(mirror_start, ck_n):
    phot = synth.make_step_traces(64, 60, seed=2)
    kw = dict(mirror_start=mirror_start, chung_kennedy=ck_n,
              p_threshold=0.01)
    got = sb.stepfit_batched(phot, device="cpu", n_threads=1, **kw)
    want = jax_sb.stepfit_batched(phot, chunk=64, **kw)
    assert len(got) == len(want) == 64
    for (g_p, g_ck, g_pl, g_t), (w_p, w_ck, w_pl, w_t) in zip(got, want):
        assert g_p == w_p and isinstance(g_p, tuple)
        assert isinstance(g_ck, list) and len(g_ck) == 60
        np.testing.assert_allclose(g_ck, w_ck, rtol=1e-12, atol=1e-9)
        _same_plateaus(g_pl, w_pl)
        _same_plateaus(g_t, w_t)
        assert all(isinstance(a, int) and isinstance(h, float)
                   for a, _, h in g_t)
    assert any(len(t) > 1 for _, _, _, t in got)


def test_stepfit_batched_matches_the_host_chain():
    rng = np.random.default_rng(2)
    phot = _step_traces(rng, n=4, t=40)
    for mirror_start, ck_n in ((0, 0), (5, 1)):
        batched = sb.stepfit_batched(phot, mirror_start=mirror_start,
                                     chung_kennedy=ck_n, p_threshold=0.01,
                                     device="cpu", n_threads=1)
        for i in range(phot.shape[0]):
            photometries = tuple(phot[i].tolist())
            mirrored = sf.mirror_photometries(photometries,
                                              mirror_size=mirror_start)
            ck = mirrored
            for _ in range(ck_n):
                ck = sf.chung_kennedy_filter(luminosities=mirrored,
                                             window_lengths=(2, 4, 8, 16))
            plateaus = sf.sliding_t_fitter(
                luminosity_sequence=ck, window_radius=6, p_threshold=0.01,
                median_filter_size=None, downsteps_only=False,
                min_step_magnitude=None)
            plateaus = sf.refit_plateaus(mirrored, plateaus)
            t_filtered = sf.t_test_filter(
                luminosities=mirrored, plateaus=plateaus, p_threshold=0.01,
                drop_sort=True, no_merge_start=mirror_start)
            b_phot, b_ck, b_pl, b_t = batched[i]
            assert b_phot == photometries
            np.testing.assert_allclose(
                b_ck, sf.unmirror_photometries(ck, mirror_size=mirror_start),
                atol=1e-8)
            _same_plateaus(b_pl, sf.unmirror_plateaus(
                plateaus, mirror_size=mirror_start))
            _same_plateaus(b_t, sf.unmirror_plateaus(
                t_filtered, mirror_size=mirror_start))


def test_stepfit_batched_chunk_invariant_and_staged():
    rng = np.random.default_rng(11)
    phot = _step_traces(rng, n=70, t=40, noise=500.0)
    kw = dict(mirror_start=10, chung_kennedy=1, p_threshold=0.01,
              device="cpu", n_threads=1)
    one = sb.stepfit_batched(phot, **kw)
    profiling.reset_timings()
    profiling.reset_counters()
    many = sb.stepfit_batched(phot, chunk=32, **kw)
    assert len(one) == len(many) == 70
    for (p_a, ck_a, pl_a, t_a), (p_b, ck_b, pl_b, t_b) in zip(one, many):
        assert p_a == p_b and pl_a == pl_b and t_a == t_b
        np.testing.assert_array_equal(ck_a, ck_b)
    assert {"stepfit/upload", "stepfit/ck+masks", "stepfit/fetch",
            "stepfit/postpass", "stepfit/assemble"} <= set(
                profiling.timings())
    c = profiling.counters()
    assert c["ledger/uploads"] == c["ledger/step_dispatches"] == 3
    assert c["ledger/upload_bytes"] == 70 * 50 * 8
    assert c["ledger/result_fetches"] == 6
    assert c["ledger/fetch_bytes"] == 70 * 50 * (8 + 1)


def test_stepfit_batched_empty_input_and_radius_5():
    assert sb.stepfit_batched(np.zeros((0, 30)), mirror_start=5,
                              chung_kennedy=1, p_threshold=0.01,
                              device="cpu") == []
    rng = np.random.default_rng(7)
    levels = np.where(np.arange(40) < 18, 50000.0, 2000.0)
    phot = levels[None] + rng.normal(0, 400, (8, 40))
    results = sb.stepfit_batched(phot, p_threshold=0.01, window_radius=5,
                                 device="cpu", n_threads=1)
    for _, _, plateaus, t_filtered in results:
        assert len(plateaus) == 1 and len(t_filtered) == 1
        assert plateaus[0][:2] == (0, 39)


def test_native_postpass_equals_the_python_oracle():
    """csrc/stepchain.cpp (plateau assembly -> refit -> iterated drop-sort
    Welch-t merge) gives exactly the plateau structures of the host
    chain's functions, on stepping, stepless, inverted, ragged and
    zero-tailed traces."""
    rng = np.random.default_rng(7)
    batteries = [
        _step_traces(rng, n=16, t=60, noise=1200.0),
        rng.normal(5000.0, 400.0, (8, 25)),
        -_step_traces(rng, n=8, t=40, noise=600.0),
        np.concatenate([
            np.where(np.arange(48) < k, 40000.0, 9000.0)[None]
            + rng.normal(0, 900.0, (1, 48)) for k in range(4, 44, 5)]),
        np.concatenate([
            # Absent-frame tails: zero-variance plateau pairs whose Welch p
            # is NaN must merge in the same order on both sides.
            np.where(np.arange(48) < k, 30000.0, 0.0)[None]
            + np.where(np.arange(48) < k, rng.normal(0, 700.0, (1, 48)), 0.0)
            for k in (8, 16, 24, 31)]),
    ]
    mirror = 10
    for phot in batteries:
        mirrored = np.concatenate([phot[:, :mirror][:, ::-1], phot], axis=1)
        ck, masks = (x.numpy() for x in sb._ck_and_masks(
            torch.from_numpy(mirrored), p_threshold=0.01))
        oracle = sb._postpass_python(mirrored, ck, masks, 0.01, mirror)
        native = sb.stepfit_batched(phot, mirror_start=mirror,
                                    chung_kennedy=1, p_threshold=0.01,
                                    device="cpu", n_threads=2)
        for (_, _, pl_n, t_n), (pl_p, t_p) in zip(native, oracle):
            assert [(a, b) for a, b, _ in pl_n] == \
                [(a, b) for a, b, _ in pl_p]
            np.testing.assert_allclose([h for _, _, h in pl_n],
                                       [h for _, _, h in pl_p], rtol=1e-12)
            assert [(a, b) for a, b, _ in t_n] == [(a, b) for a, b, _ in t_p]
            np.testing.assert_allclose([h for _, _, h in t_n],
                                       [h for _, _, h in t_p], rtol=1e-12)


def test_postpass_rejects_a_step_at_frame_0_and_a_misshapen_mask():
    raw = np.random.default_rng(0).normal(1000, 10, (2, 6))
    mask = np.zeros((2, 6), np.uint8)
    mask[1, 0] = 1
    with pytest.raises(ValueError, match="frame 0"):
        stepchain.stepfit_postpass(raw, mask, 0.01, 0, n_threads=1)
    with pytest.raises(ValueError, match="must match"):
        stepchain.stepfit_postpass(raw, mask[:, :5], 0.01, 0, n_threads=1)
    assert 1 <= stepchain.default_threads() <= 16


def test_native_welch_p_matches_the_host_chain():
    rng = np.random.default_rng(5)
    a = [rng.normal(0, 1, n) for n in (5, 9, 2, 30)]
    b = [rng.normal(0.7, 2, n) for n in (7, 3, 2, 11)]
    got = stepchain.welch_p_batch(a, b)
    want = [sf._welch_t(list(x), list(y))[1] for x, y in zip(a, b)]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_pipeline_stepfit_matches_the_jax_packages():
    phot = synth.make_step_traces(48, 100, seed=0)
    kw = dict(mirror_start=10, chung_kennedy=1, p_threshold=0.01)
    profiling.reset_timings()
    got = Pipeline(PipelineConfig(stepfit=StepfitConfig(**kw)), device="cpu",
                   profile=True).stepfit(phot)
    assert "api/stepfit" in profiling.timings()
    want = jax_api.Pipeline(jax_config.PipelineConfig(
        stepfit=jax_config.StepfitConfig(**kw))).stepfit(phot)
    assert len(got) == len(want) == 48
    for (g_p, g_ck, g_pl, g_t), (w_p, w_ck, w_pl, w_t) in zip(got, want):
        assert g_p == w_p
        np.testing.assert_allclose(g_ck, w_ck, rtol=1e-12, atol=1e-9)
        _same_plateaus(g_pl, w_pl)
        _same_plateaus(g_t, w_t)
    # The planted steps come back: most traces have their number of drops.
    _, truth = synth.make_step_traces(48, 100, seed=0, return_truth=True)
    hits = sum(len(t) - 1 == len(d) for (_, _, _, t), d in zip(got, truth))
    assert hits >= 24


# ---------------------------------------------------------------------------
# chi-squared
# ---------------------------------------------------------------------------

def _chisq_traces(rng, n, t):
    """Step traces with noise, plus degenerate rows (constant, one hard
    step, near-tied split candidates)."""
    traces = synth.make_chisq_traces(n, t, seed=int(rng.integers(1 << 30)))
    traces[0] = 777.25                       # constant: span == 0
    half = t // 2
    traces[1] = np.r_[np.full(half, 5000.0), np.full(t - half, 100.0)]
    traces[2, :] = np.round(traces[2] / 500) * 500  # exact ties likely
    return traces


@pytest.mark.parametrize("kwargs", [
    dict(), dict(num_steps=8), dict(num_steps=5, min_step_length=3),
    dict(num_steps=6, min_step_magnitude=900.0),
    dict(num_steps=4, ignore_counterfits=True),
    dict(num_steps_multiplier=0.3)], ids=str)
def test_chi_squared_fit_batch_equals_host_oracle_and_jax(kwargs):
    rng = np.random.default_rng(3)
    N, T = 14, 36
    traces = _chisq_traces(rng, N, T)
    batch = sf.chi_squared_fit_batch(traces, n_threads=1, **kwargs)
    assert batch == sf.chi_squared_fit_batch(traces, n_threads=3,
                                             engine="native", **kwargs)
    assert batch == jax_sf.chi_squared_fit_batch(traces, n_threads=1,
                                                 engine="native", **kwargs)
    for i in range(N):
        oracle = sf.chi_squared_step_fitter(
            tuple(float(v) for v in traces[i]), **kwargs)
        assert batch[i] == [tuple(p) for p in oracle], (i, kwargs)


def test_chi_squared_fit_batch_quantized_tie_sweep():
    """Heavily quantized traces force exact residual ties in the split
    rules, and random parameters hit the counter-fit constraints from
    many sides: every trace equals the host oracle bit for bit."""
    rng = np.random.default_rng(17)
    for trial in range(6):
        T = int(rng.integers(12, 60))
        n = int(rng.integers(3, 7))
        traces = np.zeros((n, T))
        for i in range(n):
            nsteps = int(rng.integers(0, min(5, T // 4)))
            drops = np.sort(rng.choice(np.arange(2, T - 2), nsteps,
                                       replace=False))
            level = float(nsteps + 1)
            tr = np.full(T, level)
            for d in drops:
                level -= 1.0
                tr[d:] = level
            tr = tr * 2000 + rng.normal(0, 400, T)
            q = float(rng.choice([250.0, 500.0, 1000.0]))
            traces[i] = np.round(tr / q) * q
        kwargs = dict(
            num_steps=int(rng.integers(2, min(10, T - 2))),
            min_step_length=int(rng.integers(0, 4)),
            min_step_magnitude=float(rng.choice([0.0, 300.0, 900.0])),
            ignore_counterfits=bool(rng.integers(0, 2)))
        batch = sf.chi_squared_fit_batch(traces, n_threads=1, **kwargs)
        for i in range(n):
            oracle = sf.chi_squared_step_fitter(
                tuple(float(v) for v in traces[i]), **kwargs)
            assert batch[i] == [tuple(p) for p in oracle], (trial, i, kwargs)


def test_chi_squared_fit_batch_validation_and_engines():
    rng = np.random.default_rng(5)
    traces = rng.normal(size=(3, 20))
    with pytest.raises(ValueError):
        sf.chi_squared_fit_batch(traces, num_steps_multiplier=0)
    with pytest.raises(ValueError):
        sf.chi_squared_fit_batch(traces, num_steps=20)  # must be < T
    with pytest.raises(ValueError):
        sf.chi_squared_fit_batch(traces[:, :1])  # T < 2
    assert sf.chi_squared_fit_batch(np.zeros((0, 20))) == []
    # The device engine (ops/chisq_batch_device.py) on the CPU equals the
    # native core; tests/test_torch_chisq_device.py holds it in full.
    assert sf.chi_squared_fit_batch(traces, engine="device", device="cpu") \
        == sf.chi_squared_fit_batch(traces, engine="native", n_threads=1)
    with pytest.raises(ValueError, match="engine"):
        sf.chi_squared_fit_batch(traces, engine="probe")
    # num_steps = T - 1 with min_step_length = 0 on a strictly stepping
    # trace: the counterfit target exceeds T and the host chain raises;
    # the native core flags the trace and the batch raises the same error.
    trace = np.array([6000.0, 5000.0, 4000.0, 3000.0, 2000.0, 1000.0])
    kwargs = dict(num_steps=5, min_step_length=0, min_step_magnitude=0.0)
    with pytest.raises(ValueError, match="num_plateaus = 7 is greater"):
        sf.chi_squared_step_fitter(tuple(trace), **kwargs)
    with pytest.raises(ValueError, match="num_plateaus = 7 is greater"):
        sf.chi_squared_fit_batch(trace[None], n_threads=1, **kwargs)


def test_pipeline_chi_squared_stepfit_matches_the_jax_packages():
    traces = synth.make_chisq_traces(24, 100, seed=0)
    profiling.reset_timings()
    got = Pipeline(device="cpu", profile=True).chi_squared_stepfit(
        traces, num_steps=10)
    assert "api/chi_squared_stepfit" in profiling.timings()
    want = jax_api.Pipeline().chi_squared_stepfit(traces, num_steps=10)
    assert got == want and len(got) == 24
    assert any(len(fit) > 1 for fit in got)
    for i in (0, 7, 23):
        assert got[i] == [tuple(p) for p in sf.chi_squared_step_fitter(
            tuple(float(v) for v in traces[i]), num_steps=10)]
