"""The port's batched 1D mixture EM against the JAX package's, on the CPU.

The same numpy-seeded data go through
``fluorosequencingimageanalysis_tpu.ops.gmm_batch`` (XLA on the CPU) and
the port's ``ops/gmm_batch.py``, whose CPU path is kernel E's plain twin
(``_em_plain``). Both take their restart starts from the same
``_init_params`` and ``default_rng(seed)``, so the starts are identical.
Stated tolerances, all on the standardised scale of each group (the EM's
own scale):

- per model, the final log-likelihood within 1e-5 relative; means within
  1e-3 (i.e. 1e-3 of the group's standard deviation); weights within 1e-3
  absolute; variances within 1e-3 relative, or within 1e-5 of the
  component's second moment mu^2 + var where that is larger. Both sides
  run the JAX program's float32 arithmetic, but sum the points in other
  orders (XLA's reduction against torch's), and the differences pass
  through up to 100 EM rounds. The variance is taken as E[z^2] - mu^2, so
  a component much narrower than its distance from the data mean loses
  digits to that subtraction in both packages: a few float32 ulps of
  E[z^2] (measured: 3.4 ulps, 1e-3 relative of a variance of 2e-4 at a
  mean of -0.72) are all its variance has. Model by model (every
  restart, selected or not) the variances are held at 1% relative: the
  components of an over-parameterised restart that split one cluster
  drift slowly along a flat likelihood ridge and moved by up to 0.56%
  (see the test). Measured on these seeds: log-likelihoods within 7.3e-6
  relative model by model (a total of 403 over 950 points, where the
  per-point terms cancel; 1.7e-7 for the selected models), means within
  6.1e-5, weights within 2.8e-4;
- the best restart of each (group, k) and the BIC-selected k of each
  group: equal, except where the two candidates' log-likelihoods (or
  BICs) tie within the tolerance above (none does on these seeds);
- csrc/gmm_em.cuh built with g++ (-ffp-contract=off) against the twin's
  per-point E-step (``responsibilities``, the log2-domain arithmetic of
  kernel E) and M-step (``m_step``): bit for bit, with a stand-in for
  exp2 and log2 (and for log in the per-round constants) on both sides
  (glibc's and torch's CPU functions round some arguments apart);
- the header's split of a group's models into balanced subsets
  (``gmm::assign_subsets``, which every block of kernel E computes for its
  group) against a plain function of the same rule: equal, every model in
  exactly one subset, no subset over its cap.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_tpu.inference import gmm as jax_gmm
from fluorosequencingimageanalysis_tpu.ops import gmm_batch as jax_gb

from fluorosequencingimageanalysis_torch import _build
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.inference import gmm
from fluorosequencingimageanalysis_torch.ops import fused_gmm_em
from fluorosequencingimageanalysis_torch.ops import gmm_batch as gb
from fluorosequencingimageanalysis_torch.utils import profiling, synth

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

LL_REL, MEAN_ABS, W_ABS, VAR_REL, VAR_OF_MOMENT = 1e-5, 1e-3, 1e-3, 1e-3, 1e-5
VAR_REL_ANY_MODEL = 1e-2  # every restart's variances, selected or not
CHUNK = 512  # both packages' E-step chunk in these tests


def _mixture(rng, means, sigmas, counts):
    return np.concatenate([rng.normal(m, s, n)
                           for m, s, n in zip(means, sigmas, counts)])


def _groups(name):
    rng = np.random.default_rng({"three": 0, "ragged": 1, "levels": 2,
                                 "single": 3, "overlap": 4}[name])
    if name == "three":
        return [_mixture(rng, [0.0, 5.0, 10.0], [0.3, 0.4, 0.5],
                         [300, 250, 350])]
    if name == "ragged":
        return [_mixture(rng, [0.0, 7.0], [0.5, 0.8], [400, 500]),
                _mixture(rng, [0.0, 4.0, 9.0], [0.4, 0.5, 0.6],
                         [150, 120, 140]),
                rng.normal(3.0, 1.0, 37)]
    if name == "levels":  # OFF frames and fluor levels at raw scale
        return [_mixture(rng, [2000.0, 30000.0, 60000.0],
                         [300.0, 6000.0, 9000.0], [500, 300, 150]),
                _mixture(rng, [2000.0, 30000.0], [300.0, 6000.0],
                         [700, 200])]
    if name == "single":
        return [rng.normal(-4.0, 2.0, 600), rng.normal(10.0, 0.1, 300)]
    return [_mixture(rng, [0.0, 1.5], [1.0, 1.0], [500, 500])]


CASES = [("three", [1, 2, 3, 4], 4, 100), ("ragged", [2, 3, 4], 3, 60),
         ("levels", [2, 3, 4, 5], 4, 100), ("single", [1, 2], 3, 80),
         ("overlap", [1, 2, 3], 5, 100)]


def _standardised(groups, chunk):
    """The host half of gmm_fit_batched, as both packages do it."""
    n_valid = np.array([g.size for g in groups])
    mean = np.array([g.mean() for g in groups])
    std = np.array([max(float(g.std()), 1e-12) for g in groups])
    n_pad = -(-int(n_valid.max()) // chunk) * chunk
    z = np.zeros((len(groups), n_pad), np.float32)
    valid = np.zeros_like(z)
    for g, arr in enumerate(groups):
        z[g, :arr.size] = (arr - mean[g]) / std[g]
        valid[g, :arr.size] = 1.0
    return z, valid, n_valid, mean, std


def _close(ll_a, ll_b, mu_a, mu_b, var_a, var_b, w_a, w_b, active):
    """Each stated tolerance, as a boolean array over the models."""
    ll_ok = np.abs(ll_a - ll_b) <= LL_REL * np.abs(ll_a)
    moment = mu_a * mu_a + var_a
    var_ok = (np.abs(var_a - var_b) <= np.maximum(
        VAR_REL * var_a, VAR_OF_MOMENT * moment)) | ~active
    mu_ok = (np.abs(mu_a - mu_b) <= MEAN_ABS) | ~active
    w_ok = np.abs(w_a - w_b) <= W_ABS
    return ll_ok, mu_ok.all(-1), var_ok.all(-1), w_ok.all(-1)


@pytest.mark.parametrize("name,ks,n_init,n_iter", CASES)
def test_em_twin_equals_the_jax_em_model_by_model(name, ks, n_init, n_iter):
    groups = _groups(name)
    z, valid, n_valid, _, _ = _standardised(groups, CHUNK)
    K = max(ks)
    w0, mu0, var0, mask = gb._init_params(
        [z[g] for g in range(len(groups))], n_valid, ks, n_init, K,
        np.random.default_rng(7))
    nch = z.shape[1] // CHUNK
    chunked = [np.ascontiguousarray(a.reshape(len(groups), nch, CHUNK)
                                    .transpose(1, 0, 2)) for a in (z, valid)]
    want = [np.asarray(a, np.float64) for a in jax_gb._em_batched(
        *chunked, w0, mu0, var0, mask, n_iter, np.float32(1e-6))]
    got = [t.numpy().astype(np.float64) for t in gb._em_plain(
        *(torch.from_numpy(a) for a in (z, valid, w0, mu0, var0, mask)),
        n_iter, 1e-6, chunk=CHUNK)]
    assert all(g.dtype == np.float64 for g in got)
    oks = _close(want[3], got[3], want[1], got[1], want[2], got[2],
                 want[0], got[0], mask)
    for what, ok in zip(("loglik", "means", "weights"), oks[:2] + oks[3:]):
        assert ok.all(), (what, np.argwhere(~ok)[:5])
    # An over-parameterised restart splits a cluster into components that
    # drift slowly along a flat likelihood ridge; after 100 rounds their
    # variances still move by up to 0.56% ("levels", k = 4 and 5) between
    # the two summation orders. Model by model the variances are held at
    # 1%; the selected models hold the stated tolerance (the next test).
    act = mask.astype(bool)
    rel = np.abs(want[2] - got[2])[act] / want[2][act]
    assert rel.max() <= VAR_REL_ANY_MODEL, rel.max()
    # Best restart of each (group, k): equal unless tied within LL_REL.
    G, J = len(groups), len(ks)
    ll_w, ll_g = (a.reshape(G, J, n_init) for a in (want[3], got[3]))
    bw, bg = ll_w.argmax(-1), ll_g.argmax(-1)
    for g, j in zip(*np.nonzero(bw != bg)):
        a, b = ll_w[g, j, bw[g, j]], ll_w[g, j, bg[g, j]]
        assert abs(a - b) <= LL_REL * abs(a), (g, j, a, b)


@pytest.mark.parametrize("name,ks,n_init,n_iter", CASES)
def test_gmm_fit_batched_equals_the_jax_packages(name, ks, n_init, n_iter):
    groups = _groups(name)
    kw = dict(n_init=n_init, n_iter=n_iter, seed=3, chunk=CHUNK)
    want = jax_gb.gmm_fit_batched(groups, ks, **kw)
    got = gb.gmm_fit_batched(groups, ks, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["counts"], want["counts"])
    _, _, _, mean, std = _standardised(groups, CHUNK)
    s, m = std[:, None, None], mean[:, None, None]
    active = want["weights"] > 0
    mu_w, mu_g = (want["means"] - m) / s, (got["means"] - m) / s
    ll_w = want["loglik"] + (want["counts"] * np.log(std))[:, None]
    ll_g = got["loglik"] + (want["counts"] * np.log(std))[:, None]
    oks = _close(ll_w, ll_g, mu_w, mu_g, want["vars"] / s ** 2,
                 got["vars"] / s ** 2, want["weights"], got["weights"],
                 active)
    for what, ok in zip(("loglik", "means", "vars", "weights"), oks):
        assert ok.all(), (what, np.argwhere(~ok)[:5])
    assert (got["means"][~active] == 0).all()
    assert (got["vars"][~active] == 0).all()
    # The BIC-selected k of every group.
    kw_, kg = want["bic"].argmin(1), got["bic"].argmin(1)
    for g in np.nonzero(kw_ != kg)[0]:
        a, b = want["bic"][g, kw_[g]], want["bic"][g, kg[g]]
        assert abs(a - b) <= LL_REL * abs(a), (g, a, b)
    np.testing.assert_allclose(got["bic"], want["bic"],
                               rtol=2 * LL_REL, atol=0)


def test_starts_and_validation_equal_the_jax_packages():
    groups = _groups("ragged")
    z, _, n_valid, _, _ = _standardised(groups, CHUNK)
    args = ([z[g] for g in range(3)], n_valid, [2, 3, 4], 5, 4)
    for a, b in zip(gb._init_params(*args, np.random.default_rng(0)),
                    jax_gb._init_params(*args, np.random.default_rng(0))):
        np.testing.assert_array_equal(a, b)
    for bad, err in (([np.array([])], "at least one"),
                     ([np.ones(4)], "positive")):
        ks = [2] if err == "at least one" else [0]
        with pytest.raises(ValueError, match=err):
            gb.gmm_fit_batched(bad, ks=ks, device="cpu")
        with pytest.raises(ValueError, match=err):
            jax_gb.gmm_fit_batched(bad, ks=ks)
    with pytest.raises(ValueError, match="n_samples >= n_components"):
        gb.gmm_fit_batched([np.array([100.0, 200.0])], ks=[2, 3],
                           device="cpu")
    res = gb.gmm_fit_batched([np.array([100.0, 200.0])], ks=[2], n_init=2,
                             n_iter=50, device="cpu")
    np.testing.assert_allclose(np.sort(res["means"][0, 0, :2]),
                               [100.0, 200.0], atol=1.0)
    # Constant data: finite, the mean at the constant, as in JAX.
    want = jax_gb.gmm_fit_batched([np.full(500, 42.0)], ks=[1, 2],
                                  n_init=2, n_iter=50)
    got = gb.gmm_fit_batched([np.full(500, 42.0)], ks=[1, 2], n_init=2,
                             n_iter=50, device="cpu")
    for key in ("means", "loglik", "weights"):
        assert np.isfinite(got[key]).all()
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-3)
    assert got["means"][0, 0, 0] == pytest.approx(42.0, abs=1e-3)


def _photometries(seed, C, n):
    rng = np.random.default_rng(seed)
    out = {"ch1": {0: {}}}
    for t in range(n):
        ints = [float(rng.normal(2000, 300)) if c > t % C
                else float(rng.normal(30000, 3000)) for c in range(C)]
        out["ch1"][0][(10 + t, 20)] = (tuple(v > 10000 for v in ints),
                                       tuple(ints), t)
    return out


def _same_fit(a, b):
    assert type(a).__name__ == type(b).__name__ == "BatchedGMM1D"
    assert a.n_components == b.n_components
    assert a._n_samples == b._n_samples
    assert a._loglik == pytest.approx(b._loglik, rel=2 * LL_REL)
    scale = max(float(np.sqrt(np.max(b.covariances_))), 1.0)
    np.testing.assert_allclose(a.means_, b.means_, atol=10 * scale * 1e-3)
    np.testing.assert_allclose(a.weights_, b.weights_, atol=W_ABS)


def test_gmm_photometries_batched_equals_the_jax_packages():
    rng = np.random.default_rng(5)
    x = _mixture(rng, [1000.0, 30000.0], [400.0, 5000.0], [900, 600])
    for lb in (None, 10000.0):
        kw = dict(min_fluors=1, max_fluors=3, raw_photometries=list(x),
                  lower_bound=lb, n_init=4, seed=1)
        want = jax_gmm.gmm_photometries_batched({}, **kw)
        got = gmm.gmm_photometries_batched({}, device="cpu", **kw)
        assert got[2] == want[2]                      # best num_fluors
        assert got[3] == pytest.approx(want[3], rel=2 * LL_REL)
        np.testing.assert_array_equal(got[5], want[5])  # raw
        _same_fit(got[1], want[1])
        assert len(got[4]) == len(want[4]) == 3
        for (fa, ba), (fb, bb) in zip(got[4], want[4]):
            _same_fit(fa, fb)
            assert ba == pytest.approx(bb, rel=2 * LL_REL)
    with pytest.raises(NotImplementedError, match="channels"):
        gmm.gmm_photometries_batched({"a": {}, "b": {}}, device="cpu")
    with pytest.raises(ValueError, match="covariance"):
        gmm.gmm_photometries_batched({}, raw_photometries=[1.0, 2.0],
                                     covariance_type="diag", device="cpu")


def _same_per_cycle(got, want):
    (sg, fg, rg), (sw, fw, rw) = got, want
    assert list(sg) == list(sw) and list(fg) == list(fw)
    assert list(rg) == list(rw)
    for cycle in sw:
        np.testing.assert_array_equal(rg[cycle], rw[cycle])
        bf_g, nf_g, bic_g, fm_g = sg[cycle]
        bf_w, nf_w, bic_w, fm_w = sw[cycle]
        assert nf_g == nf_w
        assert bic_g == pytest.approx(bic_w, rel=2 * LL_REL)
        _same_fit(bf_g, bf_w)
        assert len(fm_g) == len(fm_w)
        assert len(fg[cycle]) == len(fw[cycle])
        for a, b in zip(fg[cycle], fw[cycle]):
            _same_fit(a, b)


def test_per_cycle_gmm_and_the_pipeline_equal_the_jax_packages():
    from fluorosequencingimageanalysis_tpu.api import Pipeline as JaxPipeline

    phot = _photometries(4, 3, 260)
    kw = dict(min_fluors=1, max_fluors=2, n_init=4)
    _same_per_cycle(gmm.per_cycle_gmm_batched(phot, device="cpu", **kw),
                    jax_gmm.per_cycle_gmm_batched(phot, **kw))
    kw = dict(kw, cycles=(0, 2), lower_bound=1500.0, seed=2)
    _same_per_cycle(gmm.per_cycle_gmm_batched(phot, device="cpu", **kw),
                    jax_gmm.per_cycle_gmm_batched(phot, **kw))
    profiling.reset_timings()
    got = Pipeline(device="cpu", profile=True).per_cycle_gmm(
        phot, min_fluors=1, max_fluors=2, n_init=3)
    want = JaxPipeline().per_cycle_gmm(phot, min_fluors=1, max_fluors=2,
                                       n_init=3)
    _same_per_cycle(got, want)
    stages = profiling.timings()
    for name in ("api/per_cycle_gmm", "gmm/collect", "gmm/standardise+init",
                 "gmm/em", "gmm/select", "gmm/assemble"):
        assert stages[name]["count"] == 1, name
    with pytest.raises(ValueError, match="covariance"):
        gmm.per_cycle_gmm_batched(phot, covariance_type="tied",
                                  device="cpu")


def test_batched_gmm1d_scoring_equals_the_jax_packages():
    rng = np.random.default_rng(6)
    x = _mixture(rng, [1000.0, 30000.0, 55000.0], [500.0, 5000.0, 7000.0],
                 [300, 200, 100])
    args = ([0.5, 0.3, 0.2], [1000.0, 30000.0, 55000.0],
            [2.5e5, 2.5e7, 4.9e7], -5000.0, x.size)
    a, b = gmm.BatchedGMM1D(*args), jax_gmm.BatchedGMM1D(*args)
    np.testing.assert_array_equal(a.score_samples(x), b.score_samples(x))
    np.testing.assert_array_equal(a.predict(x), b.predict(x))
    assert a.score(x) == b.score(x)
    assert a.bic(x) == b.bic(x) and a.aic(x) == b.aic(x)
    assert a.covars_ is a.covariances_ and a.means_.shape == (3, 1)
    assert a._n_parameters() == 8


def test_make_gmm_photometries_ladders_with_noisy_off_frames():
    phot = synth.make_gmm_photometries(2500, F=6, rows_per_field=1000,
                                       seed=3)
    assert list(phot) == ["ch1"] and sorted(phot["ch1"]) == [0, 1, 2]
    rows = [v for f in phot["ch1"].values() for v in f.values()]
    assert len(rows) == 2500 and sorted(r[2] for r in rows) == list(
        range(2500))
    cats = np.array([r[0] for r in rows])
    ints = np.array([r[1] for r in rows])
    ladder, c2, _ = synth.make_v8_workload(2500, F=6, seed=3)
    order = np.argsort([r[2] for r in rows])
    np.testing.assert_array_equal(cats[order], c2)
    np.testing.assert_array_equal(ints[order][c2], ladder[c2])
    off = ints[order][~c2]
    assert abs(off.mean() - 2000) < 30 and abs(off.std() - 300) < 30
    assert (np.diff(cats[order].astype(int), axis=1) <= 0).all()


def test_gmm_em_wrapper_takes_the_twin_on_the_cpu_and_checks_shapes():
    groups = _groups("ragged")
    z, valid, n_valid, _, _ = _standardised(groups, 256)
    w0, mu0, var0, mask = (torch.from_numpy(a) for a in gb._init_params(
        [z[g] for g in range(3)], n_valid, [2, 3], 2, 3,
        np.random.default_rng(0)))
    z_t = torch.from_numpy(z)
    counts = torch.from_numpy(n_valid.astype(np.int32))
    before = fused_gmm_em.gmm_em.launches
    got = fused_gmm_em.gmm_em(z_t, counts, w0, mu0, var0, mask, 20, 1e-6,
                              chunk=256)
    want = gb._em_plain(z_t, torch.from_numpy(valid), w0, mu0, var0, mask,
                        20, 1e-6, chunk=256)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fused_gmm_em.gmm_em.launches == before  # no launch on the CPU
    with pytest.raises(ValueError, match="data"):
        fused_gmm_em.gmm_em(z_t[0], counts, w0, mu0, var0, mask, 1, 1e-6)
    with pytest.raises(ValueError, match="starts"):
        fused_gmm_em.gmm_em(z_t, counts, w0[:2], mu0, var0, mask, 1, 1e-6)
    with pytest.raises(ValueError, match="share"):
        fused_gmm_em.gmm_em(z_t, counts, w0, mu0[..., :2], var0, mask, 1,
                            1e-6)
    with pytest.raises(ValueError, match="counts"):
        fused_gmm_em.gmm_em(z_t, counts[:2], w0, mu0, var0, mask, 1, 1e-6)
    with pytest.raises(ValueError, match="device"):
        fused_gmm_em.gmm_em(*(t.to("meta") for t in (z_t, counts, w0, mu0,
                                                     var0, mask)), 1, 1e-6)


# -- csrc/gmm_em.cuh built with g++ -------------------------------------------

HARNESS = r"""
#include <stdio.h>
#include <vector>
#include "gmm_em.cuh"

struct HostExp2 {  // the test's stand-ins for exp2 and log (log2), as
  float operator()(float x) const {  // the twin's
    return x < -87.0f ? 0.0f : 1.0f / (1.0f - x);
  }
};
struct HostLog {
  float operator()(float x) const { return (x - 1.0f) / (x + 1.0f); }
};
struct HostRcp {  // the twin's IEEE reciprocal
  float operator()(float x) const { return 1.0f / x; }
};

// stdin: int32 -1, B, S, mmax, then nact (B int32). stdout: int32 rc,
// then subset (B int32).
int split() {
  int hdr[3];
  if (fread(hdr, sizeof hdr, 1, stdin) != 1) return 2;
  const int B = hdr[0], S = hdr[1], mmax = hdr[2];
  std::vector<int> nact(B), subset(B, -7), load(S), size(S);
  if (fread(nact.data(), 4, B, stdin) != (size_t)B) return 3;
  const int rc = gmm::assign_subsets(nact.data(), B, S, mmax, load.data(),
                                     size.data(), subset.data());
  fwrite(&rc, 4, 1, stdout);
  fwrite(subset.data(), 4, B, stdout);
  return 0;
}

// stdin: int32 B, K, n; then w, mu, var (B*K float32 each), act (B*K
// bytes), points (n float32), then nk, sk, qk (B*K float32 each) and
// n_valid, reg (float32). stdout: per model and point lse and K resps;
// then per model the M-step's K weights, means and variances.
template <int K>
int run(int B, int n) {
  std::vector<float> w(B * K), mu(B * K), var(B * K), x(n);
  std::vector<unsigned char> act_b(B * K);
  std::vector<float> nk(B * K), sk(B * K), qk(B * K);
  float nr[2];
  if (fread(w.data(), 4, B * K, stdin) != (size_t)(B * K) ||
      fread(mu.data(), 4, B * K, stdin) != (size_t)(B * K) ||
      fread(var.data(), 4, B * K, stdin) != (size_t)(B * K) ||
      fread(act_b.data(), 1, B * K, stdin) != (size_t)(B * K) ||
      fread(x.data(), 4, n, stdin) != (size_t)n ||
      fread(nk.data(), 4, B * K, stdin) != (size_t)(B * K) ||
      fread(sk.data(), 4, B * K, stdin) != (size_t)(B * K) ||
      fread(qk.data(), 4, B * K, stdin) != (size_t)(B * K) ||
      fread(nr, 4, 2, stdin) != 2)
    return 3;
  for (int b = 0; b < B; ++b) {
    bool act[K];
    for (int k = 0; k < K; ++k) act[k] = act_b[b * K + k] != 0;
    gmm::Model<K> m;
    gmm::prepare<K>(&w[b * K], &mu[b * K], &var[b * K], act, HostLog(), &m);
    for (int i = 0; i < n; ++i) {
      float resp[K];
      const float lse = gmm::point<K>(m, x[i], HostExp2(), HostLog(),
                                        HostRcp(), resp);
      fwrite(&lse, 4, 1, stdout);
      fwrite(resp, 4, K, stdout);
    }
  }
  for (int b = 0; b < B; ++b) {
    float mu_k[K], var_k[K], w_raw[K], w_k[K];
    for (int k = 0; k < K; ++k)
      gmm::component_update(nk[b * K + k], sk[b * K + k], qk[b * K + k],
                            nr[0], nr[1], act_b[b * K + k] != 0, &mu_k[k],
                            &var_k[k], &w_raw[k]);
    for (int k = 0; k < K; ++k)
      gmm::component_finish(w_raw, K, k, act_b[b * K + k] != 0, &w_k[k],
                            &mu_k[k], &var_k[k]);
    fwrite(w_k, 4, K, stdout);
    fwrite(mu_k, 4, K, stdout);
    fwrite(var_k, 4, K, stdout);
  }
  return 0;
}

// As run<K>, for the shared-memory form's runtime K: each model's active
// components' constants compacted in order, point_norm per point and
// component_term per active component; the M-step for a runtime K.
int run_runtime(int B, int K, int n) {
  std::vector<float> w(B * K), mu(B * K), var(B * K), x(n);
  std::vector<unsigned char> act_b(B * K);
  std::vector<float> nk(B * K), sk(B * K), qk(B * K);
  float nr[2];
  if (fread(w.data(), 4, B * K, stdin) != (size_t)(B * K) ||
      fread(mu.data(), 4, B * K, stdin) != (size_t)(B * K) ||
      fread(var.data(), 4, B * K, stdin) != (size_t)(B * K) ||
      fread(act_b.data(), 1, B * K, stdin) != (size_t)(B * K) ||
      fread(x.data(), 4, n, stdin) != (size_t)n ||
      fread(nk.data(), 4, B * K, stdin) != (size_t)(B * K) ||
      fread(sk.data(), 4, B * K, stdin) != (size_t)(B * K) ||
      fread(qk.data(), 4, B * K, stdin) != (size_t)(B * K) ||
      fread(nr, 4, 2, stdin) != 2)
    return 3;
  std::vector<float> c2(K), cm(K), h2(K), resp(K);
  for (int b = 0; b < B; ++b) {
    int a = 0;
    for (int k = 0; k < K; ++k) {
      if (!act_b[b * K + k]) continue;
      gmm::component_constants(w[b * K + k], var[b * K + k], true,
                               HostLog(), &c2[a], &h2[a]);
      cm[a++] = mu[b * K + k];
    }
    for (int i = 0; i < n; ++i) {
      float mx, r;
      const float lse = gmm::point_norm(c2.data(), cm.data(), h2.data(), a,
                                        x[i], HostExp2(), HostLog(),
                                        HostRcp(), &mx, &r);
      for (int k = 0, j = 0; k < K; ++k) {
        if (!act_b[b * K + k]) {
          resp[k] = 0.0f;
          continue;
        }
        resp[k] = gmm::component_term(c2[j], cm[j], h2[j], x[i], mx,
                                      HostExp2()) * r;
        ++j;
      }
      fwrite(&lse, 4, 1, stdout);
      fwrite(resp.data(), 4, K, stdout);
    }
  }
  std::vector<float> mu_k(K), var_k(K), w_raw(K), w_k(K);
  for (int b = 0; b < B; ++b) {
    for (int k = 0; k < K; ++k)
      gmm::component_update(nk[b * K + k], sk[b * K + k], qk[b * K + k],
                            nr[0], nr[1], act_b[b * K + k] != 0, &mu_k[k],
                            &var_k[k], &w_raw[k]);
    for (int k = 0; k < K; ++k)
      gmm::component_finish(w_raw.data(), K, k, act_b[b * K + k] != 0,
                            &w_k[k], &mu_k[k], &var_k[k]);
    fwrite(w_k.data(), 4, K, stdout);
    fwrite(mu_k.data(), 4, K, stdout);
    fwrite(var_k.data(), 4, K, stdout);
  }
  return 0;
}

int main() {
  int hdr[3];
  if (fread(hdr, 4, 1, stdin) != 1) return 2;
  if (hdr[0] < 0) return split();
  if (fread(hdr + 1, 4, 2, stdin) != 2) return 2;
  switch (hdr[1]) {
    case 1: return run<1>(hdr[0], hdr[2]);
    case 2: return run<2>(hdr[0], hdr[2]);
    case 3: return run<3>(hdr[0], hdr[2]);
    case 4: return run<4>(hdr[0], hdr[2]);
    case 5: return run<5>(hdr[0], hdr[2]);
    case 6: return run<6>(hdr[0], hdr[2]);
    case 7: return run<7>(hdr[0], hdr[2]);
    case 8: return run<8>(hdr[0], hdr[2]);
  }
  if (hdr[1] > gmm::KREG && hdr[1] <= gmm::KMAX)
    return run_runtime(hdr[0], hdr[1], hdr[2]);
  return 4;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the gmm_em.cuh harness")
    d = tmp_path_factory.mktemp("gmm_em")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-I", _build.CSRC,
         "-o", str(exe), str(src)], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    return str(exe)


def _exp_stand_in(t):
    return torch.where(t < -87.0, torch.zeros_like(t), 1.0 / (1.0 - t))


def _log_stand_in(x):
    return (x - 1.0) / (x + 1.0)


@pytest.mark.parametrize("B,K,n,seed", [(7, 3, 300, 0), (5, 6, 257, 1),
                                        (4, 1, 100, 2), (3, 8, 64, 3),
                                        (6, 5, 128, 4), (2, 2, 33, 5),
                                        (5, 4, 96, 6), (4, 7, 80, 7),
                                        (4, 9, 90, 8), (3, 12, 70, 9),
                                        (3, 17, 64, 10), (3, 33, 40, 11)])
def test_kernel_arithmetic_equals_the_twin_bit_for_bit(harness, B, K, n,
                                                       seed):
    """Every K of the register form (1-8) and K = 9, 12, 17 and 33 of the
    shared-memory form (point_norm and component_term, the constants
    compacted); a far point whose exp2 underflows to 0 in every component
    but the nearest; a model with one active component (its sum is that
    one term); a mask that is not a prefix."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    act = np.zeros((B, K), bool)
    for b in range(B):  # a prefix of 1..K active components, one model not
        act[b, :rng.integers(1, K + 1)] = True
    act[1] = False
    act[1, rng.integers(0, K)] = True  # one component, anywhere
    if K > 2:
        act[-1] = rng.random(K) < 0.6
        act[-1, 0], act[-1, 1] = False, True  # not a prefix
    w = np.where(act, rng.dirichlet(np.ones(K), B), 0).astype(f32)
    w[0, 0] = 0.0 if act[0].sum() > 1 else w[0, 0]  # log-weight floor
    mu = np.where(act, rng.normal(0, 1.5, (B, K)), 0).astype(f32)
    var = np.where(act, rng.uniform(1e-4, 2.0, (B, K)), 1).astype(f32)
    x = rng.normal(0, 2, n).astype(f32)
    x[:3] = [40.0, -40.0, 0.0]  # far points: exp underflows to 0
    nk = np.where(act, rng.uniform(0, 50, (B, K)), 0).astype(f32)
    nk[0, 0] = 0.0 if act[0, 0] else nk[0, 0]  # the 1e-10 floor
    sk = (nk * rng.normal(0, 1, (B, K))).astype(f32)
    qk = (sk * sk / np.maximum(nk, 1e-10) + nk * rng.uniform(
        0, 0.5, (B, K))).astype(f32)
    qk[-1, -1] = sk[-1, -1] ** 2 / max(nk[-1, -1], 1e-10) * 0.999  # < mu^2
    n_valid, reg = f32(n), f32(1e-6)
    blob = (np.array([B, K, n], np.int32).tobytes() + w.tobytes() +
            mu.tobytes() + var.tobytes() + act.astype(np.uint8).tobytes() +
            x.tobytes() + nk.tobytes() + sk.tobytes() + qk.tobytes() +
            np.array([n_valid, reg], f32).tobytes())
    proc = subprocess.run([harness], input=blob, capture_output=True,
                          timeout=120)
    assert proc.returncode == 0, proc.returncode
    out = np.frombuffer(proc.stdout, dtype=np.float32)
    e_part = out[:B * n * (K + 1)].reshape(B, n, K + 1)
    m_part = out[B * n * (K + 1):].reshape(B, 3, K)

    t = {k: torch.from_numpy(v)[None] for k, v in
         (("w", w), ("mu", mu), ("var", var), ("act", act))}
    cst = gb._log_constants(t["w"], t["var"], t["act"], _log_stand_in)
    lse, resp = gb.responsibilities(torch.from_numpy(x)[None], cst,
                                    t["mu"], t["var"], _exp_stand_in,
                                    _log_stand_in)
    np.testing.assert_array_equal(e_part[..., 0].view(np.int32),
                                  lse[0].numpy().view(np.int32))
    np.testing.assert_array_equal(e_part[..., 1:].view(np.int32),
                                  resp[0].numpy().view(np.int32))
    assert (resp[0].numpy()[~np.broadcast_to(act[:, None, :],
                                             resp[0].shape)] == 0).all()
    if act.sum(axis=1).max() > 1:  # x = 40 underflows a component
        assert (resp[0, :, 0, :].numpy()[act] == 0).any()
    # One active component: its responsibility is 1 at every point.
    assert (e_part[1, :, 1:][:, act[1]] == 1.0).all()
    if K > 2:
        assert not act[-1, 0] and act[-1, 1]
    w2, mu2, var2 = gb.m_step(
        *(torch.from_numpy(a)[None] for a in (nk, sk, qk)),
        torch.tensor([n_valid]), torch.from_numpy(act)[None], float(reg))
    for i, got in enumerate((w2, mu2, var2)):
        np.testing.assert_array_equal(m_part[:, i].view(np.int32),
                                      got[0].numpy().view(np.int32))
    assert var2[0, -1, -1] == reg or not act[-1, -1]


def _split_plain(nact, S, mmax):
    """gmm::assign_subsets' rule: longest first (active count, then model
    index), each model to the subset with the least work (count + 2) that
    has room, the lowest index at a tie."""
    if S < 1 or mmax < 1 or S * mmax < len(nact):
        return -1, None
    load, size, subset = [0] * S, [0] * S, [None] * len(nact)
    for a in range(fused_gmm_em.KMAX, -1, -1):
        for b, na in enumerate(nact):
            if na != a:
                continue
            best = min((s for s in range(S) if size[s] < mmax),
                       key=lambda s: (load[s], s))
            subset[b] = best
            load[best] += a + 2
            size[best] += 1
    return 0, subset


CONFIG5_NACT = [k for k in (2, 3, 4, 5, 6) for _ in range(10)]


@pytest.mark.parametrize("nact,S,mmax", [
    (CONFIG5_NACT, 4, 16),                           # config 5's models
    (CONFIG5_NACT, 50, 16),                          # one model a block
    ([1] * 4, 1, 4),
    ([0, 8, 3, 3, 7, 1, 0, 5, 2, 8, 6, 4], 5, 3),     # unsorted, empty models
    ([3] * 33, 3, 11),                               # every subset full
    ([2] * 10, 2, 4)])                               # cannot hold them
def test_subset_split_equals_the_plain_rule(harness, nact, S, mmax):
    blob = np.array([-1, len(nact), S, mmax] + list(nact),
                    np.int32).tobytes()
    proc = subprocess.run([harness], input=blob, capture_output=True,
                          timeout=120)
    assert proc.returncode == 0, proc.returncode
    out = np.frombuffer(proc.stdout, dtype=np.int32)
    rc, subset = int(out[0]), out[1:]
    want_rc, want = _split_plain(nact, S, mmax)
    assert rc == want_rc
    if rc:
        return
    assert subset.tolist() == want
    sizes = np.bincount(subset, minlength=S)
    assert ((subset >= 0) & (subset < S)).all() and sizes.max() <= mmax
    if sizes.max() < mmax:  # no cap in the way: within one model's work
        loads = np.bincount(subset, weights=np.array(nact) + 2.0,
                            minlength=S)
        assert loads.max() - loads.min() <= max(nact) + 2
    # Models in, models out: the blocks' model lists (each in model
    # order) hold every model once.
    blocks = [np.nonzero(subset == s)[0] for s in range(S)]
    assert all((np.diff(m) > 0).all() for m in blocks)
    assert sorted(np.concatenate(blocks).tolist()) == list(range(len(nact)))


# -- fault F1: more components than eight and more models than BMAX ---------

def test_model_slices_equal_one_call_bit_for_bit(monkeypatch):
    """50 models in slices of 20 (20, 20, 10) equal one call of the twin
    bit for bit, and gmm_fit_batched with BMAX patched to 7 equals it
    unpatched: models are independent, so slicing changes no bit."""
    rng = np.random.default_rng(11)
    groups = [_mixture(rng, [0.0, 4.0, 9.0], [0.5, 0.6, 0.7],
                       [300, 200, 250]), rng.normal(2.0, 1.0, 500)]
    z, _, n_valid, _, _ = _standardised(groups, CHUNK)
    starts = gb._init_params([z[g] for g in range(2)], n_valid,
                             [1, 2, 3, 4, 5], 10, 5,
                             np.random.default_rng(0))
    args = [torch.from_numpy(a) for a in
            (z, n_valid.astype(np.int32), *starts)]
    one = gb.em_in_slices(*args, 5, 1e-6, chunk=CHUNK)
    with monkeypatch.context() as m:
        m.setattr(fused_gmm_em, "BMAX", 20)
        sliced = gb.em_in_slices(*args, 5, 1e-6, chunk=CHUNK)
    assert one[0].shape == (2, 50, 5)
    for a, b in zip(one, sliced):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    kw = dict(n_init=6, n_iter=20, seed=1, chunk=CHUNK, device="cpu")
    want = gb.gmm_fit_batched(groups, [1, 2, 3], **kw)
    monkeypatch.setattr(fused_gmm_em, "BMAX", 7)
    got = gb.gmm_fit_batched(groups, [1, 2, 3], **kw)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_nine_and_ten_components_equal_the_jax_packages():
    """ks = [9, 10], the shared-memory form's range on the card: the
    twin's fits equal the JAX package's within the stated tolerances."""
    rng = np.random.default_rng(12)
    groups = [_mixture(rng, np.arange(10) * 6.0, np.full(10, 0.8),
                       np.full(10, 270)) for _ in range(2)]
    kw = dict(n_init=3, n_iter=20, seed=3, chunk=CHUNK)
    want = jax_gb.gmm_fit_batched(groups, [9, 10], **kw)
    got = gb.gmm_fit_batched(groups, [9, 10], device="cpu", **kw)
    _, _, _, mean, std = _standardised(groups, CHUNK)
    s, m = std[:, None, None], mean[:, None, None]
    active = want["weights"] > 0
    ll_w = want["loglik"] + (want["counts"] * np.log(std))[:, None]
    ll_g = got["loglik"] + (want["counts"] * np.log(std))[:, None]
    oks = _close(ll_w, ll_g, (want["means"] - m) / s, (got["means"] - m) / s,
                 want["vars"] / s ** 2, got["vars"] / s ** 2,
                 want["weights"], got["weights"], active)
    for what, ok in zip(("loglik", "means", "vars", "weights"), oks):
        assert ok.all(), (what, np.argwhere(~ok)[:5])
    np.testing.assert_allclose(got["bic"], want["bic"], rtol=2 * LL_REL,
                               atol=0)


def test_per_cycle_gmm_up_to_eight_fluors_equals_the_jax_packages():
    """max_fluors=8 (k 2-9, K = 9): the port's Pipeline picks the JAX
    Pipeline's k in every cycle, each fit within the stated tolerances."""
    from fluorosequencingimageanalysis_tpu.api import Pipeline as JaxPipeline

    rng = np.random.default_rng(6)
    phot = {"ch1": {0: {}}}
    for t in range(900):  # nine intensity levels, 0-8 fluors, 3 cycles
        lv = rng.integers(0, 9, 3)
        ints = tuple(float(rng.normal(2000 + 30000 * v, 300 + 1000 * v))
                     for v in lv)
        phot["ch1"][0][(10 + t, 20)] = (tuple(lv > 0), ints, t)
    kw = dict(min_fluors=1, max_fluors=8, n_init=2)
    _same_per_cycle(Pipeline(device="cpu").per_cycle_gmm(phot, **kw),
                    JaxPipeline().per_cycle_gmm(phot, **kw))
