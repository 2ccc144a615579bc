"""Port parity: the batched Monte-Carlo simulation (sim/dye_sim.py), the
native signal sampler (native/randsiggen) and ``Pipeline.simulate_signals``.

torch cannot reproduce ``jax.random``'s streams, so parity is of two kinds:

- **exact**, on the JAX package's own draws: the tests rebuild the uniforms
  and normals the JAX functions draw (the same key splits; float64 uniforms
  under this suite's x64, float32 normals) and put them in place of the
  port's draw step (``draw_simulation``, ``draw_normals``). Counts, loss cycles, dud flags, decrements, categories, signals,
  none counts and molecular-error signals are equal; intensities within
  rtol 2e-6: the float32 exponent ``log(beta n) - ddif + sigma z`` lies near
  12, where one ulp is 9.5e-7, and XLA's fused program and torch's
  operations round it an ulp apart, which ``exp`` turns into 9.5e-7 of the
  intensity;
- **statistical**, for the port's own generator: per-cycle count histograms
  and the joint two-colour distribution within a total variation distance
  of 0.03 of the JAX package's at N = 20,000 (two independent samples of
  this size sit near 0.01).

The native sampler is the JAX package's C++ source with the same seed, so
its tries are equal.
"""

import math
import os
import pickle
from collections import defaultdict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluorosequencingimageanalysis_tpu.api import Pipeline as JaxPipeline
from fluorosequencingimageanalysis_tpu.native import randsiggen as jax_rsg
from fluorosequencingimageanalysis_tpu import sim as jax_sim_pkg
from fluorosequencingimageanalysis_tpu.sim import dye_sim as jax_sim

from fluorosequencingimageanalysis_torch import _build
from fluorosequencingimageanalysis_torch import sim as port_sim_pkg
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.inference.lognormal import (
    photometries_lognormal_fit_v8 as port_fit_v8)
from fluorosequencingimageanalysis_torch.native import randsiggen as port_rsg
from fluorosequencingimageanalysis_torch.sim import dye_sim as port_sim

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

SEQ = "ACKDYECAGKHSECAMKR"  # bench.py's 18-mer
CLI_PARAMS = dict(p=0.90, b=-math.log(1.0 - 0.1), u=0.50, s=0.30, sc=4,
                  s2=0.10)
BETA, BETA_SIGMA = 70000.0, 0.20
DDIF = [0.0, 0.30] + [0.30] * 5
PHOT_RTOL = 2e-6


def jax_draws(seed, N, L, C):
    """The uniforms the JAX package's ``_simulate_batch`` draws from
    PRNGKey(seed), in the port's SimDraws layout."""
    k_dud, k_tirf0, k_cycle = jax.random.split(jax.random.PRNGKey(seed), 3)
    edman, strip, tirf = [], [], []
    for key in jax.random.split(k_cycle, C):
        k_edman, k_strip, k_tirf = jax.random.split(key, 3)
        edman.append(np.asarray(jax.random.uniform(k_edman, (N,))))
        strip.append(np.asarray(jax.random.uniform(k_strip, (N,))))
        tirf.append(np.asarray(jax.random.uniform(k_tirf, (N, L))))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return port_sim.SimDraws(
        t(jax.random.uniform(k_dud, (N, L))),
        t(jax.random.uniform(k_tirf0, (N, L))), t(np.stack(edman)),
        t(np.stack(strip)), t(np.stack(tirf)))


def jax_normal(shape, seed):
    """The float32 normals of jax.random.normal(PRNGKey(seed), shape)."""
    return torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed), shape, jnp.float32)))


@pytest.fixture
def jax_draws_in(monkeypatch):
    """The port's draw step replaced by the JAX package's draws: the
    simulation's uniforms from PRNGKey(seed), each photometry matrix's
    normals from PRNGKey(its seed)."""
    monkeypatch.setattr(port_sim, "draw_simulation",
                        lambda n, L, C, seed, device: jax_draws(seed, n, L,
                                                                C))
    monkeypatch.setattr(port_sim, "draw_normals",
                        lambda shape, seed, device: jax_normal(shape, seed))


CASES = {
    "one_label": (SEQ, {"K"}, 3, 8, CLI_PARAMS),
    "two_colours": (SEQ, {"C", "K"}, 3, 8, CLI_PARAMS),
    "no_labelled_residue": ("ADYEGHSAMR", {"K"}, 2, 5, CLI_PARAMS),
    "seq_len_1": ("K", {"K"}, 1, 4, CLI_PARAMS),
    "all_mocks": (SEQ, {"C", "K"}, 6, 0, CLI_PARAMS),
    "ideal": ("AXAXA", {"A"}, 2, 5, dict(p=1.0, b=0.0, u=0.0, s=0.0, sc=0,
                                         s2=0.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_from_draws_equals_the_jax_scan(case, jax_draws_in):
    seq, labels, mocks, edmans, params = CASES[case]
    N, seed = 700, 11
    want = jax_sim.simulate_dye_counts_batched(
        seq, labels, mocks, edmans, N, seed=seed, return_loss_cycles=True,
        **params)
    # x64 is on in this suite: the core compares float64 draws.
    assert port_sim.draw_simulation(2, 3, 1, 0, "cpu").dud.dtype == \
        torch.float64
    got = port_sim.simulate_dye_counts_batched(
        seq, labels, mocks, edmans, N, seed=seed, return_loss_cycles=True,
        device="cpu", **params)
    assert got[1] == want[1]
    for g, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    counts = got[0] if got[0].ndim == 3 else got[0][:, :, None]
    assert (np.diff(counts, axis=1) <= 0).all()
    if case == "ideal":  # each dye leaves at Edman cycle mocks + position
        assert port_sim.decrements_from_loss_cycles(seq, got[2][0],
                                                    got[3][0]) == \
            (("A", 3), ("A", 5), ("A", 7))
    if case == "no_labelled_residue":
        assert not got[0].any() and (got[2] == -1).all()


def test_photometries_on_the_same_normals(monkeypatch):
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 7, (3000, 12)).astype(np.int32)
    for ddif, seed in ((None, 1), (DDIF, 2), ((0.0, 0.3, 0.3), 3)):
        want = jax_sim.simulate_photometries_batched(
            counts, BETA, BETA_SIGMA, seed=seed, ddif=ddif)
        with monkeypatch.context() as m:
            m.setattr(port_sim, "draw_normals",
                      lambda shape, seed, device: jax_normal(shape, seed))
            got = port_sim.simulate_photometries_batched(
                counts, BETA, BETA_SIGMA, seed=seed, ddif=ddif,
                device="cpu")
        assert got.dtype == np.float64 and got.shape == counts.shape
        np.testing.assert_array_equal(got == 0, counts == 0)
        np.testing.assert_allclose(got, want, rtol=PHOT_RTOL)
    dev = port_sim.simulate_photometries_batched(
        torch.from_numpy(counts), BETA, BETA_SIGMA, seed=5, device_out=True)
    assert dev.dtype == torch.float32 and dev.device.type == "cpu"
    # The port's own generator: log-intensities of count n centre on
    # log(beta n) - ddif[n-1] with sd beta_sigma.
    big = np.full((20000, 1), 2, np.int32)
    vals = port_sim.simulate_photometries_batched(
        big, BETA, BETA_SIGMA, seed=1, ddif=(0.0, 0.3), device="cpu")
    assert abs(np.log(vals).mean() - (math.log(2 * BETA) - 0.3)) < 0.01
    assert abs(np.log(vals).std() - BETA_SIGMA) < 0.01


@pytest.mark.parametrize("labels", [{"K"}, {"C", "K"}])
def test_peptide_simulation_batched_on_the_same_draws(labels, jax_draws_in):
    N, seed, mocks, edmans = 400, 5, 3, 8
    want = jax_sim.peptide_simulation_batched(
        SEQ, labels, mocks, edmans, N, seed=seed, beta=BETA,
        beta_sigma=BETA_SIGMA, ddif=DDIF, **CLI_PARAMS)
    got = port_sim.peptide_simulation_batched(
        SEQ, labels, mocks, edmans, N, seed=seed, beta=BETA,
        beta_sigma=BETA_SIGMA, ddif=DDIF, device="cpu", **CLI_PARAMS)
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == w[1] and g[2] is w[2] is None
        assert sorted(g[3]) == sorted(w[3])
        for label in w[3]:
            (gc, (gi,)), (wc, (wi,)) = g[3][label], w[3][label]
            assert gc == wc
            assert all(type(x) is float for x in gi)
            np.testing.assert_allclose(gi, wi, rtol=PHOT_RTOL)
    if len(labels) == 1:
        old = port_sim_pkg.convert_to_oldstyle(got)
        assert list(old) == list(jax_sim_pkg.convert_to_oldstyle(got))
        assert 0 < len(old) < N


def _chained_kw(seed, N, labels, mocks=3, edmans=8):
    return dict(num_mocks=mocks, num_edmans=edmans, num_simulations=N,
                beta=BETA, beta_sigma=BETA_SIGMA, seed=seed, ddif=DDIF,
                **CLI_PARAMS)


@pytest.mark.parametrize("labels,N", [({"K"}, 1500), ({"C", "K"}, 600)])
def test_simulate_and_fit_batched_on_the_same_draws(labels, N,
                                                    jax_draws_in):
    seed = 7
    kw = _chained_kw(seed, N, labels)
    want = jax_sim.simulate_and_fit_batched(SEQ, labels, **kw)
    got = port_sim.simulate_and_fit_batched(
        SEQ, labels, device="cpu", fetch_intensities=True, **kw)
    for key in ("signals", "total_count", "none_count",
                "molecular_error_signals", "labels"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["counts"], want["counts"])
    assert got["counts"].dtype == np.int32
    assert sum(got["signals"].values()) + got["none_count"] == \
        got["total_count"] == N * len(labels)
    assert all(v.dtype == np.float32 and v.shape == (N, 12)
               for v in got["intensities"].values())
    if len(labels) == 1:
        assert sum(got["molecular_error_signals"].values()) == N
    else:
        assert got["molecular_error_signals"] is None
    # The chunk does not change the result.
    again = port_sim.simulate_and_fit_batched(
        SEQ, labels, device="cpu", chunk=256, error_signals=False, **kw)
    assert again["signals"] == got["signals"]
    assert again["molecular_error_signals"] is None


def test_chained_equals_two_step_in_the_port():
    """simulate_and_fit_batched against peptide_simulation_batched -> the
    photometries dict -> the port's v8 fit, on the port's own generator
    (the JAX package's test_simulate_and_fit_chained_equals_two_step)."""
    N, seed = 800, 5
    results = port_sim.peptide_simulation_batched(
        SEQ, {"K"}, num_mocks=3, num_edmans=8, num_simulations=N,
        seed=seed, beta=BETA, beta_sigma=BETA_SIGMA, ddif=DDIF,
        device="cpu", **CLI_PARAMS)
    mes2 = defaultdict(int)
    photometries = {"ch1": {0: {}}}
    t = 0
    for dye_decrements, dye_counts, _, ci in results:
        for label, (category, (intensities,)) in ci.items():
            photometries["ch1"][0].setdefault((t, t),
                                              (category, intensities, t))
            t += 1
        _, s = dye_counts.popitem()
        mes2[(dye_decrements, s[-1] == 0, s[0])] += 1
    signals2, total2, none2, _ = port_fit_v8(
        photometries, BETA, BETA_SIGMA, max_possible=5, allow_upsteps=False,
        allow_multidrop=True, max_deviation=3, quench_factors=DDIF,
        device="cpu")
    out = port_sim.simulate_and_fit_batched(
        SEQ, {"K"}, device="cpu", **_chained_kw(seed, N, {"K"}))
    assert out["total_count"] == total2 == N
    assert out["none_count"] == none2
    assert out["signals"] == signals2
    assert out["molecular_error_signals"] == dict(mes2)
    with pytest.raises(ValueError, match="ddif"):
        port_sim.simulate_and_fit_batched(
            "AKA", {"K"}, 1, 2, 10, beta=1e4, beta_sigma=0.2, ddif=[0.0],
            p=0.9, b=0.1, u=0.1, device="cpu")


def _tvd(a, b):
    keys = set(a) | set(b)
    na, nb = sum(a.values()), sum(b.values())
    return 0.5 * sum(abs(a.get(k, 0) / na - b.get(k, 0) / nb) for k in keys)


def _hist(*cols):
    out = defaultdict(int)
    for row in zip(*(c.tolist() for c in cols)):
        out[row] += 1
    return out


def test_own_generator_matches_the_jax_distributions():
    N, mocks, edmans = 20000, 3, 8
    want, _ = jax_sim.simulate_dye_counts_batched(
        SEQ, {"C", "K"}, mocks, edmans, N, seed=1, **CLI_PARAMS)
    got, labels = port_sim.simulate_dye_counts_batched(
        SEQ, {"C", "K"}, mocks, edmans, N, seed=2, device="cpu",
        **CLI_PARAMS)
    assert labels == ("C", "K") and got.shape == want.shape
    worst = 0.0
    for c in range(mocks + edmans + 1):
        for k in range(2):  # each colour's per-cycle count histogram
            worst = max(worst, _tvd(_hist(got[:, c, k]),
                                    _hist(want[:, c, k])))
        # the joint (C, K) distribution of the cycle
        worst = max(worst, _tvd(_hist(got[:, c, 0], got[:, c, 1]),
                                _hist(want[:, c, 0], want[:, c, 1])))
    assert worst < 0.03, worst

    # Strip correlates the colours: joint extinction exceeds the product of
    # the marginals, equally in both.
    def excess(x, c=4):  # cycle 4: the strip rate is 0.3 up to there
        a, b = x[:, c, 0] == 0, x[:, c, 1] == 0
        return np.mean(a & b) - np.mean(a) * np.mean(b)

    assert excess(want) > 0.005
    assert abs(excess(got) - excess(want)) < 0.01
    # Each labelled position's loss cycle, and whether a cycle-0 loss was a
    # dud (what dye_decrements are built from).
    _, _, loss_g, dud_g = port_sim.simulate_dye_counts_batched(
        SEQ, {"K"}, mocks, edmans, N, seed=3, device="cpu",
        return_loss_cycles=True, **CLI_PARAMS)
    _, _, loss_w, dud_w = jax_sim.simulate_dye_counts_batched(
        SEQ, {"K"}, mocks, edmans, N, seed=4, return_loss_cycles=True,
        **CLI_PARAMS)
    for i in [i for i, aa in enumerate(SEQ) if aa == "K"]:
        assert _tvd(_hist(loss_g[:, i], dud_g[:, i]),
                    _hist(loss_w[:, i], dud_w[:, i])) < 0.03
    # Reproducible on one machine: the same seed gives the same molecules.
    again, _ = port_sim.simulate_dye_counts_batched(
        SEQ, {"C", "K"}, mocks, edmans, N, seed=2, device="cpu",
        **CLI_PARAMS)
    np.testing.assert_array_equal(again, got)


WINDOWS = {"K": (1, 2, 3, 4), "C": (2, 4)}


def _leaves(trie):
    return sorted((sig, sorted(dict(count).items()))
                  for sig, count, _ in trie.leaf_iterator())


def test_randsiggen_and_simulate_signals_equal_the_jax_packages():
    peptide = ("AKCAK", "KC")
    for p, b, u in ((1.0, 0.0, 0.0), (0.9, 0.07, 0.1)):
        got = port_rsg.random_signal_batch(peptide, p, b, u, WINDOWS, 500,
                                           seed=99)
        assert got == jax_rsg.random_signal_batch(peptide, p, b, u, WINDOWS,
                                                  500, seed=99)
    assert set(got) != {got[0]}  # the stochastic case varies
    peptides = {"P1": (("AKCAK", "KC"), ("KKA", "")), "P2": (("CAK", "K"),)}
    kw = dict(sample_size=3000, random_seed=4)
    want = JaxPipeline().simulate_signals(peptides, 0.9, 0.05, 0.1, WINDOWS,
                                          **kw)
    pipe = Pipeline(device="cpu", profile=True)
    trie = pipe.simulate_signals(peptides, 0.9, 0.05, 0.1, WINDOWS, **kw)
    assert _leaves(trie) == _leaves(want) and len(_leaves(trie)) > 5
    assert _leaves(port_rsg.monte_carlo_trie_native(
        peptides, 0.9, 0.05, 0.1, WINDOWS, **kw)) == _leaves(trie)
    from fluorosequencingimageanalysis_torch.utils import profiling
    assert "api/simulate_signals" in profiling.timings()


def test_failed_randsiggen_build_raises_without_fallback(tmp_path,
                                                         monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "randsiggen.cpp").write_text("#error broken\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="failed to build randsiggen.cpp"):
        Pipeline(device="cpu").simulate_signals(
            {"P": (("AK", ""),)}, 0.9, 0.05, 0.1, WINDOWS, sample_size=10)
    assert not os.listdir(tmp_path / "_build")


def test_results_pickle_like_the_jax_packages(tmp_path):
    """peptide_simulation_batched's output round-trips through pickle with
    the JAX package's types (tuples of ints, bools and floats)."""
    res = port_sim.peptide_simulation_batched(
        "AXA", {"A"}, num_mocks=1, num_edmans=3, num_simulations=50,
        seed=4, p=0.95, b=0.02, u=0.05, s=0.0, sc=0, s2=0.0,
        beta=30000.0, beta_sigma=0.2, device="cpu")
    path = tmp_path / "r.pkl"
    path.write_bytes(pickle.dumps(res))
    back = pickle.loads(path.read_bytes())
    assert back == res
    decs, counts, buf, ci = back[0]
    assert isinstance(decs, tuple) and buf is None
    assert all(type(x) is int for x in counts["A"])
    category, (intens,) = ci["A"]
    assert all(type(x) is bool for x in category)
    for c, x in zip(counts["A"], intens):
        assert (c == 0) == (x == 0.0)
    # Without a card, the default device raises.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_sim.simulate_dye_counts_batched("AK", {"K"}, 1, 1, 4,
                                                 **CLI_PARAMS)
