"""The port's v8 scorer against the JAX package's, on the CPU.

The same numpy-seeded traces go through
``fluorosequencingimageanalysis_tpu.ops.lognormal`` (XLA on the CPU) and the
port's ``ops/lognormal.py``, whose CPU path is kernel C's plain twin
(``ops/fused_lognormal.py::v8_score_plain``). Stated tolerances:

- ``found``: equal exactly;
- ``best_logscore``: rtol 1e-6 + atol 2e-6 (float32 sums of at most 12
  terms taken in two orders: the twin adds in frame order, XLA's dot adds
  F*(K+1) terms, of which all but F are exact zeros, in its own order. The
  terms have both signs, +0.69 and down to -4.5 at 3 sigma, so a sum near
  zero carries the rounding of partial sums of magnitude 4 to 8: the
  absolute part is 4 float32 ulps there);
- winners: equal, except on traces whose two best valid keys lie within 4
  float32 ulps of each other in the port's own scores; those are counted
  (under 0.1% of the traces) and on them the JAX winner's score in the port
  equals the port's best within 4 ulps;
- the per-trace float64 host oracle: the same sequences, as the JAX
  package's own tests ask of its scorer;
- csrc/v8_score.cuh built with g++ (the kernel's walk, lanes in a loop)
  against the twin: bit for bit.
"""

import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fluorosequencingimageanalysis_tpu.inference import lognormal as jax_il
from fluorosequencingimageanalysis_tpu.ops import lognormal as jax_ln

from fluorosequencingimageanalysis_torch.inference import lognormal as il
from fluorosequencingimageanalysis_torch.ops import fused_lognormal as fl
from fluorosequencingimageanalysis_torch.ops import lognormal as ln
from fluorosequencingimageanalysis_torch.utils import synth

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

BETA = 30000.0
BETA_SIGMA = 0.2
CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "fluorosequencingimageanalysis_torch", "csrc")


def _lfm(max_possible=5):
    return [math.log(BETA) + math.log(i + 1.0)
            for i in range(max_possible + 2)]


def _workload(T, F, K, seed, spoil=True):
    """Lognormal ladders; with ``spoil``, a few zero, negative and far-off
    intensities and a few categories that contradict the ladder."""
    ints, cats, lfm = synth.make_v8_workload(T, F, K, seed=seed)
    if spoil:
        rng = np.random.default_rng(seed + 1000)
        rows = rng.choice(T, max(T // 20, 4), replace=False)
        q = len(rows) // 4
        ints[rows[:q], rng.integers(0, F, q)] = 0.0
        ints[rows[q:2 * q], rng.integers(0, F, q)] = -250.0
        ints[rows[2 * q:3 * q], rng.integers(0, F, q)] *= 40.0
        flip = rows[3 * q:]
        cats[flip, rng.integers(0, F, len(flip))] ^= True
    return ints, cats, lfm


def _port_scores(ints, cats, lfm, K, allow_multidrop, allow_upsteps,
                 max_deviation):
    """The port's own (T, S) raw scores and valid mask, from the twin's
    pieces (frame-ordered sums)."""
    F = ints.shape[1]
    log_int = np.where(ints > 0, np.log(np.maximum(ints, 1e-300)),
                       -10000.0).astype(np.float32)
    contrib, invalid = ln._contrib_invalid(
        torch.from_numpy(log_int), torch.from_numpy(cats),
        torch.from_numpy(np.asarray(lfm[:K], np.float32)), BETA_SIGMA,
        max_deviation)
    tab_t, seq_ok = ln.device_table(F, K, allow_upsteps, allow_multidrop,
                                    "cpu")
    idx = tab_t.long()
    acc = contrib[:, 0, idx[0]]
    viol = invalid[:, 0, idx[0]]
    for f in range(1, F):
        acc = acc + contrib[:, f, idx[f]]
        viol = viol | invalid[:, f, idx[f]]
    valid = ~viol & seq_ok.bool()[None]
    S = ln.sequence_table(F, K, allow_upsteps).shape[0]
    return acc.numpy()[:, :S], valid.numpy()[:, :S]


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


def _compare_with_jax(ints, cats, lfm, K, allow_multidrop=True,
                      allow_upsteps=False, max_deviation=3, chunk=None):
    kw = dict(log_fluor_means=lfm, beta_sigma=BETA_SIGMA, max_possible=K,
              allow_multidrop=allow_multidrop, allow_upsteps=allow_upsteps,
              max_deviation=max_deviation)
    want_seq, want_found, want_ls = jax_ln.score_traces(ints, cats,
                                                        chunk=512, **kw)
    got_seq, got_found, got_ls = ln.score_traces(ints, cats, chunk=chunk,
                                                 device="cpu", **kw)
    assert got_seq.shape == want_seq.shape and got_ls.dtype == np.float64
    np.testing.assert_array_equal(got_found, want_found)
    differ = np.nonzero((got_seq != want_seq).any(axis=1))[0]
    assert len(differ) < max(1e-3 * len(ints), 1), differ
    same = np.setdiff1d(np.arange(len(ints)), differ)
    np.testing.assert_allclose(got_ls[same], want_ls[same], rtol=1e-6,
                               atol=2e-6)
    if len(differ):
        # Near-ties only: the JAX winner scores within 4 ulps of the
        # port's best in the port's own arithmetic.
        scores, valid = _port_scores(ints[differ], cats[differ], lfm, K,
                                     allow_multidrop, allow_upsteps,
                                     max_deviation)
        tab = ln.sequence_table(ints.shape[1], K, allow_upsteps)
        for row, t in enumerate(differ):
            j = int(np.nonzero((tab == want_seq[t]).all(axis=1))[0][0])
            best = scores[row][valid[row]].max()
            assert valid[row, j] and _ulps(scores[row, j], best) <= 4, t
    return got_seq, got_found, got_ls


def test_sequence_table_and_seq_to_signal_equal_the_jax_packages():
    for args in [(4, 2, False), (12, 5, False), (6, 3, False), (4, 3, True),
                 (1, 5, False)]:
        got, want = ln.sequence_table(*args), jax_ln.sequence_table(*args)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert ln.sequence_table(12, 5).shape == (6188, 12)
    with pytest.raises(ValueError, match="intractable"):
        ln.sequence_table(12, 5, allow_upsteps=True)
    for seq in ([2, 2, 1, 0], [3, 1, 1, 1], [1, 1, 1], [0, 0], [1, 2, 0],
                [5]):
        assert ln.seq_to_signal(seq) == jax_ln.seq_to_signal(seq)
    assert ln.seq_to_signal([2, 2, 1, 0]) == ((("A", 2), ("A", 3)), True, 2)


@pytest.mark.parametrize("T,F,K,allow_multidrop", [
    (2000, 12, 5, True), (2000, 12, 5, False), (500, 6, 3, True),
    (500, 6, 3, False), (300, 4, 5, True), (300, 4, 5, False)])
def test_score_traces_matches_the_jax_scorer(T, F, K, allow_multidrop):
    ints, cats, lfm = _workload(T, F, K, seed=F * 10 + K)
    _, found, _ = _compare_with_jax(ints, cats, lfm, K,
                                    allow_multidrop=allow_multidrop)
    assert 0.5 < found.mean() < 1.0  # both outcomes are exercised


def test_score_traces_with_upsteps_matches_the_jax_scorer():
    ints, cats, lfm = _workload(200, 4, 3, seed=3)
    rng = np.random.default_rng(4)
    up = rng.choice(200, 40, replace=False)  # rows that step up once
    ints[up, 2] = np.exp(np.log(BETA * 3) + 0.05 * rng.normal(size=40))
    cats[up, 2] = True
    seqs, found, _ = _compare_with_jax(ints, cats, lfm, 3,
                                       allow_upsteps=True)
    assert (np.diff(seqs[found], axis=1) > 0).any()
    assert ln.sequence_table(4, 3, True).shape == (256, 4)


def test_contradicting_categories_give_index_zero_and_its_raw_score():
    """No valid sequence: found False, the first sequence and its raw
    score, as the JAX argmax over an all -inf row gives."""
    ints, cats, lfm = _workload(64, 6, 3, seed=9, spoil=False)
    cats[:, 0] = False  # a leading OFF frame before ON frames
    cats[:, 1] = True
    seqs, found, ls = _compare_with_jax(ints, cats, lfm, 3)
    assert not found.any()
    assert (seqs == ln.sequence_table(6, 3)[0]).all()
    scores, valid = _port_scores(ints, cats, lfm, 3, True, False, 3)
    assert not valid.any()
    np.testing.assert_array_equal(ls.astype(np.float32), scores[:, 0])


def test_zero_and_negative_intensities_and_a_huge_deviation_limit():
    """x = -10000 in an ON frame is invalid by the deviation limit; with
    the limit lifted its score near -1.25e9 is a valid key."""
    ints, cats, lfm = _workload(128, 6, 3, seed=11, spoil=False)
    ints[::3, 1] = 0.0
    ints[1::3, 2] = -17.0
    cats[:, :3] = True
    _, found, _ = _compare_with_jax(ints, cats, lfm, 3)
    assert not found[::3].any() and found[2::3].any()
    _, found, ls = _compare_with_jax(ints, cats, lfm, 3, max_deviation=1e9)
    assert found.all() and (ls[::3] < -1e8).all()


@pytest.mark.parametrize("chunk", [37, 128])
def test_results_do_not_depend_on_the_chunk(chunk):
    ints, cats, lfm = _workload(300, 6, 3, seed=21)  # 300 = 8 * 37 + 4
    kw = dict(log_fluor_means=lfm, beta_sigma=BETA_SIGMA, max_possible=3,
              device="cpu")
    whole = ln.score_traces(ints, cats, chunk=None, **kw)
    parts = ln.score_traces(ints, cats, chunk=chunk, **kw)
    for a, b in zip(whole, parts):
        np.testing.assert_array_equal(a, b)
    _compare_with_jax(ints, cats, lfm, 3, chunk=chunk)


def test_score_chunk_device_matches_the_jax_one():
    T, F, K = 400, 6, 3
    ints, cats, lfm = synth.make_v8_workload(T, F, K, seed=2)
    rng = np.random.default_rng(3)
    counts = np.where(cats, rng.integers(1, K + 1, (T, F)), 0)
    ints32 = ints.astype(np.float32)
    lfm32 = np.asarray(lfm[:K], np.float32)
    for allow_multidrop in (True, False):
        want = jax_ln.score_chunk_device(
            jnp.asarray(ints32), jnp.asarray(counts),
            jnp.asarray(jax_ln.sequence_table(F, K)), jnp.asarray(lfm32),
            BETA_SIGMA, 3.0, allow_multidrop)
        table = ln.device_table(F, K, False, allow_multidrop, "cpu")
        got = ln.score_chunk_device(
            torch.from_numpy(ints32), torch.from_numpy(counts), table,
            torch.from_numpy(lfm32), BETA_SIGMA, 3.0)
        assert all(isinstance(g, torch.Tensor) for g in got)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        # Both sides take the log in float32 here, and XLA's and torch's
        # logf may differ by an ulp of the log (9.5e-7 near 10.3): a
        # deviation d moves by that over sigma, its term by d times as
        # much, so F = 6 terms at d <= 3 move a score by up to 8.6e-5.
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-6, atol=1e-4)
    # The float32 log on the device agrees with score_traces' float64 log
    # on these separated ladders.
    seqs, found, _ = ln.score_traces(ints32, cats, lfm, BETA_SIGMA,
                                     max_possible=K, allow_multidrop=False,
                                     device="cpu")
    np.testing.assert_array_equal(found, got[1].numpy())
    np.testing.assert_array_equal(
        seqs, ln.sequence_table(F, K)[got[0].numpy()])


def test_short_log_fluor_means_and_wide_tables_raise():
    ints, cats, lfm = synth.make_v8_workload(4, 4, 3)
    with pytest.raises(ValueError, match="needs at least that many"):
        ln.score_traces(ints, cats, lfm[:2], BETA_SIGMA, max_possible=3,
                        device="cpu")
    with pytest.raises(ValueError, match="needs at least that many"):
        jax_ln.score_traces(ints, cats, lfm[:2], BETA_SIGMA, max_possible=3)
    with pytest.raises(ValueError, match="at most 255"):
        ln.device_table(1, 256, False, True, "cpu")
    with pytest.raises(ValueError, match="0..255"):
        fl.pack_table(np.array([[256, 0]]), True, "cpu")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    tab_t, seq_ok = fl.pack_table(ln.sequence_table(4, 2), False, "cpu")
    assert tab_t.shape == (4, 16) and seq_ok.shape == (16,)  # 15 -> 16
    assert seq_ok[15] == 0 and tab_t.dtype == torch.uint8
    drops = np.diff(ln.sequence_table(4, 2), axis=1).min(axis=1)
    np.testing.assert_array_equal(seq_ok[:15].numpy(), drops >= -1)
    contrib = torch.zeros((3, 4, 3))
    invalid = torch.zeros((3, 4, 3), dtype=torch.bool)
    idx, found, ls = fl.v8_score_fused(contrib, invalid, tab_t, seq_ok)
    assert idx.tolist() == [0, 0, 0] and found.all() and (ls == 0).all()
    assert fl.v8_score_fused.launches == 0  # the CPU never launches
    with pytest.raises(TypeError, match="float32"):
        fl.v8_score_fused(contrib.double(), invalid, tab_t, seq_ok)
    with pytest.raises(ValueError, match="pack_table"):
        fl.v8_score_fused(contrib, invalid, tab_t[:, :15], seq_ok[:15])
    with pytest.raises(ValueError, match="contrib and invalid"):
        fl.v8_score_fused(contrib, invalid[:2], tab_t, seq_ok)
    with pytest.raises(ValueError, match="unsupported device"):
        fl.v8_score_fused(contrib.to("meta"), invalid.to("meta"),
                          tab_t.to("meta"), seq_ok.to("meta"))


# -- mirrors of the JAX package's own scorer tests ---------------------------

def _simulate_trace(rng, seq):
    return [float(rng.lognormal(math.log(BETA) + math.log(v), BETA_SIGMA))
            if v > 0 else float(rng.normal(0, 100)) for v in seq]


def test_single_trace_v8_recovers_truth():
    rng = np.random.default_rng(0)
    truth = (2, 2, 1, 1, 0, 0)
    intensities = _simulate_trace(rng, truth)
    categories = tuple(v > 0 for v in truth)
    args = (intensities, BETA, BETA_SIGMA)
    kw = dict(max_possible=5, categories=categories, log_fluor_means=_lfm())
    got = il._intensities_to_signal_lognormal_v8(*args, **kw)
    assert got == jax_il._intensities_to_signal_lognormal_v8(*args, **kw)
    signal, is_zero, best_seq, _, _, _, si = got
    assert best_seq == truth and signal == (("A", 2), ("A", 4))
    assert is_zero is True and si == 2
    with pytest.raises(ValueError, match="categories required"):
        il._intensities_to_signal_lognormal_v8(*args, log_fluor_means=_lfm())
    with pytest.raises(ValueError, match="log_fluor_means"):
        il._intensities_to_signal_lognormal_v8(*args, categories=categories)


def test_batched_v8_matches_single_trace():
    rng = np.random.default_rng(1)
    lfm = _lfm()
    photometries = {"ch1": {0: {}}}
    expected = []
    for t in range(40):
        rng.integers(0, 4)
        seq = sorted(rng.integers(0, 4, 8), reverse=True)
        intensities = _simulate_trace(rng, seq)
        categories = tuple(v > 0 for v in seq)
        photometries["ch1"][0][(t, t)] = (categories, tuple(intensities), t)
        expected.append(il._intensities_to_signal_lognormal_v8(
            intensities, BETA, BETA_SIGMA, max_possible=5,
            categories=categories, log_fluor_means=lfm))
    signals, total, none_count, info = il.photometries_lognormal_fit_v8(
        photometries, BETA, BETA_SIGMA, max_possible=5,
        quench_factors=[0.0] * 7, device="cpu")
    assert total == 40
    by_hw = {(i[2], i[3]): i for i in info}
    exp_signals, exp_none = {}, 0
    for t, exp in enumerate(expected):
        got = by_hw[(t, t)]
        assert (got[7], got[8], got[9]) == (exp[0], exp[1], exp[2]), t
        if exp[4] > 0:
            np.testing.assert_allclose(got[11], exp[4], rtol=1e-4)
        if exp[0] is None:
            exp_none += 1
        else:
            key = (exp[0], exp[1], exp[6])
            exp_signals[key] = exp_signals.get(key, 0) + 1
    assert none_count == exp_none and signals == exp_signals


def test_batched_v8_no_multidrop_and_category_masks():
    rng = np.random.default_rng(2)
    lfm = _lfm()
    seq = (3, 3, 1, 1)  # allowed with multidrop, masked without
    ints = _simulate_trace(rng, seq)
    cats = tuple(v > 0 for v in seq)
    for allow_multidrop in (True, False):
        ref = il._intensities_to_signal_lognormal_v8(
            ints, BETA, BETA_SIGMA, categories=cats, log_fluor_means=lfm,
            allow_multidrop=allow_multidrop)
        seqs, found, _ = ln.score_traces(
            np.array([ints]), np.array([cats]), lfm, BETA_SIGMA,
            allow_multidrop=allow_multidrop, device="cpu")
        assert (ref[2] == seq) == allow_multidrop
        if ref[2] is None:
            assert not found[0]
        else:
            assert found[0] and tuple(seqs[0].tolist()) == ref[2]
            if not allow_multidrop:
                assert max(-np.diff(seqs[0])) <= 1


def test_v8_batched_matches_host_at_reference_shape():
    """Config-5 shape (n_cycles=12, max_fluors=5 -> 6,188 sequences/trace):
    the batched scorer agrees with the exact host loop trace for trace."""
    T, F, K = 300, 12, 5
    intensities, categories, lfm = synth.make_v8_workload(T, F, K, seed=5)
    seqs, found, _ = ln.score_traces(
        intensities, categories, log_fluor_means=lfm, beta_sigma=0.2,
        max_possible=K, allow_multidrop=True, max_deviation=3, chunk=128,
        device="cpu")
    n_checked = 0
    for i in range(T):
        ref_seq = il._intensities_to_signal_lognormal_v8(
            intensities[i].tolist(), beta=30000.0, beta_sigma=0.2,
            max_possible=K, allow_multidrop=True, max_deviation=3,
            categories=categories[i].tolist(),
            log_fluor_means=lfm.tolist())[2]
        if ref_seq is None:
            assert not found[i], i
            continue
        assert found[i], i
        assert tuple(int(v) for v in seqs[i]) == ref_seq, i
        n_checked += 1
    assert n_checked > 250  # nearly all traces must be fittable


def test_make_v8_workload_is_the_benchmarks():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_for_v8", os.path.join(os.path.dirname(__file__), os.pardir,
                                     "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for kw in (dict(T=50), dict(T=20, F=6, K=3, seed=4)):
        for a, b in zip(synth.make_v8_workload(**kw),
                        bench.make_v8_workload(**kw)):
            np.testing.assert_array_equal(a, b)


# -- csrc/v8_score.cuh built with g++ ------------------------------------------

HARNESS = r"""
#include <stdio.h>
#include <stdlib.h>
#include <vector>
#include "v8_score.cuh"

// stdin: int32 T, F, nv, S_pad; contrib (T*F*nv float32); invalid
// (T*F*nv bytes); tab_t (F*S_pad bytes); seq_ok (S_pad bytes).
// stdout per trace: int32 best_idx, int32 found, float32 best_logscore.
int main() {
  int hdr[4];
  if (fread(hdr, sizeof hdr, 1, stdin) != 1) return 2;
  const int T = hdr[0], F = hdr[1], nv = hdr[2], S_pad = hdr[3];
  const size_t n = (size_t)F * nv;
  std::vector<float> contrib(T * n);
  std::vector<uint8_t> invalid(T * n), tab_t((size_t)F * S_pad),
      seq_ok(S_pad);
  if (fread(contrib.data(), 4, contrib.size(), stdin) != contrib.size() ||
      fread(invalid.data(), 1, invalid.size(), stdin) != invalid.size() ||
      fread(tab_t.data(), 1, tab_t.size(), stdin) != tab_t.size() ||
      fread(seq_ok.data(), 1, seq_ok.size(), stdin) != seq_ok.size())
    return 3;
  std::vector<float> c(n);
  for (int t = 0; t < T; ++t) {
    for (size_t i = 0; i < n; ++i)
      c[i] = v8::mark(contrib[t * n + i], invalid[t * n + i]);
    v8::Best lanes[v8::LANES];
    for (int lane = 0; lane < v8::LANES; ++lane) {
      lanes[lane] = v8::none();
      v8::walk_lane(c.data(), tab_t.data(), seq_ok.data(), F, nv, S_pad,
                    lane, &lanes[lane]);
    }
    // The warp's shuffle tree: lane i takes lane i + off where it beats it.
    for (int off = v8::LANES / 2; off > 0; off >>= 1)
      for (int lane = 0; lane < off; ++lane)
        if (v8::beats(lanes[lane + off], lanes[lane]))
          lanes[lane] = lanes[lane + off];
    const v8::Best best = lanes[0];
    const int any = best.key > -INFINITY;
    const int idx = any ? best.idx : 0;
    const float score = any ? best.raw
                            : v8::raw_score(&contrib[t * n], tab_t.data(), F,
                                            nv, S_pad, 0);
    fwrite(&idx, 4, 1, stdout);
    fwrite(&any, 4, 1, stdout);
    fwrite(&score, 4, 1, stdout);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the v8_score.cuh harness")
    d = tmp_path_factory.mktemp("v8_score")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-I", CSRC, "-o",
         str(exe), str(src)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return str(exe)


@pytest.mark.parametrize("F,K,allow_multidrop,allow_upsteps", [
    (12, 5, True, False), (6, 3, False, False), (4, 3, True, True),
    (1, 5, True, False)])
def test_kernel_walk_equals_the_twin_bit_for_bit(harness, F, K,
                                                 allow_multidrop,
                                                 allow_upsteps):
    T = 256
    ints, cats, lfm = _workload(T, F, K, seed=F + K)
    cats[:8, 0] = False  # some traces with no valid sequence
    cats[:8, -1] = True
    if F > 1:
        # Exact ties: two frames swapped give equal sums in another order
        # only by luck, but equal traces in equal frames tie always.
        ints[8:16] = ints[8:16, :1]
    log_int = np.where(ints > 0, np.log(np.maximum(ints, 1e-300)),
                       -10000.0).astype(np.float32)
    contrib, invalid = ln._contrib_invalid(
        torch.from_numpy(log_int), torch.from_numpy(cats),
        torch.from_numpy(np.asarray(lfm[:K], np.float32)), BETA_SIGMA, 3.0)
    contrib[20:24, 0, 1] = float("nan")  # a NaN score is never valid
    tab_t, seq_ok = ln.device_table(F, K, allow_upsteps, allow_multidrop,
                                    "cpu")
    want = fl.v8_score_plain(contrib, invalid, tab_t, seq_ok)
    assert not want[2].isnan().any()
    blob = (np.array([T, F, K + 1, tab_t.shape[1]], np.int32).tobytes() +
            contrib.numpy().tobytes() +
            invalid.numpy().astype(np.uint8).tobytes() +
            tab_t.numpy().tobytes() + seq_ok.numpy().tobytes())
    proc = subprocess.run([harness], input=blob, capture_output=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = np.frombuffer(proc.stdout, dtype=np.int32).reshape(T, 3)
    np.testing.assert_array_equal(out[:, 0], want[0].numpy())
    np.testing.assert_array_equal(out[:, 1].astype(bool), want[1].numpy())
    np.testing.assert_array_equal(
        out[:, 2].copy().view(np.float32).view(np.int32),
        want[2].numpy().view(np.int32))
    assert 0 < want[1].float().mean() < 1
