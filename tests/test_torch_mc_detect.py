"""Port parity: the Monte-Carlo detector (``find_peptides(fit_type=
"monte_carlo")``), its pieces, and kernel D's body built with g++.

The JAX package draws its samples from ``jax.random``; the tests rebuild
those normals (``split(PRNGKey(rng_seed), 6)``, float32, shape (N_iter, K))
and hand them to the port. Tolerances:

- candidates, validity, counts, keep masks, psfs keys and their order, the
  consolidation with the candidate-window gate: equal;
- the best sample's parameters: within 1e-6 + 1e-6 relative. XLA folds the
  sample transforms into the normal's own scaling (``0.3 * sqrt(2) *
  erfinv(u)``), so the sampled values of the two packages are an ulp
  apart; a *different* winning sample (a flip) is allowed only where the
  two winners' float64 norms tie within 1e-5 (none occurs on these seeds);
- R^2, RMSE, S/N and the psfs' floats: rtol 1e-5, atol 1e-5 (a sharp
  sample, sigma_h near 0.1, amplifies an ulp of a parameter by 1/(2
  sigma_h^2) in the model);
- kernel D's per-sample body (csrc/mc_fit.cuh), built with g++, against
  ``ops/mc_fit.py::mc_fit_plain``: the best 6-vector and norm bit for bit.
  Both sides take the same stand-in for exp, ``1 / (1 - x)`` (decreasing
  to 0 at -inf like exp, and rounded alike by IEEE arithmetic on both):
  the host's ``expf`` and torch's CPU ``exp`` (vectorised or not) round
  some arguments apart, while on the card ``expf`` is what torch's exp
  computes, which chip_smoke.py and the card tests hold.
"""

import logging
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluorosequencingimageanalysis_tpu.models import detect as jax_detect
from fluorosequencingimageanalysis_tpu.ops import candidates as jax_cand
from fluorosequencingimageanalysis_tpu.ops import consolidate as jax_cons

from fluorosequencingimageanalysis_torch import _build
from fluorosequencingimageanalysis_torch.models import detect as port_detect
from fluorosequencingimageanalysis_torch.ops import candidates as port_cand
from fluorosequencingimageanalysis_torch.ops import consolidate as port_cons
from fluorosequencingimageanalysis_torch.ops import fused_mc_fit, mc_fit

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

PARAM_ATOL = PARAM_RTOL = 1e-6
QUALITY_TOL = dict(rtol=1e-5, atol=1e-5)
TIE_REL = 1e-5


def _field(seed, H, W, n_spots, noise=6.0):
    """Planted Gaussian spots (sigma 1.2) on N(400, noise); spot 1 sits
    2.9 px from spot 0, so consolidation has a pair to decide."""
    rng = np.random.default_rng(seed)
    yy, xx = np.indices((H, W)).astype(np.float64)
    img = rng.normal(400.0, noise, (H, W))
    pos = rng.uniform(6, min(H, W) - 6, (n_spots, 2))
    pos[1] = pos[0] + [2.5, 1.5]
    for (h, w), a in zip(pos, rng.uniform(1500, 4000, n_spots)):
        img += a * np.exp(-((yy - h) ** 2 + (xx - w) ** 2) / (2 * 1.2 ** 2))
    return img.astype(np.float32)


def _image(name):
    if name == "constant":
        return np.full((40, 40), 100.0, np.float32)
    if name == "flat_patch":  # a saturated block: constant 5x5 patches
        img = _field(3, 64, 64, 8)
        img[20:40, 20:40] = 500.0
        return img
    size = {"f64": 64, "f96": 96, "f128": 128}[name]
    return _field(size, size, size, size * size // 400)


def jax_normals(rng_seed, n_iter, K):
    keys = jax.random.split(jax.random.PRNGKey(rng_seed), 6)
    return np.stack([np.asarray(jax.random.normal(k, (n_iter, K),
                                                  jnp.float32))
                     for k in keys])


def _norm64(patch, p):
    """The float64 norm of one 6-vector's normalised model against a
    normalised patch."""
    hg, wg = np.meshgrid(np.arange(5.0), np.arange(5.0), indexing="ij")
    p = p.astype(np.float64)
    g = p[1] * np.exp(-((hg - p[2]) ** 2 + (wg - p[3]) ** 2)
                      / (2 * p[4] ** 2)) + p[0]
    return np.sqrt(((patch - g / g.max()) ** 2).sum())


@pytest.mark.parametrize("name,K,n_iter,seed", [
    ("f64", 256, 300, 3), ("f96", 128, 200, 0), ("f128", 512, 100, 1),
    ("constant", 128, 60, 2), ("flat_patch", 256, 150, 4)])
def test_detect_and_fit_monte_carlo_on_the_jax_draws(name, K, n_iter, seed):
    img = _image(name)
    want = jax_detect._detect_and_fit_monte_carlo(
        jnp.asarray(img), max_candidates=K, n_iter=n_iter, rng_seed=seed)
    got = port_detect._detect_and_fit_monte_carlo(
        torch.from_numpy(img), max_candidates=K, n_iter=n_iter,
        normals=jax_normals(seed, n_iter, K))
    want = {f: np.asarray(getattr(want, f)) for f in want._fields}
    got = {f: getattr(got, f).numpy() for f in got._fields}
    for f in ("cand_h", "cand_w", "cand_valid", "cand_count", "keep"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    a, b = want["params"], got["params"]
    assert (b[:, 6] == 0).all() and got["params"].dtype == np.float32
    flip = want["cand_valid"] & (np.abs(a - b) > 1e-5 * np.abs(a)
                                 + 1e-5).any(axis=1)
    patches = mc_fit.normalise_patches(port_cand.gather_patches(
        torch.from_numpy(img), torch.from_numpy(got["cand_h"]),
        torch.from_numpy(got["cand_w"]))).numpy().astype(np.float64)
    for i in np.nonzero(flip)[0]:  # a different winner must be a tie
        na, nb = _norm64(patches[i], a[i]), _norm64(patches[i], b[i])
        assert abs(na - nb) <= TIE_REL * max(na, nb), (i, na, nb)
    assert flip.mean() < 0.02
    same = ~flip
    np.testing.assert_allclose(b[same], a[same], rtol=PARAM_RTOL,
                               atol=PARAM_ATOL)
    for f in ("r2", "rmse", "s_n", "center_h", "center_w"):
        np.testing.assert_allclose(got[f][same], want[f][same],
                                   err_msg=f, **QUALITY_TOL)
    if name == "constant":
        # Every patch normalises to 0/1e-12 = 0: S/N is 0/0 = NaN and R^2
        # is 1 - residual/0 = -inf in both packages, so nothing is kept.
        assert np.isnan(got["s_n"]).all() and np.isneginf(got["r2"]).all()
        assert not got["keep"].any()
    else:
        assert got["keep"].sum() >= 5


def test_find_peptides_monte_carlo_equals_the_jax_packages(monkeypatch,
                                                           caplog):
    img = np.clip(_field(5, 96, 96, 16), 0, 65535).astype(np.uint16)
    kw = dict(fit_type="monte_carlo", N_iter=120, max_candidates=256,
              rng_seed=9)
    monkeypatch.setattr(port_detect, "draw_mc_normals",
                        lambda n_iter, n, seed, device: torch.from_numpy(
                            jax_normals(seed, n_iter, n)).to(device))
    want = jax_detect.find_peptides(img, **kw)
    got = port_detect.find_peptides(img, device="cpu", **kw)
    assert list(got) == list(want) and len(got) >= 8
    for key in want:
        g, w = got[key], want[key]
        np.testing.assert_allclose(g[:7], w[:7], **QUALITY_TOL)
        assert g[7].dtype == np.float64 and g[7].shape == (5, 5)
        np.testing.assert_array_equal(g[7], w[7])  # the normalised patch
        np.testing.assert_allclose(g[8], w[8], **QUALITY_TOL)
        np.testing.assert_allclose(g[9:], w[9:], **QUALITY_TOL)
        assert g[6] == 0.0
    # None keeps the 4096 cap; above it the call warns.
    with caplog.at_level(logging.WARNING):
        port_detect.find_peptides(img, fit_type="monte_carlo", N_iter=4,
                                  max_candidates=16, device="cpu")
    assert any("exceed max_candidates=16" in r.message
               for r in caplog.records)
    calls = []
    monkeypatch.setattr(port_detect, "draw_mc_normals",
                        lambda n_iter, n, seed, device: calls.append(
                            (n_iter, n, seed)) or torch.zeros(
                                (6, n_iter, n), device=device))
    port_detect.find_peptides(img, fit_type="monte_carlo", N_iter=3,
                              device="cpu")
    assert calls == [(3, 4096, 0)]


def test_own_generator_is_seeded_and_finds_the_spots():
    img = _field(6, 96, 96, 16)
    kw = dict(fit_type="monte_carlo", N_iter=150, max_candidates=256,
              device="cpu")
    a = port_detect.find_peptides(img, rng_seed=1, **kw)
    b = port_detect.find_peptides(img, rng_seed=1, **kw)
    c = port_detect.find_peptides(img, rng_seed=2, **kw)
    assert list(a) == list(b) and len(a) >= 10
    assert all(a[k][2] == b[k][2] for k in a)
    assert any(a[k][2] != c[k][2] for k in a if k in c)
    ref = jax_detect.find_peptides(img, fit_type="monte_carlo", N_iter=150,
                                   max_candidates=256, rng_seed=1)
    # Other draws, the same spots: most keys agree.
    assert len(set(a) & set(ref)) >= 0.8 * len(ref)


def test_find_candidates_equals_the_jax_packages():
    for name, K in (("f64", 64), ("f96", 512), ("constant", 32)):
        img = _image(name)
        want = jax_cand.find_candidates(jnp.asarray(img),
                                        max_candidates=K)
        got = port_cand.find_candidates(torch.from_numpy(img),
                                        max_candidates=K)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[0].shape == (K,) and got[3].shape == ()


@pytest.mark.parametrize("n,radius,seed", [(60, 4.0, 0), (200, 4.0, 1),
                                           (150, 2.5, 2), (1, 4.0, 3)])
def test_consolidate_window_gate_equals_the_jax_packages(n, radius, seed):
    rng = np.random.default_rng(seed)
    cand_h = rng.integers(2, 40, n).astype(np.float32)
    cand_w = rng.integers(2, 40, n).astype(np.float32)
    # Monte-Carlo centers drift up to 2.5 px from their candidates.
    ch = (cand_h + rng.uniform(-2.5, 2.5, n)).astype(np.float32)
    cw = (cand_w + rng.uniform(-2.5, 2.5, n)).astype(np.float32)
    r2 = rng.uniform(0, 1, n).astype(np.float32)
    r2[::7] = np.nan
    valid = rng.uniform(size=n) < 0.9
    for gate in (True, False):
        extra = dict(cand_h=cand_h, cand_w=cand_w) if gate else {}
        want = np.asarray(jax_cons.consolidate(
            jnp.asarray(ch), jnp.asarray(cw), jnp.asarray(r2),
            jnp.asarray(valid), radius=radius,
            **{k: jnp.asarray(v) for k, v in extra.items()}))
        got = port_cons.consolidate(
            torch.from_numpy(ch), torch.from_numpy(cw), torch.from_numpy(r2),
            torch.from_numpy(valid), radius=radius,
            **{k: torch.from_numpy(v) for k, v in extra.items()}).numpy()
        np.testing.assert_array_equal(got, want)
        # Batched: two images in one call equal two calls.
        stacked = port_cons.consolidate(
            *(torch.from_numpy(np.stack([x, x[::-1].copy()]))
              for x in (ch, cw, r2, valid)), radius=radius,
            **{k: torch.from_numpy(np.stack([v, v[::-1].copy()]))
               for k, v in extra.items()}).numpy()
        np.testing.assert_array_equal(stacked[0], want)

    # Two fits 3 px apart whose candidates lie 7 px apart: rivals without
    # the gate, both kept with it (radius 4: window 6).
    two = [torch.tensor(v, dtype=torch.float32) for v in
           ([10.0, 10.0], [10.0, 13.0], [0.9, 0.8])]
    ok = torch.tensor([True, True])
    cands = dict(cand_h=torch.tensor([10.0, 10.0]),
                 cand_w=torch.tensor([8.0, 15.0]))
    assert port_cons.consolidate(*two, ok).tolist() == [True, False]
    assert port_cons.consolidate(*two, ok, **cands).tolist() == [True, True]
    assert np.asarray(jax_cons.consolidate(
        *(jnp.asarray(t.numpy()) for t in (*two, ok)),
        **{k: jnp.asarray(v.numpy()) for k, v in cands.items()})).tolist() \
        == [True, True]


def test_mc_pieces_equal_the_jax_packages():
    rng = np.random.default_rng(0)
    raw = rng.normal(400, 30, (64, 5, 5)).astype(np.float32)
    raw[3] = 7.0  # a constant patch
    got = mc_fit.normalise_patches(torch.from_numpy(raw)).numpy()
    assert (got[3] == 0).all() and got.max() == 1.0
    p = np.abs(rng.normal(1, 0.5, (64, 6))).astype(np.float32)
    hg, wg = jnp.meshgrid(jnp.arange(5, dtype=jnp.float32),
                          jnp.arange(5, dtype=jnp.float32), indexing="ij")
    want = np.asarray(jax_detect._mc_model(jnp.asarray(p), hg, wg))
    th, tw = mc_fit.grids(torch.float32, "cpu")
    model = mc_fit.mc_model(torch.from_numpy(p), th, tw).numpy()
    np.testing.assert_allclose(model, want, rtol=1e-6)
    np.testing.assert_allclose(port_detect._mc_fit_image(p[0]),
                               jax_detect._mc_fit_image(p[0]), rtol=1e-12)
    z = rng.normal(size=(6, 10, 64)).astype(np.float32)
    s = mc_fit.sample_params(torch.from_numpy(got), torch.from_numpy(z))
    assert s.shape == (6, 10, 64)
    assert (s[2:4] >= 0.01).all() and (s[2:4] <= 4.99).all()
    assert (s[[0, 1, 4, 5]] >= 0).all()


# -- csrc/mc_fit.cuh built with g++ -------------------------------------------

HARNESS = r"""
#include <math.h>
#include <stdio.h>
#include <vector>
#include "mc_fit.cuh"

struct HostExp {  // the test's stand-in for exp, as the twin's
  float operator()(float x) const { return 1.0f / (1.0f - x); }
};
struct HostLoad {
  float operator()(const float* p) const { return *p; }
};

// stdin: int32 K, n_iter, parts; patches (K*25 float32); samples
// (6*n_iter*K float32). stdout per candidate: 6 float32 params, the norm.
// The sample ranges of the kernel's warps, merged in range order.
int main() {
  int hdr[3];
  if (fread(hdr, sizeof hdr, 1, stdin) != 1) return 2;
  const int K = hdr[0], n_iter = hdr[1], parts = hdr[2];
  std::vector<float> patches((size_t)K * mc::NPIX);
  std::vector<float> samples((size_t)6 * n_iter * K);
  if (fread(patches.data(), 4, patches.size(), stdin) != patches.size() ||
      fread(samples.data(), 4, samples.size(), stdin) != samples.size())
    return 3;
  const float* planes[mc::NPARAM];
  for (int q = 0; q < mc::NPARAM; ++q)
    planes[q] = samples.data() + (size_t)q * n_iter * K;
  for (int k = 0; k < K; ++k) {
    mc::Best best = mc::none();
    for (int w = 0; w < parts; ++w) {
      mc::Best part = mc::none();
      const int s0 = (int)((long long)n_iter * w / parts);
      const int s1 = (int)((long long)n_iter * (w + 1) / parts);
      mc::scan(&patches[(size_t)k * mc::NPIX], planes, K, k, s0, s1,
               HostExp(), HostLoad(), &part);
      if (w == 0 || mc::better(part, best)) best = part;
    }
    fwrite(best.p, 4, mc::NPARAM, stdout);
    fwrite(&best.norm, 4, 1, stdout);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the mc_fit.cuh harness")
    d = tmp_path_factory.mktemp("mc_fit")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-I", _build.CSRC,
         "-o", str(exe), str(src)], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    return str(exe)


def _exp_stand_in(t):
    return 1.0 / (1.0 - t)


@pytest.mark.parametrize("K,n_iter,parts,seed", [
    (96, 200, 16, 0), (33, 61, 4, 1), (40, 7, 1, 2), (17, 3, 16, 3)])
def test_kernel_body_equals_the_twin_bit_for_bit(harness, K, n_iter, parts,
                                                 seed):
    rng = np.random.default_rng(seed)
    img = _field(seed, 64, 64, 12)
    hs = torch.from_numpy(rng.integers(2, 62, K).astype(np.int32))
    ws = torch.from_numpy(rng.integers(2, 62, K).astype(np.int32))
    patches = mc_fit.normalise_patches(port_cand.gather_patches(
        torch.from_numpy(img), hs, ws))
    patches[0] = 0.0            # a constant patch, normalised
    patches[1, 2, 2] = np.nan   # a NaN pixel: no sample wins
    z = torch.from_numpy(rng.normal(size=(6, n_iter, K)).astype(np.float32))
    samples = mc_fit.sample_params(patches, z).contiguous()
    if n_iter > 3:
        # Exact ties: every sample of candidates 5-8 has sample 0's model
        # (sigma_w, slot 5, is not in it), so sample 0 must win.
        samples[:5, :, 5:9] = samples[:5, :1, 5:9]
        samples[4, 0, 9:11] = 0.0                # sigma_h = 0
        samples[4, :, 11] = 0.0
        samples[2:4, :, 11] = 2.0                # and on a pixel: NaN
    want_p, want_n = mc_fit.mc_fit_plain(patches, samples, exp=_exp_stand_in)
    blob = (np.array([K, n_iter, parts], np.int32).tobytes() +
            patches.numpy().tobytes() + samples.numpy().tobytes())
    proc = subprocess.run([harness], input=blob, capture_output=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = np.frombuffer(proc.stdout, dtype=np.float32).reshape(K, 7)
    np.testing.assert_array_equal(out[:, :6].view(np.int32),
                                  want_p.numpy().view(np.int32))
    np.testing.assert_array_equal(out[:, 6].view(np.int32),
                                  want_n.numpy().view(np.int32))
    if n_iter > 3:
        assert torch.equal(want_p[5:9, 5], samples[5, 0, 5:9])
    nan_everywhere = [1, 11] if n_iter > 3 else [1]
    assert np.isinf(want_n[nan_everywhere]).all()
    assert (want_p[nan_everywhere] == 0).all()
    rest = np.setdiff1d(np.arange(K), nan_everywhere)
    assert np.isfinite(want_n[rest].numpy()).all()


def test_mc_fit_wrapper_takes_the_twin_on_the_cpu_and_checks_shapes():
    rng = np.random.default_rng(0)
    patches = torch.from_numpy(rng.uniform(0, 1, (8, 5, 5))
                               .astype(np.float32))
    samples = torch.from_numpy(np.abs(rng.normal(1, 0.3, (6, 12, 8)))
                               .astype(np.float32))
    before = fused_mc_fit.mc_fit.launches
    got = fused_mc_fit.mc_fit(patches, samples)
    want = mc_fit.mc_fit_plain(patches, samples)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fused_mc_fit.mc_fit.launches == before  # no launch on the CPU
    with pytest.raises(ValueError, match="patches"):
        fused_mc_fit.mc_fit(patches[:, :4], samples)
    with pytest.raises(ValueError, match="samples"):
        fused_mc_fit.mc_fit(patches, samples[:, :, :7])
    with pytest.raises(ValueError, match="device"):
        fused_mc_fit.mc_fit(patches.to("meta"), samples.to("meta"))
