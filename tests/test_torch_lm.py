"""Port parity: the LM fit and kernel B's plain twin vs the JAX package.

Float64 runs check that the algorithm is the same step for step; float32
runs check converged quantities. Theta is degenerate for round spots and
(sh, sw, theta) == (sw, sh, theta + 90), so float32 comparisons use the
centers, R^2 and the 5x5 model image, not theta or the sigmas.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluorosequencingimageanalysis_tpu.models.detect import (
    _fit_quality_core as jax_fit_quality_core)
from fluorosequencingimageanalysis_tpu.ops import candidates as jc
from fluorosequencingimageanalysis_tpu.ops import lm as jlm

from fluorosequencingimageanalysis_torch.ops import lm as tlm
from fluorosequencingimageanalysis_torch.ops.candidates import gather_patches
from fluorosequencingimageanalysis_torch.ops.fused_fit import (
    fit_quality, fit_quality_plain)
from fluorosequencingimageanalysis_torch.ops.gaussian import gauss2d_image
from fluorosequencingimageanalysis_torch.utils.synth import make_stack

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host


def _t(x):
    return torch.tensor(np.asarray(x))


def _patches(n, seed, noise_only=8):
    """Planted 5x5 spots (round and elliptical, centers over the whole
    bounded range and past it), plus noise-only and one flat patch."""
    rng = np.random.default_rng(seed)
    hh, ww = np.mgrid[0:5, 0:5]
    ch = rng.uniform(1.6, 3.4, n)[:, None, None]
    cw = rng.uniform(1.6, 3.4, n)[:, None, None]
    amp = rng.uniform(500, 4000, n)[:, None, None]
    s = rng.uniform(0.9, 1.6, (n, 2))
    p = 400 + amp * np.exp(-(hh - ch) ** 2 / (2 * s[:, 0, None, None] ** 2)
                           - (ww - cw) ** 2 / (2 * s[:, 1, None, None] ** 2))
    p = p + rng.normal(0, 8, (n, 5, 5))
    p[-noise_only:] = rng.normal(400, 8, (noise_only, 5, 5))
    p[-1] = 400.0
    return p


def _model(params):
    return gauss2d_image(_t(np.asarray(params, np.float64)),
                         dtype=torch.float64).numpy()


def test_init_and_bounds_match_jax():
    # float64: the median is a selection, the mean a 25-term sum.
    x = _patches(64, seed=0)
    np.testing.assert_allclose(tlm.default_fit_init(_t(x)).numpy(),
                               np.asarray(jlm.default_fit_init(
                                   jnp.asarray(x))), rtol=1e-13)
    for g, r in zip(tlm.default_fit_bounds(_t(x)),
                    jlm.default_fit_bounds(jnp.asarray(x))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)


def test_model_jacobian_and_cholesky_match_jax():
    rng = np.random.default_rng(1)
    n = 50
    p = [rng.uniform(0.1, 0.3, n), rng.uniform(0.5, 1.0, n),
         rng.uniform(2, 3, n), rng.uniform(2, 3, n),
         rng.uniform(0.75, 2, n), rng.uniform(0.75, 2, n),
         rng.uniform(0, 360, n)]
    idx = np.arange(25)
    hg = (idx // 5).astype(np.float64)[:, None]
    wg = (idx % 5).astype(np.float64)[:, None]
    mj, Jj = jlm._model_and_jac([jnp.asarray(a) for a in p],
                                jnp.asarray(hg), jnp.asarray(wg))
    mt, Jt = tlm._model_and_jac([_t(a) for a in p], _t(hg), _t(wg))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-13)
    for a, b in zip(Jt, Jj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-11,
                                   atol=1e-14)
    M = rng.normal(size=(n, 7, 7))
    A = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(7)
    g = rng.normal(size=(n, 7))
    xs_j = jlm._cholesky_solve_7(
        [[jnp.asarray(A[:, i, j]) for j in range(7)] for i in range(7)],
        [jnp.asarray(g[:, i]) for i in range(7)])
    xs_t = tlm._cholesky_solve_7(
        [[_t(A[:, i, j]) for j in range(7)] for i in range(7)],
        [_t(g[:, i]) for i in range(7)])
    np.testing.assert_allclose(np.stack([x.numpy() for x in xs_t], -1),
                               np.stack([np.asarray(x) for x in xs_j], -1),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.stack([x.numpy() for x in xs_t], -1),
                               np.linalg.solve(A, g[..., None])[..., 0],
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("theta_starts", [1, 2])
def test_lm_float64_is_the_same_algorithm(theta_starts):
    """float64 on both sides, 4 iterations: every pegging, damping, clip
    and accept/reject decision is taken the same way, so the fits agree to
    1e-9 relative. (Later iterations near convergence accept steps that
    change the cost by ~1 ulp, so either side may take one the other
    refuses; see the float32 test for converged parity.) The theta0 = 90
    restart's winner is decided by costs that tie to the last ulp, so with
    two starts the sigmas/theta are compared through the model image."""
    x = _patches(256, seed=2)
    pj, cj = jlm.fit_gaussians_batched(jnp.asarray(x), num_iters=4,
                                       theta_starts=theta_starts)
    pt, ct = tlm.fit_gaussians_batched(_t(x), num_iters=4,
                                       theta_starts=theta_starts)
    pj, pt = np.asarray(pj), pt.numpy()
    cols = slice(None) if theta_starts == 1 else slice(0, 4)
    np.testing.assert_allclose(pt[:, cols], pj[:, cols], rtol=1e-9,
                               atol=1e-12)
    # Costs in raw units^2 (~1e3-1e5 here; ~1e-14 for the flat patch).
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-9,
                               atol=1e-9)
    mj, mt = _model(pj), _model(pt)
    np.testing.assert_allclose(mt, mj, rtol=1e-9)


@pytest.mark.parametrize("theta_starts", [1, 2])
def test_lm_float32_converged_parity(theta_starts):
    # float32, 20 iterations: centers within 1e-3 px and the model image
    # within 1e-3 x the patch max, on the planted spots.
    x = _patches(256, seed=3).astype(np.float32)
    pj, _ = jlm.fit_gaussians_batched(jnp.asarray(x), num_iters=20,
                                      theta_starts=theta_starts)
    pt, _ = tlm.fit_gaussians_batched(_t(x), num_iters=20,
                                      theta_starts=theta_starts)
    pj, pt = np.asarray(pj)[:-8], pt.numpy()[:-8]
    np.testing.assert_allclose(pt[:, 2:4], pj[:, 2:4], atol=1e-3)
    err = np.abs(_model(pt) - _model(pj)).max(axis=(1, 2))
    assert np.all(err <= 1e-3 * np.abs(x[:-8]).max(axis=(1, 2)))


def test_lm_integer_patches_fit_in_float32():
    x = np.round(_patches(16, seed=4, noise_only=1)).astype(np.int32)
    pt, _ = tlm.fit_gaussians_batched(_t(x), num_iters=5)
    assert pt.dtype == torch.float32
    pj, _ = jlm.fit_gaussians_batched(jnp.asarray(x), num_iters=5)
    np.testing.assert_allclose(pt.numpy()[:, 2:4], np.asarray(pj)[:, 2:4],
                               atol=1e-3)


@pytest.mark.parametrize("theta_starts", [1, 2])
def test_kernel_b_twin_matches_jax_fit_quality_core(theta_starts):
    """fit_quality_plain (kernel B's twin) against the JAX composition
    _fit_quality_core(..., gather_strategy='gather') on every candidate of
    two planted 128x128 images: where valid and R^2 >= 0.7, centers within
    1e-3 px, R^2 within 1e-4, RMSE within 1e-4 relative (a converged
    residual, like R^2) and the 5x5 model image within 1e-3 x the patch
    max; S/N (no fit involved) to float32 rounding."""
    stack, _ = make_stack(1, 2, 128, 128, spots_per_field=25, seed=3)
    imgs = stack.reshape(2, 128, 128)
    hs, ws, valid, _ = [np.asarray(a) for a in jc.find_candidates_batch(
        jnp.asarray(imgs), max_candidates=128)]
    ref = [np.asarray(a) for a in jax_fit_quality_core(
        jnp.asarray(imgs), jnp.asarray(hs), jnp.asarray(ws), 20,
        theta_starts, "gather")]
    before = fit_quality.launches
    got = [a.numpy() for a in fit_quality(_t(imgs), _t(hs), _t(ws), 20,
                                          theta_starts)]
    assert fit_quality.launches == before  # the twin ran, not a kernel
    assert [g.shape for g in got] == [r.shape for r in ref]
    m = valid & (ref[4] >= 0.7)
    assert m.sum() > 100
    np.testing.assert_allclose(got[1][m], ref[1][m], atol=1e-3)
    np.testing.assert_allclose(got[2][m], ref[2][m], atol=1e-3)
    np.testing.assert_allclose(got[3][m], ref[3][m], rtol=1e-4)
    np.testing.assert_allclose(got[4][m], ref[4][m], atol=1e-4)
    np.testing.assert_allclose(got[5][valid], ref[5][valid], rtol=1e-5)
    patches = gather_patches(_t(imgs), _t(hs), _t(ws)).numpy()[m]
    err = np.abs(_model(got[0][m]) - _model(ref[0][m])).max(axis=(1, 2))
    assert np.all(err <= 1e-3 * np.abs(patches).max(axis=(1, 2)))
    # The wrapper on CPU is exactly the twin.
    twin = fit_quality_plain(_t(imgs), _t(hs), _t(ws), 20, theta_starts)
    for a, b in zip(got, twin):
        np.testing.assert_array_equal(a, b.numpy())
