"""Port parity: ``mpfit_compat`` vs the JAX package's, and the port's
batched LM (``ops/lm.py``) held directly against the vendored reference
mpfit (tests/mpfit_oracle.py).

``mpfit_compat`` is a host copy, so every result attribute must be equal
on every problem. The LM is held against mpfit as tests/test_mpfit_parity.py
holds the JAX package's (see its docstring for why parity is cost
domination plus parameter agreement where both optimizers converge): on a
smaller battery here, with the same per-patch bounds.
"""

import numpy as np
import pytest
import torch

import mpfit_oracle
from oracles import gauss2d_oracle
from test_mpfit_parity import (_expdecay_fcn, _patch_battery, canonicalize,
                               mpfit_reference_fit, pegged_mask)

from fluorosequencingimageanalysis_tpu import mpfit_compat as jax_mpfit
from fluorosequencingimageanalysis_torch import mpfit_compat as port_mpfit
from fluorosequencingimageanalysis_torch.compat import mpfit as compat_mpfit
from fluorosequencingimageanalysis_torch.ops.lm import fit_gaussians_batched

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host


def _lm(patches, num_iters):
    params, cost = fit_gaussians_batched(
        torch.from_numpy(np.asarray(patches, np.float64)),
        num_iters=num_iters)
    return params.numpy(), cost.numpy()


def _quadratic_problem():
    x = np.linspace(0, 10, 50)
    rng = np.random.default_rng(0)
    y = 2.5 - 1.3 * x + 0.7 * x ** 2 + rng.normal(0, 0.05, 50)

    def fcn(p, fjac=None, x=None, y=None, err=None):
        return [0, (y - (p[0] + p[1] * x + p[2] * x ** 2)) / err]
    return fcn, {"x": x, "y": y, "err": np.full(50, 0.05)}


def _problems():
    fcn, kw = _quadratic_problem()
    x = np.linspace(0.0, 10.0, 60)
    y = 2500.0 * np.exp(-x / 2.2) + 400.0 + \
        np.random.default_rng(1).normal(0, 4.0, x.size)
    patch = gauss2d_oracle([200.0, 3000.0, 2.4, 2.6, 1.2, 1.3, 10.0],
                           (5, 5)) + \
        np.random.default_rng(2).normal(0, 5.0, (5, 5))

    def gfcn(p, fjac=None):
        return [0, (patch - gauss2d_oracle(p, patch.shape)).ravel()]
    return {
        "free": (fcn, dict(xall=[1.0, 1.0, 1.0], functkw=kw)),
        "fixed": (fcn, dict(parinfo=[
            {"value": 2.0, "fixed": 1},
            {"value": 0.0, "limited": [0, 0], "limits": [0.0, 0.0]},
            {"value": 1.0}], functkw=kw)),
        "bounded": (fcn, dict(parinfo=[
            {"value": 1.0, "limited": [1, 1], "limits": [0.0, 1.5]},
            {"value": 1.0}, {"value": 1.0}], functkw=kw)),
        "tied": (fcn, dict(parinfo=[
            {"value": 1.0}, {"value": 1.0, "tied": "2 * p[2]"},
            {"value": 1.0}], functkw=kw)),
        "out_of_bounds_start": (fcn, dict(parinfo=[
            {"value": 5.0, "limited": [1, 1], "limits": [0.0, 1.0]},
            {"value": 1.0}, {"value": 1.0}], functkw=kw)),
        "fd_steps": (fcn, dict(parinfo=[
            {"value": 1.0, "step": 0.05, "mpside": 2},
            {"value": 1.0, "relstep": 0.01},
            {"value": 1.0, "mpside": -1}], functkw=kw)),
        "mpmaxstep": (_expdecay_fcn, dict(parinfo=[
            {"value": 1800.0, "limited": [1, 0], "limits": [0.0, 0.0],
             "mpmaxstep": 300.0},
            {"value": 1.5, "limited": [1, 1], "limits": [0.1, 20.0],
             "mpmaxstep": 0.5},
            {"value": 300.0}], functkw={"x": x, "y": y})),
        "gaussian_pflib_bounds": (gfcn, dict(parinfo=[
            {"value": v, "limited": [1, lm], "limits": [lo, hi]}
            for v, lm, lo, hi in [
                (np.median(patch), 0, 0.0, 0.0),
                (patch.max(), 0, (patch.max() - patch.mean()) / 3, 0.0),
                (2.5, 1, 2.0, 3.0), (2.5, 1, 2.0, 3.0), (1.0, 1, 0.75, 2.0),
                (1.0, 1, 0.75, 2.0), (0.0, 1, 0.0, 360.0)]])),
    }


@pytest.mark.parametrize("name", sorted(_problems()))
def test_mpfit_compat_results_equal_jax(name):
    fcn, kw = _problems()[name]
    runs = []
    for mpfit in (port_mpfit.mpfit, jax_mpfit.mpfit, compat_mpfit.mpfit):
        args = {k: ([dict(p) for p in v] if k == "parinfo" else v)
                for k, v in kw.items()}
        xall = args.pop("xall", None)
        runs.append(mpfit(fcn, xall, quiet=1, **args))
    got, want, shim = runs
    for attr in ("status", "errmsg", "niter", "nfev", "dof"):
        assert getattr(got, attr) == getattr(want, attr) == \
            getattr(shim, attr), attr
    for attr in ("params", "perror", "covar", "fnorm"):
        a, b = getattr(got, attr), getattr(want, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=attr)
    if name == "out_of_bounds_start":
        assert got.status == 0 and "limits" in got.errmsg
    else:
        assert got.status > 0, got.errmsg


def test_mpfit_compat_mpmaxstep_matches_true_mpfit():
    fcn, kw = _problems()["mpmaxstep"]
    ref = mpfit_oracle.mpfit(fcn, parinfo=[dict(p) for p in kw["parinfo"]],
                             functkw=kw["functkw"], quiet=1)
    got = port_mpfit.mpfit(fcn, parinfo=[dict(p) for p in kw["parinfo"]],
                           functkw=kw["functkw"], quiet=1)
    assert ref.status > 0 and got.status > 0, (ref.errmsg, got.errmsg)
    np.testing.assert_allclose(got.params, ref.params, rtol=1e-4, atol=1e-2)


def test_lm_noiseless_patches_match_true_mpfit():
    """Noiseless rotated-elliptical patches: the port's LM solves each
    exactly, and wherever the reference mpfit also does (it stalls on
    about half, tests/test_mpfit_parity.py), the parameters agree to 1e-3
    after removing the rotation symmetry."""
    rng = np.random.default_rng(3)
    patches = np.asarray([gauss2d_oracle(
        [rng.uniform(100, 600), rng.uniform(400, 5000),
         rng.uniform(2.1, 2.9), rng.uniform(2.1, 2.9),
         rng.uniform(0.9, 1.7), rng.uniform(0.9, 1.7),
         rng.uniform(0, 45)], (5, 5)) for _ in range(24)])
    ours, cost_ours = _lm(patches, num_iters=500)
    n_both = 0
    for i, patch in enumerate(patches):
        ref, status, cost_ref = mpfit_reference_fit(patch)
        assert status >= 1, (i, status)
        eps = 1e-9 * float(np.sum(patch ** 2))
        assert cost_ours[i] < eps, (i, cost_ours[i], eps)
        if cost_ref < eps:
            n_both += 1
            po, pr = canonicalize(ours[i]), canonicalize(ref)
            np.testing.assert_allclose(po[:6], pr[:6], atol=1e-3, rtol=1e-3,
                                       err_msg=f"patch {i}")
            if abs(pr[4] - pr[5]) > 0.1:
                assert abs(po[6] - pr[6]) < 0.5, (i, po[6], pr[6])
    assert n_both >= 8, n_both


def test_lm_random_and_degenerate_patches_vs_true_mpfit():
    """The battery of tests/test_mpfit_parity.py (planted, elliptical,
    saturated, flat and edge patches at two noise levels), 120 patches:
    never worse than mpfit, and within 1e-3 of it where both converge."""
    patches, kinds = _patch_battery(120, seed=7)
    ours, cost_ours = _lm(patches, num_iters=200)
    n_mutual, n_peg_mismatch, ratios, sq_err = 0, 0, [], []
    for i, patch in enumerate(patches):
        ref, status, cost_ref = mpfit_reference_fit(patch)
        assert status >= 1, (i, status)
        eps = 1e-12 * float(np.sum(patch ** 2))
        ratio = (cost_ours[i] + eps) / (cost_ref + eps)
        ratios.append(ratio)
        assert ratio <= 1.02, (i, kinds[i], cost_ours[i], cost_ref)
        scale = max(cost_ours[i], cost_ref, 1e-12)
        if abs(cost_ours[i] - cost_ref) > 1e-6 * scale + eps:
            continue
        n_mutual += 1
        po, pr = canonicalize(ours[i]), canonicalize(ref)
        np.testing.assert_allclose(po[2:6], pr[2:6], atol=2e-3,
                                   err_msg=f"patch {i} kind {kinds[i]}")
        np.testing.assert_allclose(po[:2], pr[:2], rtol=1e-3, atol=1e-2,
                                   err_msg=f"patch {i} kind {kinds[i]}")
        if abs(pr[4] - pr[5]) > 0.1:
            assert abs(po[6] - pr[6]) < 0.5, (i, po[6], pr[6])
        d = po[2:6] - pr[2:6]
        sq_err.extend((d * d).tolist())
        amp_lo = (patch.max() - patch.mean()) / 3.0
        if (pegged_mask(po, amp_lo) != pegged_mask(pr, amp_lo)).any():
            n_peg_mismatch += 1
    ratios = np.asarray(ratios)
    assert (ratios <= 1.001).mean() >= 0.99, (ratios > 1.001).sum()
    assert n_mutual >= 36, n_mutual  # 30% (the JAX battery's is ~40%)
    assert float(np.sqrt(np.mean(sq_err))) <= 1e-3
    assert n_peg_mismatch <= 0.02 * n_mutual, (n_peg_mismatch, n_mutual)
