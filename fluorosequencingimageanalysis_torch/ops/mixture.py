"""scikit-learn's GaussianMixture and BayesianGaussianMixture for 1D data
in PyTorch float64.

The reference fits its intensity levels with scikit-learn's mixtures
(MCsimlib.py:3209-3375 [_gmm_photometries, _per_cycle_gmm_MP],
2996-3037 [_find_experiment_levels], jupyter_development.py:174-180).
These classes follow scikit-learn 1.9.0 (BSD-3-Clause;
sklearn/mixture/_base.py, _gaussian_mixture.py, _bayesian_mixture.py)
and import nothing of it:

- each restart starts from ``KMeans(n_clusters=k, n_init=1,
  random_state=rs)`` labels as one-hot responsibilities (ops/kmeans.py;
  all restarts' k-means in one ``kmeans_batched``), or from
  ``weights_init``/``means_init``/``precisions_init``;
- the EM of all ``n_init`` restarts runs as one (R, N, K) float64 program
  on ``device`` (None: ``_device.default_device()``, read at ``fit``):
  Cholesky-precision log-densities for the four covariance types (1D:
  sklearn's shapes), ``nk + 10 eps``, ``reg_covar``, sklearn's
  log-sum-exp (the maxima apart, ``log1p``) and the mean log-likelihood
  as the lower bound; each restart stops at the first round where the
  bound moves by less than ``tol`` and keeps its parameters from then on
  (one host read a round);
- the highest lower bound wins, the first on a tie; a
  ``ConvergenceWarning`` where the winner did not converge;
- the Bayesian mixture has the variational updates and lower bound of
  sklearn's at its default priors (Dirichlet-process weights, the rest
  derived from X; digamma, lgamma on the device) and, as in sklearn, no
  ``bic`` and no ``aic``.

Fitted attributes are numpy float64, so a fit pickles with no tensor in
it. A component whose variance is not positive raises sklearn's
ValueError; the k-means starts are all drawn before the first EM round,
so after that error the random state has moved on by every restart's
draws (sklearn's by those up to the failing restart).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from . import kmeans as _kmeans
from .kmeans import (ConvergenceWarning, check_random_state, check_X,
                     draws_per_init, np_sum, resolve, true_div,
                     _distinct_warning)

__all__ = ["GaussianMixture", "BayesianGaussianMixture", "ConvergenceWarning"]

_COV_TYPES = ("full", "tied", "diag", "spherical")
_LOG_2PI = 1 * math.log(2 * math.pi)
_EPS10 = 10 * np.finfo(np.float64).eps
_CHOL_ERROR = (
    "Fitting the mixture model failed because some components have "
    "ill-defined empirical covariance (for instance caused by singleton "
    "or collapsed samples). Try to decrease the number of components, "
    "increase reg_covar, or scale the input data.")


def logsumexp(a):
    """sklearn.utils._array_api._logsumexp over the last axis: the maxima
    apart, the others' exps summed, ``log1p(s / m) + log(m) + max``."""
    amax = a.amax(-1, keepdim=True)
    ismax = a == amax
    m = ismax.sum(-1, keepdim=True).to(a.dtype)
    rest = a.masked_fill(ismax, -math.inf)
    shift = torch.where(torch.isfinite(amax), amax, 0.0)
    s = np_sum(torch.exp(rest - shift))[..., None]
    s = torch.where(s == 0, s, s / m)
    return (torch.log1p(s) + torch.log(m) + amax)[..., 0]


def log_gaussian(X, means, pc, cov_type, trunc=False):
    """_estimate_log_gaussian_prob: (R, N, K) log-densities of the points
    ``X`` (N,) under means (R, K) and precision Cholesky factors ``pc``
    (R, K; "tied": (R, 1)). ``trunc``: X came as integers, and sklearn
    keeps the "full" and "tied" squared distances in an array of X's
    dtype, so they lose their fractions (it scores integer data so; its
    fits take float64)."""
    x = X[None, :, None]
    mu, p = means[:, None, :], pc[:, None, :]
    log_det = torch.log(pc)[:, None, :]
    if cov_type in ("full", "tied"):
        y = (x * p) - (mu * p)
        lp = y * y
        if trunc:
            lp = torch.trunc(lp)
    elif cov_type == "diag":
        prec = p * p
        lp = ((mu ** 2 * prec) - 2.0 * (x * (mu * prec))) + (x ** 2 * prec)
    else:
        prec = p * p
        lp = ((mu ** 2 * prec) - 2 * ((x * mu) * prec)) + ((x * x) * prec)
    return -0.5 * (_LOG_2PI + lp) + log_det


def gaussian_parameters(X, resp, reg_covar, cov_type):
    """_estimate_gaussian_parameters: nk (R, K), means (R, K) and the
    covariances (R, K; "tied": (R, 1))."""
    x = X[None, :, None]
    nk = resp.sum(1) + _EPS10
    means = (resp * x).sum(1) / nk
    if cov_type == "full":
        diff = x - means[:, None, :]
        cov = ((resp * diff) * diff).sum(1) / nk + reg_covar
    elif cov_type == "tied":
        avg_x2 = (X * X).sum()
        avg_m2 = np_sum((nk * means) * means)
        cov = ((avg_x2 - avg_m2) / np_sum(nk))[:, None] + reg_covar
    else:
        avg_x2 = (resp * (x * x)).sum(1) / nk
        cov = (avg_x2 - means ** 2) + reg_covar
    return nk, means, cov


def _precision_cholesky(cov, cov_type):
    """1 / sqrt(cov), raising sklearn's error where it would: a Cholesky
    factor of a non-positive (or NaN) variance, or a non-positive
    diagonal/spherical one."""
    bad = (cov <= 0) | (torch.isnan(cov) if cov_type in ("full", "tied")
                        else torch.zeros_like(cov, dtype=torch.bool))
    return 1.0 / torch.sqrt(cov), bad.any()


def _shape(a, cov_type, what):
    """sklearn's 1D shapes: means (k, 1); covariances and precisions
    "full" (k, 1, 1), "tied" (1, 1), "diag" (k, 1), "spherical" (k,)."""
    shape = (-1, 1) if what == "means" else {
        "full": (-1, 1, 1), "tied": (1, 1), "diag": (-1, 1),
        "spherical": (-1,)}[cov_type]
    return np.asarray(a, np.float64).reshape(shape)


def _flat(a, cov_type, k):
    a = np.asarray(a, np.float64).reshape(-1)
    return a[:1] if cov_type == "tied" else a.reshape(k)


class _BaseMixture:
    """What both mixtures share: validation, the k-means starts, the EM
    loop over R restarts, the selection and the scoring surface.
    ``em_rounds_`` is the number of lockstep EM rounds the fit ran (the
    slowest restart's)."""

    def _init_resp(self, X, rs, R, dev):
        """One-hot responsibilities (R, N, K) from one k-means a restart."""
        k, N = self.n_components, X.shape[0]
        if self.init_params != "kmeans":
            raise ValueError("the port's mixtures start from 'kmeans'; got "
                             + repr(self.init_params))
        u = rs.random_sample((R, draws_per_init(k)))
        res = _kmeans.kmeans_batched(np.broadcast_to(X[:, 0], (R, N)), k, 1,
                                     uniforms=u[:, None, :], device=dev)
        for r in range(R):
            if res["n_distinct"][r] < k:
                _distinct_warning(int(res["n_distinct"][r]), k)
        lab = torch.as_tensor(res["labels"], dtype=torch.long, device=dev)
        return torch.nn.functional.one_hot(lab, k).to(torch.float64)

    def _fit(self, X):
        X = check_X(X, type(self).__name__, min_samples=2)
        N, k = X.shape[0], self.n_components
        if N < k:
            raise ValueError(
                "Expected n_samples >= n_components but got n_components = "
                f"{k}, n_samples = {N}")
        if self.covariance_type not in _COV_TYPES:
            raise ValueError("covariance_type must be one of " +
                             str(_COV_TYPES))
        dev = resolve(self.device)
        Xd = torch.as_tensor(X[:, 0], device=dev)
        self._check_parameters(X, Xd)
        rs = check_random_state(self.random_state)
        R = self.n_init
        params = self._initialize(X, Xd, rs, R, dev)
        best, lbs, n_iter, conv = self._em(Xd, params, R)
        self._select(best, lbs, n_iter, conv)
        return Xd

    def _em(self, Xd, params, R):
        dev = Xd.device
        lb = torch.full((R,), -math.inf, dtype=torch.float64, device=dev)
        active = torch.ones(R, dtype=torch.bool, device=dev)
        conv = torch.zeros_like(active)
        n_iter = torch.zeros(R, dtype=torch.long, device=dev)
        lbs = []
        rounds = 0
        for it in range(1, self.max_iter + 1):
            prev = lb
            lpn, log_resp = self._e_step(Xd, params)
            new, bad = self._m_step(Xd, log_resp)
            cur = self._lower_bound(log_resp, lpn, new)
            params = {key: torch.where(
                active.view(-1, *[1] * (v.dim() - 1)), v, params[key])
                for key, v in new.items()}
            lb = torch.where(active, cur, lb)
            n_iter = torch.where(active, it, n_iter)
            newly = active & (torch.abs(lb - prev) < self.tol)
            conv = conv | newly
            lbs.append(lb)
            flags = torch.stack([(active & bad).any(),
                                 (active & ~newly).any()]).tolist()
            active = active & ~newly
            rounds += 1
            if flags[0]:
                raise ValueError(_CHOL_ERROR)
            if not flags[1]:
                break
        self.em_rounds_ = rounds
        lbs = torch.stack(lbs, 1).cpu().numpy() if lbs else \
            np.zeros((R, 0))
        return params, lbs, n_iter.cpu().numpy(), conv.cpu().numpy()

    def _select(self, params, lbs, n_iter, conv):
        R = lbs.shape[0]
        if self.max_iter == 0:
            r, max_lb = R - 1, -math.inf
            self.converged_ = False
            self.lower_bounds_ = []
        else:
            r, max_lb = 0, -math.inf
            for i in range(R):
                lb = lbs[i, n_iter[i] - 1]
                if lb > max_lb or max_lb == -math.inf:
                    r, max_lb = i, lb
            self.converged_ = bool(conv[r])
            self.lower_bounds_ = [float(v) for v in lbs[r, :n_iter[r]]]
        if not self.converged_ and self.max_iter > 0:
            warnings.warn(
                "Best performing initialization did not converge. "
                "Try different init parameters, or increase max_iter, "
                "tol, or check for degenerate data.", ConvergenceWarning,
                stacklevel=3)
        self._set_parameters({key: v[r].cpu().numpy()
                              for key, v in params.items()})
        self.n_iter_ = int(n_iter[r]) if self.max_iter > 0 else 0
        self.lower_bound_ = float(max_lb)

    def fit(self, X, y=None):
        self._fit(X)
        return self

    def fit_predict(self, X, y=None):
        Xd = self._fit(X)
        return torch.argmax(self._log_resp((Xd, False))[1], 1).cpu().numpy()

    def _weighted(self, data):
        Xd, trunc = data
        p = self._fitted_tensors(Xd.device)
        return self._weighted_log_prob(Xd, p, trunc)[0]

    def _log_resp(self, data):
        w = self._weighted(data)
        lpn = logsumexp(w)
        return lpn, w - lpn[:, None]

    def _data(self, X):
        """X on the device, and whether it came as integers."""
        trunc = np.asarray(X).dtype.kind in "iu"
        X = check_X(X, type(self).__name__)
        return torch.as_tensor(X[:, 0], device=resolve(self.device)), trunc

    def score_samples(self, X):
        return logsumexp(self._weighted(self._data(X))).cpu().numpy()

    def score(self, X, y=None):
        return float(np.mean(self.score_samples(X)))

    def predict(self, X):
        return torch.argmax(self._weighted(self._data(X)), 1).cpu().numpy()

    def predict_proba(self, X):
        return torch.exp(self._log_resp(self._data(X))[1]).cpu().numpy()

    def _e_step(self, Xd, params):
        w = self._weighted_log_prob(Xd, params)
        lpn = logsumexp(w)
        return lpn, w - lpn[..., None]


class GaussianMixture(_BaseMixture):
    """sklearn.mixture.GaussianMixture (1D) on ``device``."""

    def __init__(self, n_components=1, *, covariance_type="full", tol=1e-3,
                 reg_covar=1e-6, max_iter=100, n_init=1,
                 init_params="kmeans", weights_init=None, means_init=None,
                 precisions_init=None, random_state=None, device=None):
        self.n_components = n_components
        self.covariance_type = covariance_type
        self.tol = tol
        self.reg_covar = reg_covar
        self.max_iter = max_iter
        self.n_init = n_init
        self.init_params = init_params
        self.weights_init = weights_init
        self.means_init = means_init
        self.precisions_init = precisions_init
        self.random_state = random_state
        self.device = device

    def _check_parameters(self, X, Xd):
        k = self.n_components
        if self.weights_init is not None:
            w = np.asarray(self.weights_init, np.float64)
            if w.shape != (k,):
                raise ValueError("The parameter 'weights' should have the "
                                 f"shape of {(k,)}, but got {w.shape}")
            if (w < 0).any() or (w > 1).any():
                raise ValueError("The parameter 'weights' should be in the "
                                 "range [0, 1]")
            if not np.allclose(float(np.abs(1.0 - np.sum(w))), 0.0,
                               atol=1e-8):
                raise ValueError("The parameter 'weights' should be "
                                 "normalized, but got sum(weights) = %.5f"
                                 % np.sum(w))
        if self.means_init is not None:
            m = np.asarray(self.means_init, np.float64)
            if m.shape != (k, 1):
                raise ValueError("The parameter 'means' should have the "
                                 f"shape of {(k, 1)}, but got {m.shape}")
        if self.precisions_init is not None:
            p = np.asarray(self.precisions_init, np.float64)
            want = _shape(np.zeros(1 if self.covariance_type == "tied"
                                   else k), self.covariance_type, "cov")
            if p.shape != want.shape:
                raise ValueError(f"The parameter '{self.covariance_type} "
                                 f"precision' should have the shape of "
                                 f"{want.shape}, but got {p.shape}")
            if (p <= 0).any():
                raise ValueError(f"'{self.covariance_type} precision' "
                                 "should be positive")

    def _initialize(self, X, Xd, rs, R, dev):
        N, k, ct = Xd.shape[0], self.n_components, self.covariance_type

        def given(a, what="cov"):
            a = np.asarray(a, np.float64).reshape(k) if what == "means" \
                else _flat(a, ct, k)
            return torch.as_tensor(a, device=dev)[None].expand(R, -1)

        if (self.weights_init is None or self.means_init is None or
                self.precisions_init is None):
            resp = self._init_resp(X, rs, R, dev)
            nk, means, cov = gaussian_parameters(Xd, resp, self.reg_covar,
                                                 ct)
            weights = true_div(nk, N)
        else:
            weights = means = cov = None
        if self.weights_init is not None:
            weights = torch.as_tensor(np.asarray(self.weights_init,
                                                 np.float64),
                                      device=dev)[None].expand(R, -1)
        if self.means_init is not None:
            means = given(self.means_init, "means")
        if self.precisions_init is None:
            pc, bad = _precision_cholesky(cov, ct)
            if bool(bad):
                raise ValueError(_CHOL_ERROR)
        else:
            pc = torch.sqrt(given(self.precisions_init))
            if cov is None:
                cov = torch.full_like(pc, math.nan)
        return {"weights": weights.contiguous(), "means": means.contiguous(),
                "cov": cov.contiguous(), "pc": pc.contiguous()}

    def _weighted_log_prob(self, Xd, p, trunc=False):
        return (log_gaussian(Xd, p["means"], p["pc"], self.covariance_type,
                             trunc) + torch.log(p["weights"])[:, None, :])

    def _m_step(self, Xd, log_resp):
        nk, means, cov = gaussian_parameters(Xd, torch.exp(log_resp),
                                             self.reg_covar,
                                             self.covariance_type)
        weights = nk / np_sum(nk)[:, None]
        pc, bad = _precision_cholesky(cov, self.covariance_type)
        return {"weights": weights, "means": means, "cov": cov, "pc": pc}, \
            bad

    def _lower_bound(self, log_resp, lpn, params):
        return true_div(np_sum(lpn), lpn.shape[1])

    def _set_parameters(self, p):
        ct = self.covariance_type
        self.weights_ = p["weights"]
        self.means_ = _shape(p["means"], ct, "means")
        self.covariances_ = _shape(p["cov"], ct, "cov")
        self.precisions_cholesky_ = _shape(p["pc"], ct, "cov")
        self.precisions_ = self.precisions_cholesky_ ** 2

    def _fitted_tensors(self, dev):
        ct, k = self.covariance_type, self.n_components

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)

        return {"weights": t(self.weights_).reshape(1, k),
                "means": t(self.means_).reshape(1, k),
                "pc": t(_flat(self.precisions_cholesky_, ct, k))[None]}

    def _n_parameters(self):
        k = self.n_components
        cov_params = {"full": k * 1 * 2 / 2.0, "diag": k * 1,
                      "tied": 1 * 2 / 2.0, "spherical": k}[
            self.covariance_type]
        return int(cov_params + 1 * k + k - 1)

    def bic(self, X):
        X = np.asarray(X)
        return -2 * self.score(X) * X.shape[0] + \
            self._n_parameters() * math.log(X.shape[0])

    def aic(self, X):
        X = np.asarray(X)
        return -2 * self.score(X) * X.shape[0] + 2 * self._n_parameters()


class BayesianGaussianMixture(_BaseMixture):
    """sklearn.mixture.BayesianGaussianMixture (1D) on ``device``, at
    sklearn's priors (a Dirichlet-process weight prior of concentration
    1 / n_components, mean precision 1, the data mean, one degree of
    freedom, the data variance): the only ones the reference uses. As in
    sklearn it has no ``bic`` and no ``aic``."""

    def __init__(self, *, n_components=1, covariance_type="full", tol=1e-3,
                 reg_covar=1e-6, max_iter=100, n_init=1,
                 init_params="kmeans", random_state=None, device=None):
        self.n_components = n_components
        self.covariance_type = covariance_type
        self.tol = tol
        self.reg_covar = reg_covar
        self.max_iter = max_iter
        self.n_init = n_init
        self.init_params = init_params
        self.random_state = random_state
        self.device = device

    def _check_parameters(self, X, Xd):
        self.weight_concentration_prior_ = 1.0 / self.n_components
        self.mean_precision_prior_ = 1.0
        self.mean_prior_ = X.mean(axis=0)
        self.degrees_of_freedom_prior_ = 1
        if self.covariance_type in ("full", "tied"):
            self.covariance_prior_ = np.atleast_2d(np.cov(X.T))
        else:
            v = np.var(X, axis=0, ddof=1)
            self.covariance_prior_ = (v if self.covariance_type == "diag"
                                      else v.mean())

    def _initialize(self, X, Xd, rs, R, dev):
        resp = self._init_resp(X, rs, R, dev)
        nk, xk, sk = gaussian_parameters(Xd, resp, self.reg_covar,
                                         self.covariance_type)
        p, bad = self._update(nk, xk, sk)
        if bool(bad):
            raise ValueError(_CHOL_ERROR)
        return p

    def _update(self, nk, xk, sk):
        """_estimate_weights, _estimate_means, _estimate_precisions."""
        ct, K = self.covariance_type, self.n_components
        tail = torch.flip(torch.cumsum(torch.flip(nk, [1]), 1), [1])
        wc_b = self.weight_concentration_prior_ + torch.cat(
            [tail[:, 1:], torch.zeros_like(nk[:, :1])], 1)
        mpp = self.mean_precision_prior_
        mp = mpp + nk
        m0 = float(np.asarray(self.mean_prior_).reshape(-1)[0])
        means = (mpp * m0 + nk * xk) / mp
        cp = float(np.asarray(self.covariance_prior_).reshape(-1)[0])
        dofp = self.degrees_of_freedom_prior_
        diff = xk - m0
        if ct == "full":
            dof = dofp + nk
            cov = (cp + nk * sk + nk * mpp / mp * (diff * diff)) / dof
        elif ct == "tied":
            dof = (dofp + true_div(np_sum(nk), K))[:, None]
            cov = ((cp + true_div(sk * np_sum(nk)[:, None], K)) + mpp / K *
                   np_sum((nk / mp) * diff * diff)[:, None]) / dof
        elif ct == "diag":
            dof = dofp + nk
            cov = (cp + nk * (sk + (mpp / mp) * (diff * diff))) / dof
        else:
            dof = dofp + nk
            cov = (cp + nk * (sk + mpp / mp * (diff * diff))) / dof
        pc, bad = _precision_cholesky(cov, ct)
        return {"wc_a": 1.0 + nk, "wc_b": wc_b, "mp": mp, "means": means,
                "dof": dof, "cov": cov, "pc": pc}, bad

    def _log_weights(self, p):
        a, b = p["wc_a"], p["wc_b"]
        ds = torch.special.digamma(a + b)
        da, db = torch.special.digamma(a), torch.special.digamma(b)
        c = torch.cumsum(db - ds, 1)
        return (da - ds) + torch.cat([torch.zeros_like(c[:, :1]),
                                      c[:, :-1]], 1)

    def _weighted_log_prob(self, Xd, p, trunc=False):
        dof = p["dof"]
        log_gauss = log_gaussian(Xd, p["means"], p["pc"],
                                 self.covariance_type, trunc) - \
            (0.5 * 1 * torch.log(dof))[:, None, :]
        log_lambda = 1 * math.log(2.0) + torch.special.digamma(0.5 * dof)
        lp = log_gauss + (0.5 * (log_lambda - 1 / p["mp"]))[:, None, :]
        return lp + self._log_weights(p)[:, None, :]

    def _m_step(self, Xd, log_resp):
        nk, xk, sk = gaussian_parameters(Xd, torch.exp(log_resp),
                                         self.reg_covar,
                                         self.covariance_type)
        return self._update(nk, xk, sk)

    def _lower_bound(self, log_resp, lpn, p):
        dof = p["dof"]
        ldpc = torch.log(p["pc"]) - 0.5 * 1 * torch.log(dof)
        lwn = -((dof * ldpc + dof * 1 * 0.5 * math.log(2.0)) +
                torch.lgamma(0.5 * dof))
        if self.covariance_type == "tied":
            log_wishart = self.n_components * lwn[:, 0]
        else:
            log_wishart = np_sum(lwn)
        a, b = p["wc_a"], p["wc_b"]
        log_norm_weight = -np_sum(torch.lgamma(a) + torch.lgamma(b) -
                                  torch.lgamma(a + b))
        ent = (torch.exp(log_resp) * log_resp).sum((1, 2))
        return (((-ent - log_wishart) - log_norm_weight) -
                0.5 * 1 * np_sum(torch.log(p["mp"])))

    def _set_parameters(self, p):
        ct = self.covariance_type
        a, b = p["wc_a"], p["wc_b"]
        self.weight_concentration_ = (a, b)
        s = a + b
        w = a / s * np.hstack((1, np.cumprod((b / s)[:-1])))
        self.weights_ = w / np.sum(w)
        self.mean_precision_ = p["mp"]
        self.means_ = _shape(p["means"], ct, "means")
        self.degrees_of_freedom_ = (p["dof"][0] if ct == "tied"
                                    else p["dof"])
        self.covariances_ = _shape(p["cov"], ct, "cov")
        self.precisions_cholesky_ = _shape(p["pc"], ct, "cov")
        self.precisions_ = self.precisions_cholesky_ ** 2

    def _fitted_tensors(self, dev):
        ct, k = self.covariance_type, self.n_components

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   device=dev).reshape(1, -1)

        return {"means": t(self.means_),
                "pc": t(_flat(self.precisions_cholesky_, ct, k)),
                "mp": t(self.mean_precision_),
                "dof": t(self.degrees_of_freedom_),
                "wc_a": t(self.weight_concentration_[0]),
                "wc_b": t(self.weight_concentration_[1])}
