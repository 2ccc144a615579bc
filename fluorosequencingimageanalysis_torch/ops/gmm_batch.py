"""Batched 1D Gaussian-mixture EM: every (group, component-count, restart)
model in one launch.

Counterpart of fluorosequencingimageanalysis_tpu/ops/gmm_batch.py. The
reference fits its intensity-level mixtures one model at a time with
scikit-learn over a process Pool (MCsimlib.py:3209-3304
[_gmm_photometries(_MP)] and :3307-3375 [_per_cycle_gmm_MP]); the JAX
package fits all of them as one array program. Here the models are

  models   (G, B, K)   G groups (e.g. cycles; each has its own data) x
                       B = component-choices x restarts, padded to
                       K = max components with an active-component mask

and ``gmm_fit_batched`` hands them, with the (G, N) standardised data and
each group's count of points, to ``ops/fused_gmm_em.py::gmm_em``: kernel E
(csrc/gmm_em.cu) on the card, ``_em_plain`` on the CPU, in slices of at
most ``fused_gmm_em.BMAX`` models (``em_in_slices``). ``_em_plain`` is
the JAX program's arithmetic in torch float32: ``n_iter`` lockstep rounds
of a chunked E-step that accumulates the sufficient statistics (Nk, Sk,
Qk) and a closed-form M-step, then a final log-likelihood pass.

The host half is the JAX package's: per-group standardisation in float64
(device math sees O(1) values), the restart starts from ``_init_params``
(the same ``default_rng(seed)`` feeds both packages, so the starts are
identical), restart selection by the first largest final log-likelihood
(sklearn's n_init rule), the back-transform to the original scale
(LL_orig = LL_std - N*log(s)) and BIC/AIC.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import shares
from ..utils import profiling

_LOG_2PI = math.log(2.0 * math.pi)
_NEG = -1e30  # log-weight of an inactive component
# float32 constants of csrc/gmm_em.cuh: log2(e), 0.5 * log2(e), log(2).
_LOG2E = float(np.float32(1.4426950408889634))
_HALF_LOG2E = float(np.float32(0.5 * 1.4426950408889634))
_LN2 = float(np.float32(0.6931471805599453))


def _log_weights(w, comp_mask, log=torch.log):
    return torch.where(comp_mask, log(torch.clamp(w, min=1e-30)),
                       torch.full_like(w, _NEG))


def _log_constants(w, var, comp_mask, log=torch.log):
    """Per-model, per-component log(w) - 0.5 * (log(var) + log(2 pi))."""
    return _log_weights(w, comp_mask, log) - 0.5 * (log(var) + _LOG_2PI)


def responsibilities(z, cst, mu, var, exp2=torch.exp2, log2=torch.log2):
    """(lse (G, B, c), resp (G, B, c, K)) of points ``z`` (G, c) under the
    models ``cst``/``mu``/``var`` (G, B, K).

    The log-sum-exp of the JAX package's E-step, evaluated in the log2
    domain with its per-round constants hoisted: per component one
    reciprocal of the variance, ``cst * log2(e)`` and ``0.5 * log2(e) /
    var``; per point and component a multiply-subtract and one ``exp2`` of
    the max-shifted exponent; the sum in component order; one ``log2`` and
    one reciprocal of the sum per point, and ``resp = e * (1 / s)``.
    ``exp2`` and ``log2`` can be stand-ins: csrc/gmm_em.cuh holds the same
    arithmetic per point, and the tests build it with g++ and hold it
    against this function bit for bit.
    """
    c2 = cst * _LOG2E
    h2 = _HALF_LOG2E * (1.0 / var)
    d = z[:, None, :, None] - mu[:, :, None, :]
    l2 = c2[:, :, None, :] - (d * d) * h2[:, :, None, :]
    m = l2.amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = exp2(l2 - m[..., None])
    s = e[..., 0]
    for k in range(1, e.shape[-1]):
        s = s + e[..., k]
    lse = (log2(s) + m) * _LN2
    return lse, e * (1.0 / s)[..., None]


def m_step(nk, sk, qk, n_valid, comp_mask, reg):
    """The closed-form M-step from the statistics (G, B, K): (w, mu, var),
    inactive components at w 0, mu 0, var 1; the weights' sum runs in
    component order, as kernel E's does."""
    nk_safe = torch.clamp(nk, min=1e-10)
    mu = sk / nk_safe
    var = torch.clamp(qk / nk_safe - mu * mu, min=0.0) + reg
    w = torch.where(comp_mask, nk / n_valid[:, None, None],
                    torch.zeros_like(nk))
    tot = w[..., 0]
    for k in range(1, w.shape[-1]):
        tot = tot + w[..., k]
    w = w / torch.clamp(tot, min=1e-30)[..., None]
    return (w, torch.where(comp_mask, mu, torch.zeros_like(mu)),
            torch.where(comp_mask, var, torch.ones_like(var)))


def _em_plain(z, valid, w0, mu0, var0, comp_mask, n_iter, reg, chunk=2048):
    """Plain twin of kernel E and of the JAX package's ``_em_batched``:
    ``n_iter`` lockstep EM rounds for every model, then the total
    log-likelihood of every model under its final parameters.

    z, valid: (G, n_pad) float32 standardised data and 0/1 mask, n_pad a
    multiple of ``chunk`` (the E-step's data chunk, summed chunk by chunk
    like the JAX scan). w0, mu0, var0: (G, B, K) float32; comp_mask
    (G, B, K) bool; reg: the variance floor on the standardised scale.
    Returns (w, mu, var (G, B, K), loglik (G, B)), all float32.
    """
    n_valid = valid.sum(dim=1)
    n_pad = z.shape[1]

    def stats(params):
        w, mu, var = params
        cst = _log_constants(w, var, comp_mask)
        acc = None
        for lo in range(0, n_pad, chunk):
            zc, vc = z[:, lo:lo + chunk], valid[:, lo:lo + chunk]
            lse, resp = responsibilities(zc, cst, mu, var)
            resp = resp * vc[:, None, :, None]
            part = (resp.sum(dim=2),
                    (resp * zc[:, None, :, None]).sum(dim=2),
                    (resp * (zc * zc)[:, None, :, None]).sum(dim=2),
                    (lse * vc[:, None, :]).sum(dim=2))
            acc = part if acc is None else tuple(
                a + b for a, b in zip(acc, part))
        return acc

    params = (w0, mu0, var0)
    for _ in range(n_iter):
        nk, sk, qk, _ = stats(params)
        params = m_step(nk, sk, qk, n_valid, comp_mask, reg)
    return (*params, stats(params)[3])


def em_in_slices(z, counts, w0, mu0, var0, comp_mask, n_iter, reg,
                 chunk=2048):
    """``fused_gmm_em.gmm_em`` over the model axis in slices of at most
    ``fused_gmm_em.BMAX`` models (the most one launch of kernel E takes),
    concatenated in model order. Models are independent and neither the
    kernel nor the twin sums across them, so the slices' outputs equal one
    call's bit for bit."""
    from . import fused_gmm_em
    step = fused_gmm_em.BMAX
    B = w0.shape[1]
    if B <= step:
        return fused_gmm_em.gmm_em(z, counts, w0, mu0, var0, comp_mask,
                                   n_iter, reg, chunk=chunk)
    parts = [fused_gmm_em.gmm_em(
        z, counts, *(t[:, lo:lo + step].contiguous()
                     for t in (w0, mu0, var0, comp_mask)),
        n_iter, reg, chunk=chunk) for lo in range(0, B, step)]
    return tuple(torch.cat(ts, dim=1) for ts in zip(*parts))


def _init_params(z_groups, n_valid, ks, n_init, K, rng):
    """Host-side initial parameters for every (group, k-choice, restart).

    Restart 0 seeds component means at the data quantiles (a deterministic
    good start); the rest draw means from the group's data points (the
    classic random-restart init). Variances start at 1 (standardized
    scale), weights uniform over the k active components.
    """
    G = len(z_groups)
    J = len(ks)
    B = J * n_init
    w0 = np.zeros((G, B, K), np.float32)
    mu0 = np.zeros((G, B, K), np.float32)
    var0 = np.ones((G, B, K), np.float32)
    comp_mask = np.zeros((G, B, K), bool)
    for g in range(G):
        zv = np.sort(z_groups[g][:n_valid[g]])
        if zv.size == 0:
            zv = np.zeros(1)
        for j, k in enumerate(ks):
            for r in range(n_init):
                b = j * n_init + r
                comp_mask[g, b, :k] = True
                w0[g, b, :k] = 1.0 / k
                if r == 0:
                    pos = ((np.arange(k) + 0.5) / k * (zv.size - 1))
                else:
                    # Random QUANTILE positions (sorted): restarts stay
                    # spread over the data mass instead of occasionally
                    # stacking two components in one cluster — measurably
                    # closes the worst-restart gap vs kmeans-seeded
                    # sklearn at over-parameterized k.
                    pos = np.sort(rng.random(k)) * (zv.size - 1)
                # ROUND, don't truncate: with truncation a size-k group
                # seeds every mean at index 0 (n=2, k=2: quantiles 0.25
                # and 0.75 both floor to 0) and the symmetric EM never
                # separates them; rounding reaches the last data point.
                mu0[g, b, :k] = zv[np.floor(pos + 0.5).astype(int)]
    return w0, mu0, var0, comp_mask


def prepare(groups, ks, n_init, seed, chunk):
    """The EM's input from float64 data groups: (z (G, n_pad) float32,
    each group standardised on the host in float64 and zero-padded to a
    multiple of ``chunk``; the groups' means and standard deviations; the
    starts (w0, mu0, var0, comp_mask) (G, B, K) of ``_init_params`` from
    ``default_rng(seed)``)."""
    G = len(groups)
    n_valid = np.array([g.size for g in groups])
    # Standardize per group on host (float64): device math sees O(1).
    mean_g = np.array([g.mean() for g in groups])
    std_g = np.array([max(float(g.std()), 1e-12) for g in groups])
    n_pad = -(-int(n_valid.max()) // chunk) * chunk
    z = np.zeros((G, n_pad), np.float32)
    for g, arr in enumerate(groups):
        z[g, :arr.size] = (arr - mean_g[g]) / std_g[g]
    starts = _init_params([z[g] for g in range(G)], n_valid, ks, n_init,
                          max(ks), np.random.default_rng(seed))
    return z, mean_g, std_g, starts


def gmm_fit_batched(groups, ks, n_init=10, n_iter=100, reg=1e-6,
                    seed=0, chunk=2048, device="cuda"):
    """Fit 1D GMMs with every component count in ``ks`` to every data
    group, n_init restarts each, in one launch of kernel E for every
    ``fused_gmm_em.BMAX`` models (its plain twin with ``device="cpu"``).

    Arguments:
        groups: sequence of 1D arrays (may be ragged — each group is its
            own dataset, e.g. one sequencing cycle's intensities).
        ks: component counts to fit (the reference uses num_fluors + 1
            for num_fluors in [min_fluors, max_fluors]).
        n_init / n_iter: restarts and EM iterations (reference defaults
            10 / 100, MCsimlib.py:3209).
        reg: variance floor on the standardized scale.
        seed: restart-initialization seed (deterministic).
        chunk: data chunk length of the twin's E-step; the data are
            padded to a multiple of it.
        device: where the EM runs ("cuda" by default, "cpu" for the twin).
            A device list or a ``_device.Mesh`` splits the model
            axis over its data devices (the JAX package's ``mesh=``): each
            gets the data and its contiguous share of the models, and the
            shares return in model order. Models share no sums, so the
            result is the one-device result.

    Returns a dict of host arrays, best-over-restarts per (group, k):
        weights, means, vars: (G, J, K_max) float64, original scale,
            entries beyond k zero;
        loglik: (G, J) float64 total log-likelihood (original scale);
        bic / aic: (G, J) float64 (sklearn's conventions: p = 3k - 1
            parameters for a full-covariance 1D mixture);
        counts: (G,) int — data points per group.
    The host clock of each part is recorded under ``gmm/standardise+init``,
    ``gmm/em`` (upload, the EM, the fetch) and ``gmm/select`` in
    ``utils.profiling``.
    """
    groups = [np.asarray(g, np.float64).ravel() for g in groups]
    if not groups or any(g.size == 0 for g in groups):
        raise ValueError("every group needs at least one data point")
    ks = [int(k) for k in ks]
    if not ks or min(ks) < 1:
        raise ValueError("ks must be positive component counts")
    short = [g for g, arr in enumerate(groups) if arr.size < max(ks)]
    if short:
        # sklearn raises the same way ("n_samples >= n_components"); a
        # k-component mixture of fewer points would silently return a
        # collapsed degenerate fit.
        raise ValueError(
            f"groups {short} have fewer data points than the largest "
            f"component count ({max(ks)}); a mixture needs n_samples >= "
            "n_components")

    G = len(groups)
    J = len(ks)
    K = max(ks)
    n_valid = np.array([g.size for g in groups])

    with profiling.stage("gmm/standardise+init"):
        z, mean_g, std_g, (w0, mu0, var0, comp_mask) = prepare(
            groups, ks, n_init, seed, chunk)

    with profiling.stage("gmm/em"):
        counts = n_valid.astype(np.int32)
        data = {}
        outs = []
        for lo, hi, dev in shares(w0.shape[1], device):
            if dev not in data:
                data[dev] = (torch.from_numpy(z).to(dev),
                             torch.from_numpy(counts).to(dev))
            outs.append(em_in_slices(
                *data[dev], *(torch.from_numpy(np.ascontiguousarray(
                    a[:, lo:hi])).to(dev)
                    for a in (w0, mu0, var0, comp_mask)),
                int(n_iter), float(reg), chunk=chunk))
        w, mu, var, ll = (np.concatenate([t.cpu().numpy() for t in ts],
                                         axis=1).astype(np.float64)
                          for ts in zip(*outs))

    with profiling.stage("gmm/select"):
        # Best restart per (group, k-choice) by final log-likelihood
        # (sklearn's n_init selection rule).
        ll = ll.reshape(G, J, n_init)
        best_r = ll.argmax(axis=-1)                            # (G, J)
        gj = np.ix_(range(G), range(J))

        def take(a):
            return a.reshape(G, J, n_init, K)[gj + (best_r,)]

        w_best = take(w)
        mu_best = take(mu)
        var_best = take(var)
        ll_std = np.take_along_axis(ll, best_r[..., None], axis=-1)[..., 0]

        # Back-transform to the original scale; LL picks up the Jacobian
        # -N*log(s) of the standardization.
        means = mean_g[:, None, None] + std_g[:, None, None] * mu_best
        vars_ = (std_g[:, None, None] ** 2) * var_best
        active = np.zeros((J, K), bool)
        for j, k in enumerate(ks):
            active[j, :k] = True
        means = np.where(active[None], means, 0.0)
        vars_ = np.where(active[None], vars_, 0.0)
        ll_orig = ll_std - (n_valid * np.log(std_g))[:, None]
        p = np.array([3 * k - 1 for k in ks], np.float64)
        bic = -2.0 * ll_orig + p[None] * np.log(n_valid)[:, None]
        aic = -2.0 * ll_orig + 2.0 * p[None]
    return {"weights": w_best, "means": means, "vars": vars_,
            "loglik": ll_orig, "bic": bic, "aic": aic, "counts": n_valid}
