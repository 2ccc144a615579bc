"""GMM / KMeans intensity-level fitters and cluster-based signal fits.

Counterpart of fluorosequencingimageanalysis_tpu/inference/gmm.py, a copy
of its host code: the reference's mixture-model family (MCsimlib.py:
2723-2982 [_cluster_fit/_cluster_fit_2], 2985-3202 [level finding +
plateau->signal translation + parallel driver], 3209-3395 [GMM fitters +
adjuster], 3489-3731 [parameter sweeps]). Where the JAX package fits with
scikit-learn's GaussianMixture / BayesianGaussianMixture / KMeans, the
copies import the port's own (ops/mixture.py, ops/kmeans.py: scikit-learn's
algorithms in PyTorch float64 on ``_device.default_device()``), so nothing
here needs scikit-learn. _MP drivers keep the reference signatures and run
serially. ``_parallel_cluster_fit`` fits every trace's k-means of one
length and cluster count in one ``kmeans_batched`` and hands each trace
its fits through ``_cluster_fit_2``'s private ``_kmeans`` keyword, so the
scoring stays the copy. ``gmm_photometries_batched`` and
``per_cycle_gmm_batched`` fit through ops/gmm_batch.py (kernel E) on
``device``, "cuda" unless the caller passes "cpu"; a device list or a
``_device.Mesh`` splits the models over its data devices, as the JAX
functions' mesh does.
"""

from __future__ import annotations

import math
import pickle
import time
from functools import reduce
from operator import mul
from os.path import basename

import numpy as np

from ..ops.kmeans import cluster_fit_prefits
from ..utils import profiling
from ..utils.rounding import py2_round as _py2_round
from scipy.stats import norm

from .photometries import (_check_no_downsteps, _pairwise,
                           read_track_photometries_csv, _remainder_adjust)


def _fit_gmm(X, n_components, n_init, n_iter, covariance_type, dpgmm=False):
    from ..ops.mixture import BayesianGaussianMixture, GaussianMixture

    X = np.asarray(X, dtype=float).reshape(-1, 1)
    if dpgmm:
        g = BayesianGaussianMixture(covariance_type=covariance_type,
                                    max_iter=n_iter)
    else:
        g = GaussianMixture(n_components=n_components, n_init=n_init,
                            max_iter=n_iter,
                            covariance_type=covariance_type)
    g.fit(X)
    # Old-sklearn compatibility: expose covars_ like the GMM class did.
    if not hasattr(g, "covars_"):
        g.covars_ = g.covariances_.reshape(-1)
    return g


def _gmm_photometries(photometries, min_fluors=1, max_fluors=5, dpgmm=False,
                      covariance_type="full", n_init=10, n_iter=100,
                      force_num_fluors=None, cycle=None,
                      raw_photometries=None, lower_bound=None):
    """BIC-selected GMM over raw photometries (MCsimlib.py:3209-3251)."""
    if raw_photometries is None and len(photometries) > 1:
        raise NotImplementedError("Currently puts all photometries together, "
                                  "can't handle multiple channels at once.")
    if force_num_fluors is not None:
        min_fluors = max_fluors = force_num_fluors
    if raw_photometries is None:
        raw_photometries = [
            intensity
            for channel, cdict in photometries.items()
            for field, fdict in cdict.items()
            for (h, w), (category, intensities, row) in fdict.items()
            for i, intensity in enumerate(intensities)
            if cycle is None or i == cycle]
    else:
        raw_photometries = list(raw_photometries)
    if lower_bound is not None:
        raw = np.array([[p] for p in raw_photometries if p >= lower_bound])
    else:
        raw = np.array([[p] for p in raw_photometries])
    best_fit, best_num_fluors, best_bic = None, None, 10 ** 10
    all_fits = []
    for num_fluors in range(min_fluors, max_fluors + 1):
        g = _fit_gmm(raw, num_fluors + 1, n_init, n_iter, covariance_type,
                     dpgmm)
        bic = g.bic(raw)
        all_fits.append((g, bic))
        if bic < best_bic:
            best_fit, best_num_fluors, best_bic = g, num_fluors, bic
    fluor_means = [x for x in best_fit.means_]
    return (fluor_means, best_fit, best_num_fluors, best_bic, all_fits, raw)


def _gmm_photometries_MP(photometries, min_fluors=1, max_fluors=5,
                         dpgmm=False, covariance_type="full",
                         num_processes=None, n_init=10, n_iter=100,
                         cycle=None, raw_photometries=None,
                         lower_bound=None):
    """(MCsimlib.py:3254-3304) — serial equivalent."""
    if raw_photometries is None and len(photometries) > 1:
        raise NotImplementedError("Currently puts all photometries together, "
                                  "can't handle multiple channels at once.")
    best_fit, best_num_fluors, best_bic, fluor_means = (None, None, 10 ** 10,
                                                        None)
    all_fits = []
    for num_fluors in range(min_fluors, max_fluors + 1):
        fm, bf, bnf, bb, af, rp = _gmm_photometries(
            photometries, min_fluors, max_fluors, dpgmm, covariance_type,
            n_init, n_iter, num_fluors, cycle, raw_photometries, lower_bound)
        all_fits.append((af[0], num_fluors))
        if bb < best_bic:
            best_fit, best_num_fluors, best_bic, fluor_means = (bf, bnf, bb,
                                                                fm)
    all_fits = [f for f, n in sorted(all_fits, key=lambda x: x[1])]
    fluor_means = sorted(fluor_means, key=lambda m: float(np.ravel(m)[0]))
    if raw_photometries is None:
        raw_photometries = np.array([
            intensity
            for channel, cdict in photometries.items()
            for field, fdict in cdict.items()
            for (h, w), (category, intensities, row) in fdict.items()
            for i, intensity in enumerate(intensities)
            if cycle is None or i == cycle])
    return (fluor_means, best_fit, best_num_fluors, best_bic, all_fits,
            raw_photometries)


def _per_cycle_gmm_MP(photometries, min_fluors=1, max_fluors=5, dpgmm=False,
                      covariance_type="full", num_processes=None, n_init=10,
                      n_iter=100, cycles=None, lower_bound=None):
    """(MCsimlib.py:3307-3375) — serial equivalent."""
    if len(photometries) > 1:
        raise NotImplementedError("Currently puts all photometries together, "
                                  "can't handle multiple channels at once.")
    if cycles is None:
        cdict = next(iter(photometries.values()))
        fdict = next(iter(cdict.values()))
        category, intensities, row = next(iter(fdict.values()))
        cycles = tuple(range(len(intensities)))
    raw_photometries = {
        cycle: np.array([
            intensity
            for channel, cdict in photometries.items()
            for field, fdict in cdict.items()
            for (h, w), (category, intensities, row) in fdict.items()
            for i, intensity in enumerate(intensities) if i == cycle])
        for cycle in cycles}
    all_fits = {cycle: [] for cycle in cycles}
    all_fit_scores = {cycle: [None, None, 10 ** 10, None] for cycle in cycles}
    for cycle in cycles:
        for num_fluors in range(min_fluors, max_fluors + 1):
            fm, bf, bnf, bb, af, rp = _gmm_photometries(
                photometries, min_fluors, max_fluors, dpgmm, covariance_type,
                n_init, n_iter, num_fluors, cycle, None, lower_bound)
            all_fits[cycle].append((af[0], num_fluors))
            if bb < all_fit_scores[cycle][2]:
                all_fit_scores[cycle] = [bf, bnf, bb, fm]
    for cycle in list(all_fits):
        all_fits[cycle] = tuple(f for f, n in sorted(all_fits[cycle],
                                                     key=lambda x: x[1]))
    for cycle, (bf, bnf, bb, fm) in list(all_fit_scores.items()):
        all_fit_scores[cycle] = (bf, bnf, bb,
                                 tuple(sorted(fm, key=lambda m:
                                              float(np.ravel(m)[0]))))
    return all_fit_scores, all_fits, raw_photometries


def _gmm_adjust(photometries, mu_zero, sigma_zero, mu_one, sigma_one,
                per_cycle_m0s0m1s1):
    """Per-cycle linear intensity correction (MCsimlib.py:3378-3395)."""
    coeffs = {cycle: float(mu_one - mu_zero) / (cm1 - cm0)
              for cycle, (cm0, cs0, cm1, cs1)
              in per_cycle_m0s0m1s1.items()}
    out = {}
    for channel, cdict in photometries.items():
        for field, fdict in cdict.items():
            for (h, w), (category, intensities, row) in fdict.items():
                corrected = [coeffs[i] *
                             (intensity - per_cycle_m0s0m1s1[i][0]) + mu_zero
                             for i, intensity in enumerate(intensities)]
                out.setdefault(channel, {}).setdefault(field, {}).setdefault(
                    (h, w), (category, corrected, row))
    return out, coeffs


class BatchedGMM1D:
    """One fitted 1D mixture from the batched device EM, with the
    sklearn-facing surface the reference code consumes (means_, covars_,
    weights_, bic/aic/score/predict).

    The reference passes old-sklearn GMM objects around after fitting
    (MCsimlib.py:3251 returns means_, jupyter_development reads
    means_/covars_/weights_); this is the same contract over plain numpy
    — scoring is exact mixture math, no refit."""

    def __init__(self, weights, means, variances, loglik, n_samples):
        k = len(weights)
        self.weights_ = np.asarray(weights, np.float64)
        self.means_ = np.asarray(means, np.float64).reshape(k, 1)
        self.covariances_ = np.asarray(variances, np.float64)
        self.covars_ = self.covariances_  # old-sklearn alias
        self.n_components = k
        self._loglik = float(loglik)
        self._n_samples = int(n_samples)

    def _n_parameters(self):
        # Full-covariance 1D mixture: k means + k variances + k-1 weights
        # (sklearn GaussianMixture._n_parameters).
        return 3 * self.n_components - 1

    def score_samples(self, X):
        x = np.asarray(X, np.float64).reshape(-1, 1)
        var = self.covariances_.reshape(1, -1)
        logp = (np.log(np.maximum(self.weights_, 1e-300)).reshape(1, -1)
                - 0.5 * (np.log(2 * np.pi * var)
                         + (x - self.means_.reshape(1, -1)) ** 2 / var))
        m = logp.max(axis=1, keepdims=True)
        return (m + np.log(np.exp(logp - m).sum(axis=1, keepdims=True)))[:, 0]

    def score(self, X):
        return float(np.mean(self.score_samples(X)))

    def predict(self, X):
        x = np.asarray(X, np.float64).reshape(-1, 1)
        var = self.covariances_.reshape(1, -1)
        logp = (np.log(np.maximum(self.weights_, 1e-300)).reshape(1, -1)
                - 0.5 * (np.log(2 * np.pi * var)
                         + (x - self.means_.reshape(1, -1)) ** 2 / var))
        return logp.argmax(axis=1)

    def bic(self, X):
        X = np.asarray(X)
        return (-2.0 * self.score(X) * X.shape[0]
                + self._n_parameters() * np.log(X.shape[0]))

    def aic(self, X):
        X = np.asarray(X)
        return -2.0 * self.score(X) * X.shape[0] + 2 * self._n_parameters()


def _collect_raw(photometries, cycle):
    return [intensity
            for channel, cdict in photometries.items()
            for field, fdict in cdict.items()
            for (h, w), (category, intensities, row) in fdict.items()
            for i, intensity in enumerate(intensities)
            if cycle is None or i == cycle]


def gmm_photometries_batched(photometries, min_fluors=1, max_fluors=5,
                             covariance_type="full", n_init=10, n_iter=100,
                             force_num_fluors=None, cycle=None,
                             raw_photometries=None, lower_bound=None,
                             seed=0, device="cuda"):
    """_gmm_photometries with every (num_fluors, restart) model of the BIC
    selection fitted in ONE launch of kernel E (ops/gmm_batch.py) on
    ``device`` instead of the reference's one-GMM-per-Pool-task loop
    (MCsimlib.py:3209-3304). Same return contract:
    (fluor_means, best_fit, best_num_fluors, best_bic, all_fits, raw)
    with BatchedGMM1D standing in for the sklearn estimator.
    dpgmm (BayesianGaussianMixture) stays on the sklearn path
    (_gmm_photometries) — it is not an EM-batchable model."""
    if raw_photometries is None and len(photometries) > 1:
        raise NotImplementedError("Currently puts all photometries together, "
                                  "can't handle multiple channels at once.")
    if covariance_type != "full":
        raise ValueError("batched GMM fits 1D full covariances; got "
                         + str(covariance_type))
    if force_num_fluors is not None:
        min_fluors = max_fluors = force_num_fluors
    if raw_photometries is None:
        raw_photometries = _collect_raw(photometries, cycle)
    else:
        raw_photometries = list(raw_photometries)
    if lower_bound is not None:
        raw = np.array([[p] for p in raw_photometries if p >= lower_bound])
    else:
        raw = np.array([[p] for p in raw_photometries])

    from ..ops.gmm_batch import gmm_fit_batched
    nfs = list(range(min_fluors, max_fluors + 1))
    res = gmm_fit_batched([raw[:, 0]], ks=[nf + 1 for nf in nfs],
                          n_init=n_init, n_iter=n_iter, seed=seed,
                          device=device)
    all_fits = []
    best_fit, best_num_fluors, best_bic = None, None, 10 ** 10
    for j, nf in enumerate(nfs):
        k = nf + 1
        fit = BatchedGMM1D(res["weights"][0, j, :k], res["means"][0, j, :k],
                           res["vars"][0, j, :k], res["loglik"][0, j],
                           res["counts"][0])
        bic = float(res["bic"][0, j])
        all_fits.append((fit, bic))
        if bic < best_bic:
            best_fit, best_num_fluors, best_bic = fit, nf, bic
    fluor_means = [x for x in best_fit.means_]
    return (fluor_means, best_fit, best_num_fluors, best_bic, all_fits, raw)


def per_cycle_gmm_batched(photometries, min_fluors=1, max_fluors=5,
                          covariance_type="full", n_init=10, n_iter=100,
                          cycles=None, lower_bound=None, seed=0,
                          device="cuda"):
    """_per_cycle_gmm_MP with ALL cycles x component counts x restarts
    fitted in one launch of kernel E on ``device``: the reference's nested
    Pool fan-out (MCsimlib.py:3307-3375) collapsed to a single dispatch.
    Same return contract: (all_fit_scores, all_fits, raw_photometries)
    keyed by cycle, with BatchedGMM1D fits. The host clock of the raw
    collection and of the fits' assembly is recorded under ``gmm/collect``
    and ``gmm/assemble`` in ``utils.profiling`` (the fit's own parts under
    ``gmm/*``, see ops/gmm_batch.py)."""
    if len(photometries) > 1:
        raise NotImplementedError("Currently puts all photometries together, "
                                  "can't handle multiple channels at once.")
    if covariance_type != "full":
        raise ValueError("batched GMM fits 1D full covariances; got "
                         + str(covariance_type))
    if cycles is None:
        cdict = next(iter(photometries.values()))
        fdict = next(iter(cdict.values()))
        category, intensities, row = next(iter(fdict.values()))
        cycles = tuple(range(len(intensities)))
    with profiling.stage("gmm/collect"):
        raw_photometries = {
            cycle: np.array(_collect_raw(photometries, cycle))
            for cycle in cycles}
        groups = []
        for cycle in cycles:
            arr = raw_photometries[cycle]
            groups.append(arr[arr >= lower_bound] if lower_bound is not None
                          else arr)

    from ..ops.gmm_batch import gmm_fit_batched
    nfs = list(range(min_fluors, max_fluors + 1))
    res = gmm_fit_batched(groups, ks=[nf + 1 for nf in nfs], n_init=n_init,
                          n_iter=n_iter, seed=seed, device=device)
    all_fits = {}
    all_fit_scores = {}
    with profiling.stage("gmm/assemble"):
        for g, cycle in enumerate(cycles):
            fits = []
            best = (None, None, 10 ** 10, None)
            for j, nf in enumerate(nfs):
                k = nf + 1
                fit = BatchedGMM1D(res["weights"][g, j, :k],
                                   res["means"][g, j, :k],
                                   res["vars"][g, j, :k],
                                   res["loglik"][g, j], res["counts"][g])
                fits.append(fit)
                bic = float(res["bic"][g, j])
                if bic < best[2]:
                    best = (fit, nf, bic, [x for x in fit.means_])
            all_fits[cycle] = tuple(fits)
            all_fit_scores[cycle] = (
                best[0], best[1], best[2],
                tuple(sorted(best[3], key=lambda m: float(np.ravel(m)[0]))))
    return all_fit_scores, all_fits, raw_photometries


def _cluster_fit(intensities, max_num_drops=3, zero_level=5000,
                 integer_deviation=1.4, **kwargs):
    """Unusable in the reference (MCsimlib.py:2723-2725)."""
    raise NotImplementedError("This doesn't really work. Use _cluster_fit_2")


def _cluster_fit_2(intensities, max_num_drops=3, zero_level=5000,
                   integer_deviation=1.4, scoring="gaussian",
                   largest_coincidence=3, single_fluor_min=10000,
                   gaussian_score_min=0.5, intensity_corrections=None,
                   intensity_correction_div=False, fluor_std=10000,
                   gaussian_std_max=5, min_num_drops=0, single_fluor_max=None,
                   consider_zl=True, n_init=10, zero_std=10000, **kwargs):
    """KMeans-based plateau fit (MCsimlib.py:2792-2982)."""
    from ..ops.kmeans import KMeans
    KMeans = kwargs.pop("_kmeans", KMeans)

    if intensity_corrections is not None:
        if intensity_correction_div:
            m = float(np.amax(intensity_corrections))
            intensities = [i * m / intensity_corrections[k]
                           for k, i in enumerate(intensities)]
        else:
            intensities = [i - intensity_corrections[k]
                           for k, i in enumerate(intensities)]
    X = np.array(intensities, dtype=float).reshape(-1, 1)
    best_clusters = None
    best_cluster_means = None
    best_score = None
    best_esfi = None
    coincidences = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0)[:largest_coincidence]
    for num_drops in range(min_num_drops, max_num_drops + 1):
        km = KMeans(n_clusters=num_drops + 1, init="k-means++",
                    n_init=n_init, max_iter=300, tol=0.0001)
        cluster_indexes = km.fit_predict(X)
        cluster_means = [float(m) for m in km.cluster_centers_.ravel()]
        sorted_means = sorted(cluster_means)
        if num_drops > 0:
            diffs = sorted(float(m - sorted_means[k])
                           for k, m in enumerate(sorted_means[1:]))
            smallest_step = diffs[0]
            if consider_zl:
                if smallest_step < min(zero_level, single_fluor_min):
                    continue
            elif smallest_step < single_fluor_min:
                continue
            esfi = None
            for divisor in coincidences:
                sfi = smallest_step / divisor
                if sfi < single_fluor_min:
                    continue
                if single_fluor_max is not None and sfi > single_fluor_max:
                    continue
                if all(any(i * (2.0 - integer_deviation) <=
                           diff / sfi <= i * integer_deviation
                           for i in coincidences)
                       for diff in diffs[1:]):
                    esfi = sfi
                    break
            else:
                continue
        else:
            esfi = sorted_means[0] - zero_level + zero_std
            if esfi < single_fluor_min:
                continue
            elif single_fluor_max is not None and esfi > single_fluor_max:
                for i in coincidences:
                    new_estimate = esfi / i
                    if single_fluor_max >= new_estimate >= single_fluor_min:
                        esfi = new_estimate
                        break
                else:
                    continue
        if esfi < single_fluor_min:
            continue
        if single_fluor_max is not None and esfi > single_fluor_max:
            continue
        std_coeff = [max(math.sqrt(_py2_round(m / esfi)), 1.0)
                     if m > zero_level and m > 0 else 1.0
                     for m in cluster_means]
        clusters = [[intensities[ii]
                     for ii, ci in enumerate(cluster_indexes) if ci == c]
                    for c in range(len(cluster_means))]
        if scoring == "gaussian":
            stds = [abs((i - cluster_means[c]) /
                        (fluor_std * std_coeff[c]))
                    if cluster_means[c] > zero_level
                    else abs((i - cluster_means[c]) / zero_std)
                    for c, cluster in enumerate(clusters) for i in cluster]
            if np.amax(stds) > gaussian_std_max:
                continue
            g_scores = [norm.pdf(abs(i - cluster_means[c]),
                                 scale=fluor_std * std_coeff[c])
                        if cluster_means[c] > zero_level
                        else norm.pdf(abs(i - cluster_means[c]),
                                      scale=zero_std)
                        for c, cluster in enumerate(clusters)
                        for i in cluster]
            if np.amin(g_scores) < gaussian_score_min:
                continue
            fit_score = reduce(mul, g_scores, 1.0)
        elif scoring in ("std", "var"):
            raise DeprecationWarning()
        elif scoring in ("uniform_gaussian", "proportional_gaussian"):
            raise NotImplementedError(
                "I have not updated this to have the correct scales, etc.")
        elif scoring == "km":
            fit_score = -1.0 * km.inertia_
        else:
            raise ValueError("not a valid scoring option")
        if best_score is None or fit_score > best_score:
            best_clusters = cluster_indexes
            best_cluster_means = cluster_means
            best_score = fit_score
            best_esfi = esfi
    if best_clusters is not None:
        final_fit = []
        for index, intensity in enumerate(intensities):
            if (len(final_fit) == 0 or
                    best_clusters[index] != best_clusters[index - 1]):
                final_fit.append([intensity])
            else:
                final_fit[-1].append(intensity)
        is_zero = bool(np.mean(final_fit[-1]) <= zero_level)
    else:
        final_fit = None
        is_zero = False
    return final_fit, best_score, is_zero, best_esfi


def _collate_means_into_fit(fit, reverse_order=False):
    """(MCsimlib.py:2985-2993)"""
    if reverse_order:
        return tuple([[(v, np.mean(p)) for v in p] for p in fit])
    return tuple([[(np.mean(p), v) for v in p] for p in fit])


def _find_experiment_levels(fits, filter_ups=False, r_2_threshold=0.7,
                            min_num_levels=None, max_num_levels=None,
                            originals_included=False,
                            use_original_values=False):
    """BIC-selected GMM over plateau values (MCsimlib.py:2996-3037)."""
    if not originals_included:
        raw_values = np.array([v for fit, r_2 in fits for plateau in fit
                               for v in plateau if r_2 >= r_2_threshold])
    else:
        idx = 1 if use_original_values else 0
        raw_values = np.array([v[idx] for fit, r_2 in fits for plateau in fit
                               for v in plateau if r_2 >= r_2_threshold])
    best_fit, best_i, best_bic = None, None, 10 ** 10
    i_min = 1 if min_num_levels is None else min_num_levels
    i_max = len(raw_values) if max_num_levels is None else max_num_levels
    X = raw_values.reshape(-1, 1)
    for i in range(i_min, i_max + 1):
        g = _fit_gmm(X, i, 1, 100, "full")
        bic = g.bic(X)
        if bic < best_bic:
            best_fit, best_i, best_bic = g, i, bic
    levels = [x for x in best_fit.means_]
    return levels, best_fit, best_bic, best_i


def _translate_plateaus_into_signal(plateaus, best_fit,
                                    originals_included=False):
    """Only works with downsteps (MCsimlib.py:3040-3093)."""
    if originals_included:
        plateaus = [[v[0] for v in p] for p in plateaus]
    for p1, p2 in _pairwise(plateaus):
        if p1[0] < p2[0]:
            raise Exception
    cumulative_index = -1
    plateau_ends = []
    for plateau in plateaus:
        cumulative_index += len(plateau)
        plateau_ends.append(cumulative_index)
    plateau_starts = [0] + [e + 1 for e in plateau_ends[:-1]]
    collated = list(zip(plateaus, plateau_starts, plateau_ends))
    level_assignments = []
    for plateau, start, stop in collated:
        bf_index = int(best_fit.predict(
            np.asarray(plateau, dtype=float).reshape(-1, 1))[0])
        level_assignments.append(bf_index)
    levels = [(float(np.ravel(x)[0]), i)
              for i, x in enumerate(best_fit.means_)]
    sorted_levels = sorted(levels, key=lambda y: y[0])
    level_map = {}
    for ox, oi in levels:
        for i, (mx, mi) in enumerate(sorted_levels):
            if oi == mi:
                level_map.setdefault(oi, i)
                break
    level_assignments = [level_map[L] for L in level_assignments]
    level_drops = [L1 - L2 for L1, L2 in _pairwise(level_assignments)]
    signal = []
    for d, drop in enumerate(level_drops):
        drop_position = collated[d][2] + 1
        signal += (("A", drop_position),) * drop
    return tuple(signal)


def _translate_plateaus_into_signal_2(plateaus, originals_included=False,
                                      adjustment=1, step_amplify=1):
    """(MCsimlib.py:3096-3115)"""
    if originals_included:
        plateaus = [[v[0] for v in p] for p in plateaus]
    for p1, p2 in _pairwise(plateaus):
        if p1[0] < p2[0]:
            raise Exception
    cumulative_index = -1
    plateau_ends = []
    for plateau in plateaus[:-1]:
        cumulative_index += len(plateau)
        plateau_ends.append(cumulative_index)
    signal = []
    for end in plateau_ends:
        signal += (("A", end + adjustment),) * step_amplify
    return tuple(signal)


def _translate_plateaus_into_signal_3(plateaus, originals_included=False,
                                      adjustment=1, fluor_intensity=None):
    """(MCsimlib.py:3117-3143)"""
    if originals_included:
        plateaus = [[v[0] for v in p] for p in plateaus]
    for p1, p2 in _pairwise(plateaus):
        if p1[0] < p2[0]:
            raise Exception
    scale_f = {p[0]: _py2_round(float(p[0]) / fluor_intensity)
               for p in plateaus}
    cumulative_index = -1
    plateau_ends = []
    for plateau in plateaus[:-1]:
        cumulative_index += len(plateau)
        plateau_ends.append(cumulative_index)
    signal = []
    for e, end in enumerate(plateau_ends):
        step_amplify = scale_f[plateaus[e][0]] - scale_f[plateaus[e + 1][0]]
        signal += (("A", end + adjustment),) * step_amplify
    return tuple(signal)


def _parallel_cluster_fit(photometries, num_processes=None, channel="ch1",
                          **kwargs):
    """(MCsimlib.py:3147-3202) — serial equivalent. Unknown kwargs the
    reference's Pool call would silently carry are filtered to
    _cluster_fit_2's **kwargs the same way. The k-means of every trace
    run first, batched (ops/kmeans.py::batched_trace_fits: one
    ``kmeans_batched`` a trace length and cluster count, the random state
    drawn in the loop's order), and reach ``_cluster_fit_2`` through its
    ``_kmeans`` keyword."""
    kwargs = {k: v for k, v in kwargs.items()
              if k not in ("algorithm", "channel", "version", "use_pdf")}
    prefit = cluster_fit_prefits(photometries, channel, kwargs,
                                 _cluster_fit_2)
    fitted_photometries = {}
    collated_fits = {}
    indexed_fits = {}
    all_indexed_fits = {}
    none_fits = []
    for chan, cdict in photometries.items():
        if chan != channel:
            continue
        for field, fdict in cdict.items():
            for (h, w), (categories, intensities, r) in fdict.items():
                fit, score, is_zero, fluor_intensity = _cluster_fit_2(
                    intensities, **kwargs, **next(prefit))
                if fit is None:
                    none_fits.append(r)
                    continue
                collated_fit = _collate_means_into_fit(fit=fit)
                all_indexed_fits.setdefault(
                    r, [chan, field, h, w, collated_fit, is_zero,
                        fluor_intensity])
                if not _check_no_downsteps(fit):
                    continue
                fitted_photometries.setdefault(chan, {}).setdefault(
                    field, {}).setdefault((h, w), (fit, score, is_zero,
                                                   fluor_intensity))
                collated_fits.setdefault(chan, {}).setdefault(
                    field, {}).setdefault((h, w), (collated_fit, score, r,
                                                   is_zero, fluor_intensity))
                indexed_fits.setdefault(r, [chan, field, h, w, collated_fit,
                                            is_zero, fluor_intensity])
    signals = {}
    for chan, cdict in collated_fits.items():
        for field, fdict in cdict.items():
            for (h, w), (fit, score, r, is_zero,
                         fluor_intensity) in fdict.items():
                if len(fit) == 1:
                    signal = (("A", 0),)
                else:
                    signal = _translate_plateaus_into_signal_3(
                        plateaus=fit, originals_included=True,
                        fluor_intensity=fluor_intensity)
                signals.setdefault((signal, is_zero), 0)
                signals[(signal, is_zero)] += 1
                indexed_fits[r] = tuple(indexed_fits[r] + [signal])
    return (fitted_photometries, collated_fits, signals, indexed_fits,
            all_indexed_fits, none_fits)


def _save_clustered_photometries_csv():
    raise NotImplementedError()


def _parameter_sweep(photometries_file, *args, **kwargs):
    """Deprecated in the reference (MCsimlib.py:3489-3501)."""
    raise NotImplementedError("Deprecated. Use _parameter_sweep_2")


def _parameter_sweep_2(photometries_file, clustering_parameters=None,
                       zero_fluor_std_amplifier=1.0,
                       one_fluor_std_amplifier=1.0, fname_hash=None,
                       head_truncate=0, tail_truncate=0,
                       downstep_filtered=True, adjust_photometries=False,
                       minimum_r_per_field=5, max_fluors=10,
                       covariance_type="full", n_init=10, n_iter=100,
                       channel="ch1", clustering_parameters_A_delta=None,
                       clustering_parameters_M_delta=None):
    """Full cluster-fit sweep (MCsimlib.py:3592-3698)."""
    photometries, row_photometries = read_track_photometries_csv(
        photometries_file, head_truncate=head_truncate,
        tail_truncate=tail_truncate, downstep_filtered=downstep_filtered)
    num_frames = len(next(iter(row_photometries.items()))[1][4])
    if adjust_photometries:
        use_photometries, remainder_adjustments = _remainder_adjust(
            photometries, num_frames, minimum_r_per_field)
    else:
        use_photometries = photometries
        remainder_adjustments = None
    (fluor_means, best_fit, best_num_fluors, best_bic, all_fits,
     raw_photometries) = _gmm_photometries_MP(
        use_photometries, max_fluors=max_fluors,
        covariance_type=covariance_type, n_init=n_init, n_iter=n_iter)
    best_fit_means = [float(np.ravel(m)[0]) for m in best_fit.means_]
    best_fit_weights = [float(w) for w in best_fit.weights_]
    best_fit_vars = [float(np.ravel(v)[0]) for v in best_fit.covars_]
    best_fit_stds = [math.sqrt(v) for v in best_fit_vars]
    stats = sorted(zip(best_fit_means, best_fit_weights, best_fit_vars,
                       best_fit_stds), key=lambda x: x[1], reverse=True)
    zero_fluor_mean = stats[0][0]
    zero_fluor_std = stats[0][3] * zero_fluor_std_amplifier
    one_fluor_mean = stats[1][0]
    one_fluor_std = stats[1][3] * one_fluor_std_amplifier
    params = {"max_num_drops": 5,
              "zero_level": zero_fluor_mean + zero_fluor_std,
              "integer_deviation": 1.4,
              "scoring": "gaussian",
              "gaussian_score_min": 0.0,
              "gaussian_std_max": 3,
              "largest_coincidence": 5,
              "single_fluor_min": one_fluor_mean - one_fluor_std,
              "single_fluor_max": one_fluor_mean + one_fluor_std,
              "intensity_correction_div": True,
              "use_pdf": True,
              "algorithm": "_cluster_fit_2",
              "fluor_std": one_fluor_std,
              "channel": channel,
              "version": "2016mar21_04:36"}
    if clustering_parameters is not None:
        params.update(clustering_parameters)
    if clustering_parameters_A_delta is not None:
        for k, v in clustering_parameters_A_delta.items():
            params[k] += v
    if clustering_parameters_M_delta is not None:
        for k, v in clustering_parameters_M_delta.items():
            params[k] *= v
    results = _parallel_cluster_fit(use_photometries, **params)
    if fname_hash is None:
        fname_hash = str(int(round(time.time())))
    save_parameters = (photometries_file, head_truncate, tail_truncate,
                       downstep_filtered, adjust_photometries,
                       minimum_r_per_field, max_fluors, covariance_type,
                       n_init, n_iter, channel, params)
    save_gmm = (zero_fluor_mean, zero_fluor_std, one_fluor_mean,
                one_fluor_std, best_fit, stats)
    save_modifiers = (zero_fluor_std_amplifier, one_fluor_std_amplifier,
                      params["integer_deviation"])
    with open(basename(photometries_file) + fname_hash + "_results.pkl",
              "wb") as f:
        pickle.dump((results, save_parameters, save_gmm,
                     remainder_adjustments, save_modifiers), f)
    return results, save_parameters


def _parallel_parameter_sweep(photometries_filepath, pdict=None,
                              num_processes=None):
    """Inoperable in the reference (raises inside its own loop,
    MCsimlib.py:3703-3730)."""
    raise Exception("Note to self: time.time() is not high resolution "
                    "enough to differentiate items in this loop.")


def _ps_results_analysis():
    raise NotImplementedError()
