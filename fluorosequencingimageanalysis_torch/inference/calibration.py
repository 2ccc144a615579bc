"""Intensity calibration: optimal binning, zero-level, one-fluor intensity.

Parity with the reference's calibration chain
(MCsimlib.py:3888-3979, 5327-5384):
- Shimazaki-Shinomoto optimal histogram bin count,
- m0/D/m1 histogram peak/valley split (alpha zero-level),
- last-drop method for the one-fluor lognormal (beta, beta_sigma).

These run once per experiment on modest histogram data; they are exact host
NumPy (vectorized over bin counts — the reference's _MP Pool fan-out over
bin-count chunks is unnecessary here).
"""

from __future__ import annotations

import math

import numpy as np

from .photometries import _pairwise


def optimal_bin_size(raw_photometries, bin_array=None):
    """Shimazaki & Shinomoto cost scan (MCsimlib.py:3888-3909).

    Returns (min_cost, np.where(cost == min) indices, cost_array).
    """
    raw = np.asarray(raw_photometries, dtype=float)
    rmin, rmax = raw.min(), raw.max()
    if bin_array is None:
        bin_array = np.arange(10, 101)
    bin_array = np.asarray(bin_array)
    bin_sizes = (rmax - rmin) / bin_array
    cost_array = np.zeros((bin_sizes.size, 1))
    for i, bin_size in enumerate(bin_sizes):
        edges = np.linspace(rmin, rmax, bin_array[i] + 1)
        hist, _ = np.histogram(raw, bins=edges)
        cost_array[i] = ((2.0 * np.mean(hist) - np.var(hist)) / bin_size ** 2)
    min_cost = np.amin(cost_array)
    return min_cost, np.where(cost_array == min_cost), cost_array


def optimal_bin_size_MP(raw_photometries, num_processes=None, min_n_bins=10,
                        max_n_bins=1000):
    """Reference-compatible wrapper (MCsimlib.py:3912-3939 ran the scan in a
    Pool; the vectorized scan needs no processes). Returns
    (min_result, results, concatenated_cost_array, raw_cost_array) where
    min_result[1] is the optimal bin count.
    """
    bin_array = np.arange(min_n_bins, max_n_bins + 1)
    min_cost, where, cost_array = optimal_bin_size(raw_photometries,
                                                   bin_array)
    best_bin = int(where[0][0]) + min_n_bins
    min_result = (min_cost, best_bin, cost_array, 0, bin_array)
    results = [min_result]
    return min_result, results, cost_array.ravel(), [cost_array]


def _get_m0Dm1(raw_photometries, optimal_bin_number=None):
    """Histogram peak/valley decomposition (MCsimlib.py:3942-3979).

    Returns (optimal_bin_number, alpha, alpha_index, beta, beta_index,
    gamma, gamma_index, alpha_photometry, beta_photometry,
    gamma_photometry). Index 7 (the m0 peak mapped back to photometry
    units) is the zero-fluor level used by lognormal_fitter_v2.
    """
    raw = np.asarray(raw_photometries, dtype=float)
    if optimal_bin_number is None:
        min_result, *_ = optimal_bin_size_MP(raw, min_n_bins=10,
                                             max_n_bins=10000)
        optimal_bin_number = min_result[1]
    hist, bins = np.histogram(raw, bins=optimal_bin_number)
    depth_array = np.zeros_like(hist)
    for gamma_index in range(1, hist.shape[0] - 1):
        gamma_value = hist[gamma_index]
        L_max = np.amax(hist[:gamma_index])
        R_max = np.amax(hist[gamma_index + 1:])
        if gamma_value > L_max or gamma_value > R_max:
            continue
        depth_array[gamma_index] = min(L_max, R_max) - gamma_value
    gamma_index, gamma = int(np.argmax(depth_array)), np.amax(depth_array)
    alpha_index = int(np.argmax(hist[:gamma_index]))
    alpha = np.amax(hist[:gamma_index])
    beta_index = gamma_index + 1 + int(np.argmax(hist[gamma_index + 1:]))
    beta = np.amax(hist[gamma_index + 1:])
    rmin, rmax = raw.min(), raw.max()
    mapping_factor = float(rmax - rmin) / optimal_bin_number

    def map_bin(bi):
        return rmin + mapping_factor * bi

    return (optimal_bin_number, alpha, alpha_index, beta, beta_index, gamma,
            gamma_index, map_bin(alpha_index), map_bin(beta_index),
            map_bin(gamma_index))


def _last_drop_core(last_drop_list):
    """Shared HWHM-of-log-histogram estimator (MCsimlib.py:5337-5354)."""
    obn = optimal_bin_size_MP(last_drop_list)[0][1]
    hist, bins = np.histogram(last_drop_list, bins=obn)
    hist_max, hist_argmax = np.amax(hist), int(np.argmax(hist))
    if hist_argmax < len(bins) - 1:
        hist_max_logP = np.mean([bins[hist_argmax], bins[hist_argmax + 1]])
    else:
        hist_max_logP = bins[hist_argmax]
    hwhm = hist_max_logP / 2.0
    for i in range(hist_argmax - 1, -1, -1):
        if hist[i] > hist_max / 2.0:
            continue
        hwhm = hist_max_logP - np.mean([bins[i], bins[i + 1]])
        break
    beta = math.e ** hist_max_logP
    beta_sigma = hwhm / math.sqrt(2.0 * math.log(2.0))
    return beta, beta_sigma


def last_drop_method(photometries):
    """beta/beta_sigma from log(iON - iOFF) at ON->OFF transitions
    (MCsimlib.py:5327-5354)."""
    if len(photometries) > 1:
        raise NotImplementedError("Currently puts all photometries together, "
                                  "can't handle multiple channels at once.")
    last_drop_list = [
        math.log(iON - iOFF)
        for channel, cdict in photometries.items()
        for field, fdict in cdict.items()
        for (h, w), (category, intensities, row) in fdict.items()
        for i, (iON, iOFF) in enumerate(_pairwise(intensities))
        if category[i] and not category[i + 1] and iON > iOFF]
    return _last_drop_core(last_drop_list)


def last_drop_method_v2(photometries):
    """beta/beta_sigma from log(iON) before OFF transitions
    (MCsimlib.py:5357-5384) — the version lognormal_fitter_v2 uses."""
    if len(photometries) > 1:
        raise NotImplementedError("Currently puts all photometries together, "
                                  "can't handle multiple channels at once.")
    last_drop_list = [
        math.log(iON)
        for channel, cdict in photometries.items()
        for field, fdict in cdict.items()
        for (h, w), (category, intensities, row) in fdict.items()
        for i, (iON, iOFF) in enumerate(_pairwise(intensities))
        if category[i] and not category[i + 1] and iON > 0]
    return _last_drop_core(last_drop_list)


def fwhm_method(raw_photometries, optimal_bin_number=None):
    """Alpha/beta sigmas from histogram half-widths (MCsimlib.py:4213-4282)."""
    (optimal_bin_number, alpha, alpha_index, beta, beta_index, gamma,
     gamma_index, alpha_photometry, beta_photometry, gamma_photometry) = \
        _get_m0Dm1(raw_photometries=raw_photometries,
                   optimal_bin_number=optimal_bin_number)
    sub_alpha = [p for p in raw_photometries if p <= alpha_photometry]
    SAP_obn = optimal_bin_size_MP(sub_alpha)[0][1]
    SAP_hist, SAP_bins = np.histogram(sub_alpha, bins=SAP_obn)
    SAP_hwhm = (gamma_photometry - alpha_photometry) / 2.0
    for i in range(SAP_hist.shape[0]):
        if SAP_hist[i] < alpha / 2.0:
            continue
        mapping = (float(max(sub_alpha) - min(sub_alpha)) / SAP_obn)
        SAP_hwhm = alpha_photometry - (i * mapping + min(sub_alpha))
        break
    alpha_sigma = SAP_hwhm / math.sqrt(2.0 * math.log(2.0))
    sub_beta = [math.log(p) for p in raw_photometries
                if 0 < p <= beta_photometry]
    SBP_obn = optimal_bin_size_MP(sub_beta)[0][1]
    SBP_hist, SBP_bins = np.histogram(sub_beta, bins=SBP_obn)
    SBP_hwhm = (beta_photometry - gamma_photometry)
    for i in range(SBP_hist.shape[0] - 1, -1, -1):
        if SBP_hist[i] > beta / 2.0:
            continue
        mapping = (float(max(sub_beta) - min(sub_beta)) / SBP_obn)
        SBP_hwhm = ((SBP_hist.shape[0] - i) * mapping + min(sub_beta))
        break
    beta_sigma = SBP_hwhm / math.sqrt(2.0 * math.log(2.0))
    return (optimal_bin_number, alpha, alpha_index, beta, beta_index, gamma,
            gamma_index, alpha_photometry, beta_photometry, gamma_photometry,
            SAP_obn, SAP_hwhm, alpha_sigma, SBP_obn, SBP_hwhm, beta_sigma,
            SAP_hist, SAP_bins, SBP_hist, SBP_bins)


def fwhm_method_v2(photometries, optimal_bin_number=None):
    """Alpha-adjusted alpha/beta estimation (MCsimlib.py:4285-4382)."""
    if len(photometries) > 1:
        raise NotImplementedError("Currently puts all photometries together, "
                                  "can't handle multiple channels at once.")
    raw_photometries = [intensity
                        for channel, cdict in photometries.items()
                        for field, fdict in cdict.items()
                        for (h, w), (category, intensities, row)
                        in fdict.items()
                        for intensity in intensities]
    (optimal_bin_number, alpha, alpha_index, beta, beta_index, gamma,
     gamma_index, alpha_photometry, beta_photometry, gamma_photometry) = \
        _get_m0Dm1(raw_photometries=raw_photometries,
                   optimal_bin_number=optimal_bin_number)
    sub_alpha = [p for p in raw_photometries if p <= alpha_photometry]
    SAP_obn = optimal_bin_size_MP(sub_alpha)[0][1]
    SAP_hist, SAP_bins = np.histogram(sub_alpha, bins=SAP_obn)
    SAP_hwhm = (gamma_photometry - alpha_photometry) / 2.0
    default_SAP_hwhm = True
    for i in range(SAP_hist.shape[0]):
        if SAP_hist[i] < alpha / 2.0:
            continue
        mapping = (float(max(sub_alpha) - min(sub_alpha)) / SAP_obn)
        SAP_hwhm = alpha_photometry - (i * mapping + min(sub_alpha))
        default_SAP_hwhm = False
        break
    alpha_sigma = SAP_hwhm / math.sqrt(2.0 * math.log(2.0))
    adjusted_raw = [p - alpha_photometry for p in raw_photometries]
    adjusted_photometries = {}
    for channel, cdict in photometries.items():
        for field, fdict in cdict.items():
            for (h, w), (category, intensities, row) in fdict.items():
                adj = [i - alpha_photometry for i in intensities]
                adjusted_photometries.setdefault(channel, {}).setdefault(
                    field, {}).setdefault((h, w), (category, adj, row))
    beta_photometry -= alpha_photometry
    gamma_photometry -= alpha_photometry
    alpha_photometry = 0
    super_gamma = [math.log(p) for p in adjusted_raw
                   if p > gamma_photometry]
    SGP_obn = optimal_bin_size_MP(super_gamma, min_n_bins=10,
                                  max_n_bins=10000)[0][1]
    SGP_hist, SGP_bins = np.histogram(super_gamma, bins=SGP_obn)
    SGP_max, SGP_argmax = np.amax(SGP_hist), int(np.argmax(SGP_hist))
    if SGP_argmax < len(SGP_hist) - 1:
        SGP_max_logP = np.mean([SGP_bins[SGP_argmax],
                                SGP_bins[SGP_argmax + 1]])
    else:
        SGP_max_logP = SGP_bins[SGP_argmax]
    beta_photometry = math.e ** SGP_max_logP
    SGP_hwhm = abs(SGP_max_logP - math.log(gamma_photometry)) / 2.0
    default_SGP_hwhm = True
    for i in range(SGP_argmax - 1, -1, -1):
        if SGP_hist[i] > SGP_max / 2.0:
            continue
        SGP_hwhm = SGP_max_logP - np.mean([SGP_bins[i], SGP_bins[i + 1]])
        default_SGP_hwhm = False
        break
    beta_sigma = SGP_hwhm / math.sqrt(2.0 * math.log(2.0))
    return (alpha_photometry, alpha_sigma, beta_photometry, beta_sigma,
            adjusted_raw, adjusted_photometries, SAP_hist, SAP_bins,
            SGP_hist, SGP_bins, optimal_bin_number, alpha, alpha_index,
            beta, beta_index, gamma, gamma_index, gamma_photometry,
            default_SAP_hwhm, default_SGP_hwhm)
