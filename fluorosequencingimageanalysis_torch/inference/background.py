"""Signal-dict algebra and iterative background correction.

Parity: MCsimlib.py:5589-6214. Signals dicts map
``(signal, is_zero, starting_intensity) -> count`` where signal is a tuple
of ('A', cycle) drop positions. These are small dictionaries (hundreds of
keys); the algebra is exact host Python.
"""

from __future__ import annotations

import math
from collections import defaultdict
from itertools import product

import numpy as np

from ..utils.rounding import py2_round as _py2_round
from scipy.stats import norm


def is_multidrop(signal):
    positions = [pos for aa, pos in signal]
    if len(positions) == len(set(positions)):
        return False
    elif len(positions) > len(set(positions)):
        return True
    raise Exception()


def discard_late_signals(signals, max_cycle=None):
    if max_cycle is None:
        return dict(signals)
    filtered = {}
    for (s, z, si), count in signals.items():
        if max(pos for aa, pos in s) > max_cycle:
            continue
        filtered.setdefault((s, z, si), count)
    return filtered


def head_truncate(signals, num_cycles=None):
    if num_cycles is None or num_cycles == 0:
        return dict(signals)
    if num_cycles < 0:
        raise ValueError("num_cycles must be None or a non-negative integer.")
    truncated = {}
    for (s, z, si), f in signals.items():
        if min(pos for aa, pos in s) <= num_cycles:
            continue
        shifted = tuple((aa, pos - num_cycles) for aa, pos in s)
        truncated.setdefault((shifted, z, si), f)
    return truncated


def counts_to_percent(signals, include_remainders=False,
                      include_multidrop=True, max_cycle=None):
    filtered = {k: c for k, c in signals.items()
                if include_remainders or k[1]}
    filtered = {k: c for k, c in filtered.items()
                if include_multidrop or not is_multidrop(k[0])}
    filtered = discard_late_signals(filtered, max_cycle=max_cycle)
    total = sum(filtered.values())
    return {k: float(c) / total for k, c in filtered.items()}


def sum_signals(experiments):
    summed = {}
    for signals in experiments:
        for k, num in signals.items():
            summed.setdefault(k, 0)
            summed[k] += num
    return summed


def average_signals(experiments, include_remainders=False,
                    include_multidrop=True, max_cycle=None):
    percents = [counts_to_percent(s, include_remainders=include_remainders,
                                  include_multidrop=include_multidrop,
                                  max_cycle=max_cycle)
                for s in experiments]
    combined_keys = tuple(set(k for s in percents for k in s))
    summed = sum_signals(percents)
    return {k: float(summed[k]) / len(experiments) for k in combined_keys}


def signals_std(experiments, include_remainders=False,
                include_multidrop=True, max_cycle=None):
    percents = [counts_to_percent(s, include_remainders=include_remainders,
                                  include_multidrop=include_multidrop,
                                  max_cycle=max_cycle)
                for s in experiments]
    combined_keys = tuple(set(k for s in percents for k in s))
    ledger = defaultdict(list)
    for p in percents:
        for k in combined_keys:
            ledger[k].append(p.get(k, 0))
    return {k: float(np.std(v)) for k, v in ledger.items()}


def generate_adjacent_positions(signal, include_multidrop=False):
    """+-1-cycle neighbors of a signal's drop positions
    (MCsimlib.py:5722-5744)."""
    if len(signal) == 0:
        raise ValueError("Not defined for empty signal.")
    if not signal[1]:
        raise ValueError("Not defined for remainders.")
    amino_acids = set(aa for aa, pos in signal[0])
    if len(amino_acids) != 1:
        raise ValueError("Currently only implemented for one label.")
    positions = tuple(pos for aa, pos in signal[0])
    adjacent = []
    for perturbation in product((-1, 0, 1), repeat=len(positions)):
        if all(p == 0 for p in perturbation):
            continue
        perturbed = [pos + perturbation[p]
                     for p, pos in enumerate(positions)]
        if (not include_multidrop and
                len(set(perturbed)) < len(perturbed)):
            continue
        adjacent.append(tuple(perturbed))
    return adjacent


def interpolate_signal(signals, interpolation_target, num_cycles,
                       include_multidrop=False):
    amino_acids = set(aa for s in signals for aa, pos in s[0])
    if len(amino_acids) != 1:
        raise ValueError("Currently only implemented for one label.")
    aa = amino_acids.pop()
    adjacent = generate_adjacent_positions(
        signal=interpolation_target, include_multidrop=include_multidrop)
    adjacent_signals = [(tuple((aa, pos) for pos in adj),
                         interpolation_target[1], interpolation_target[2])
                        for adj in adjacent
                        if all(0 < pos <= num_cycles for pos in adj)]
    adjacent_values = {s: signals.get(s, 0) for s in adjacent_signals}
    return float(np.mean(list(adjacent_values.values())))


def outlier_z_scores(boc, ac_average, ac_std):
    if set(ac_average.keys()) != set(ac_std.keys()):
        raise Exception()
    combined_keys = list(ac_average.keys()) + list(boc.keys())
    z_scores, undefined = {}, {}
    for k in combined_keys:
        bp = boc.get(k, 0)
        ap = ac_average.get(k, 0)
        sp = ac_std.get(k, 0)
        if sp == 0:
            undefined.setdefault(k, (bp, ap, sp))
        else:
            z_scores.setdefault(k, float(bp - ap) ** 2 / float(sp) ** 2)
    z_scores = {k: math.copysign(math.sqrt(m),
                                 boc.get(k, 0) - ac_average.get(k, 0))
                for k, m in z_scores.items()}
    return z_scores, undefined


def iterative_peak_finding(boc_raw, boc_percent, ac_average, ac_std,
                           num_cycles, sigma_threshold=3,
                           include_multidrop=False):
    """v1: replace the largest-z outlier with its neighbor interpolation
    until all z <= threshold (MCsimlib.py:5795-5852)."""
    peak_list, undefined_peaks = [], []
    updated_raw = dict(boc_raw)
    updated_percent = dict(boc_percent)
    if set(boc_raw.keys()) != set(boc_percent.keys()):
        raise ValueError("boc_raw and boc_percent don't have matching keys.")
    max_iterations = len(updated_percent)
    while max_iterations >= 0:
        max_iterations -= 1
        z_scores, undefined = outlier_z_scores(updated_percent, ac_average,
                                               ac_std)
        for k, (bp, ap, sp) in undefined.items():
            updated_raw[k] = interpolate_signal(
                updated_raw, k, include_multidrop=include_multidrop,
                num_cycles=num_cycles)
            updated_percent = counts_to_percent(
                updated_raw, include_remainders=False,
                include_multidrop=include_multidrop,
                max_cycle=num_cycles + 1)
            undefined_peaks.append((*k, bp, ap, sp))
        if len(z_scores) == 0:
            break
        outlier = max(z_scores, key=z_scores.get)
        if z_scores[outlier] <= sigma_threshold:
            break
        peak_list.append(outlier)
        updated_raw[outlier] = interpolate_signal(
            updated_raw, outlier, include_multidrop=include_multidrop,
            num_cycles=num_cycles)
        updated_percent = counts_to_percent(
            updated_raw, include_remainders=False,
            include_multidrop=include_multidrop, max_cycle=num_cycles + 1)
    updated_raw = {k: _py2_round(c) for k, c in updated_raw.items()}
    return peak_list, undefined_peaks, updated_raw, updated_percent


def iterative_peak_finding_v2(boc_raw, boc_percent, ac_average, ac_std,
                              num_cycles, sigma_threshold=3,
                              include_multidrop=False):
    """v2: like v1, but breaks outlier-selection cycles by falling to the
    second-largest z when the same outlier repeats (MCsimlib.py:5855-5929).
    """
    peak_list, undefined_peaks = [], []
    updated_raw = dict(boc_raw)
    updated_percent = dict(boc_percent)
    if set(boc_raw.keys()) != set(boc_percent.keys()):
        raise ValueError("boc_raw and boc_percent don't have matching keys.")
    max_iterations = len(updated_percent)
    last_outlier = None
    while max_iterations >= 0:
        max_iterations -= 1
        z_scores, undefined = outlier_z_scores(updated_percent, ac_average,
                                               ac_std)
        for k, (bp, ap, sp) in undefined.items():
            updated_raw[k] = interpolate_signal(
                updated_raw, k, include_multidrop=include_multidrop,
                num_cycles=num_cycles)
            updated_percent = counts_to_percent(
                updated_raw, include_remainders=False,
                include_multidrop=include_multidrop,
                max_cycle=num_cycles + 1)
            undefined_peaks.append((*k, bp, ap, sp))
        if len(z_scores) == 0:
            break
        outlier = max(z_scores, key=z_scores.get)
        if outlier == last_outlier:
            if len(z_scores) < 2:
                break
            outlier = sorted(z_scores.items(), key=lambda x: x[1])[-2][0]
        last_outlier = outlier
        if z_scores[outlier] <= sigma_threshold:
            break
        peak_list.append(outlier)
        updated_raw[outlier] = interpolate_signal(
            updated_raw, outlier, include_multidrop=include_multidrop,
            num_cycles=num_cycles)
        updated_percent = counts_to_percent(
            updated_raw, include_remainders=False,
            include_multidrop=include_multidrop, max_cycle=num_cycles + 1)
    updated_raw = {k: _py2_round(c) for k, c in updated_raw.items()}
    return peak_list, undefined_peaks, updated_raw, updated_percent


def iterative_peak_finding_v3(boc_raw, boc_percent, ac_average, ac_std,
                              num_cycles, sigma_threshold=3,
                              include_multidrop=False, sigma_subtract=None):
    """v3 (current): greedy z-improvement selection with convergence check
    and optional +sigma inflation (MCsimlib.py:5932-6040)."""
    peak_list, undefined_peaks = [], []
    updated_raw = dict(boc_raw)
    updated_percent = dict(boc_percent)
    if set(boc_raw.keys()) != set(boc_percent.keys()):
        raise ValueError("boc_raw and boc_percent don't have matching keys.")
    prior_raw = None
    while True:
        z_scores, undefined = outlier_z_scores(updated_percent, ac_average,
                                               ac_std)
        for k, (bp, ap, sp) in undefined.items():
            updated_raw[k] = interpolate_signal(
                updated_raw, k, include_multidrop=include_multidrop,
                num_cycles=num_cycles)
            undefined_peaks.append((*k, bp, ap, sp))
        updated_percent = counts_to_percent(
            updated_raw, include_remainders=False,
            include_multidrop=include_multidrop, max_cycle=num_cycles)
        if len(z_scores) == 0:
            break
        outlier = max(z_scores, key=z_scores.get)
        if z_scores[outlier] <= sigma_threshold:
            break
        interpolated = {k: interpolate_signal(
            updated_raw, k, include_multidrop=include_multidrop,
            num_cycles=num_cycles) for k in z_scores}
        z_diffs = {}
        for k, icount in interpolated.items():
            if z_scores[k] <= sigma_threshold:
                continue
            temp_raw = dict(updated_raw)
            temp_raw[k] = icount
            temp_percent = counts_to_percent(
                temp_raw, include_remainders=False,
                include_multidrop=include_multidrop, max_cycle=num_cycles)
            temp_z, _ = outlier_z_scores(temp_percent, ac_average, ac_std)
            z_diffs.setdefault(k, z_scores[k] - temp_z[k])
        best = max(z_diffs, key=z_diffs.get)
        if z_diffs[best] <= 0:
            break
        outlier = best
        # Parity note: the reference's v3 never appends to peak_list
        # (MCsimlib.py:5932-6040) — only v1/v2 record peaks.
        updated_raw[outlier] = interpolated[outlier]
        if prior_raw is not None:
            assert set(prior_raw.keys()) == set(updated_raw.keys())
            if max(abs(updated_raw[k] - prior_raw[k])
                   for k in prior_raw) < 0.001:
                break
        prior_raw = dict(updated_raw)
        updated_percent = counts_to_percent(
            updated_raw, include_remainders=False,
            include_multidrop=include_multidrop, max_cycle=num_cycles)
    updated_raw = {k: _py2_round(c) for k, c in updated_raw.items()}
    if sigma_subtract is not None:
        if set(ac_average.keys()) != set(ac_std.keys()):
            raise ValueError("ac_average and ac_std keys don't match.")
        for k, percent in list(updated_percent.items()):
            if percent == 0:
                continue
            ratio = (float(percent + ac_std.get(k, 0)) / percent)
            updated_raw[k] = _py2_round(updated_raw[k] * ratio)
        updated_percent = counts_to_percent(
            updated_raw, include_remainders=False,
            include_multidrop=include_multidrop, max_cycle=num_cycles)
    return peak_list, undefined_peaks, updated_raw, updated_percent


def _sigma_counts(background_boc_raw, background_boc_percent, ac_std):
    """Shared sigma-in-counts derivation (MCsimlib.py:6102-6127)."""
    sigma_counts, undefined_sigma = {}, {}
    for k, count in background_boc_raw.items():
        if count == 0:
            if background_boc_percent[k] > 0.0001:
                raise Exception("count is 0, but background_boc_percent[" +
                                str(k) + "] is not approx zero")
            continue
        elif background_boc_percent[k] == 0:
            raise Exception("background_boc_percent[" + str(k) + "] is zero, "
                            "but count is positive " + str(count))
        elif background_boc_percent[k] < 0:
            raise Exception("background_boc_percent cannot be negative")
        if k not in ac_std or ac_std[k] == 0:
            undefined_sigma.setdefault(k, background_boc_percent[k])
            continue
        std_ratio = float(ac_std[k]) / background_boc_percent[k]
        sigma_counts.setdefault(k, std_ratio * background_boc_raw[k])
    return sigma_counts, undefined_sigma


def subtract_false_positives(background_boc_raw, background_boc_percent,
                             counts_above_background, ac_std,
                             expected_false_positive_percent=5.0):
    """Diminish counts until expected false positives drop below the target
    rate (MCsimlib.py:6043-6158)."""
    if not (set(background_boc_raw.keys()) ==
            set(background_boc_percent.keys()) ==
            set(counts_above_background.keys())):
        raise ValueError("Keys for all three dictionaries must match.")
    sigma_counts, undefined_sigma = _sigma_counts(
        background_boc_raw, background_boc_percent, ac_std)

    def fp_count(count_above_background, subtract_count, sigma):
        expected = 0.0
        na = norm(loc=0, scale=sigma)
        assert subtract_count >= 0
        for t in range(subtract_count + 1, count_above_background + 1):
            expected += (t - subtract_count) * na.pdf(t - 0.5)
        return expected

    subtractions = {}
    for k, sigma in sigma_counts.items():
        if counts_above_background[k] == 0:
            continue
        subtract = counts_above_background[k]
        for T in range(counts_above_background[k]):
            fpc = fp_count(counts_above_background[k], T, sigma)
            fp_percent = (float(fpc) / (counts_above_background[k] - T) *
                          100.0)
            if fp_percent <= expected_false_positive_percent:
                subtract = T
                break
        subtractions.setdefault(k, subtract)
    return subtractions, undefined_sigma, sigma_counts


def expected_background(background_boc_raw, background_boc_percent, ac_std):
    """Expected background counts from the sigma model
    (MCsimlib.py:6161-6214)."""
    if set(background_boc_raw.keys()) != set(background_boc_percent.keys()):
        raise ValueError("Keys for background_boc_raw and "
                         "background_boc_percent must match.")
    sigma_counts, undefined_sigma = _sigma_counts(
        background_boc_raw, background_boc_percent, ac_std)
    expected_counts = {}
    for k, sigma in sigma_counts.items():
        na = norm(loc=0, scale=sigma)
        expected = 0.0
        for t in range(int(math.ceil(sigma * 7.0))):
            expected += na.pdf(t - 0.5) * t
        expected_counts.setdefault(k, _py2_round(expected))
    return expected_counts
