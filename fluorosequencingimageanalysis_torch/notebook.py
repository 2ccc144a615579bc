"""Notebook/diagnostic helpers (the reference's jupyter_development).

Parity: jupyter_development.py — the functions the CLI apps
and diagnostics rely on: ON/OFF grabbing and per-image adjustment, signal/
sequence converters, and simple statistics.
"""

from __future__ import annotations

import itertools
import math
from random import choice

import numpy as np

from .utils.rounding import py2_round as _py2_round


def _pairwise(iterable):
    a, b = itertools.tee(iterable)
    next(b, None)
    return zip(a, b)


def grab_ON_OFFS(all_fit_info, allow_bad_fits=False, alpha_adjust=None):
    """Per-(cycle, field) ON intensities at ON->OFF transitions with the
    number of fluors dropped (jupyter_development.py:63-84).

    Parity note: the reference's alpha_adjust branches are inverted (it
    subtracts only when alpha_adjust is None, which would TypeError);
    callers pass alpha_adjust=0 so the working branch appends raw iON —
    reproduced exactly.
    """
    on_offs = {}
    for (channel, field, h, w, row, category, intensities, signal, is_zero,
         dye_sequence, lmii, total_score, per_frame_scores,
         starting_intensity) in all_fit_info:
        if not allow_bad_fits and dye_sequence is None:
            continue
        for i, (iON, iOFF) in enumerate(_pairwise(intensities)):
            if category[i] and not category[i + 1]:
                if not allow_bad_fits:
                    if alpha_adjust is not None:
                        on_offs.setdefault((i, field), []).append(
                            (iON, dye_sequence[i] - dye_sequence[i + 1]))
                    else:
                        on_offs.setdefault((i, field), []).append(
                            (iON - alpha_adjust,
                             dye_sequence[i] - dye_sequence[i + 1]))
                else:
                    if alpha_adjust is not None:
                        on_offs.setdefault((i, field), []).append(
                            (iON - alpha_adjust, None))
                    else:
                        on_offs.setdefault((i, field), []).append(
                            (iON, None))
    return {(cycle, field): tuple(drops)
            for (cycle, field), drops in on_offs.items()}


def ON_OFF_adjust_photometries(photometries, ON_OFFS, alpha):
    """Per-(cycle, field) multiplicative intensity normalization
    (jupyter_development.py:262-276)."""
    adjusted = {}
    last_beta_dict = {(cycle, field): np.median([iON for iON, d in drops])
                      for (cycle, field), drops in ON_OFFS.items()}
    # Empty ON_OFFS: no (i, field) ever matches below, so the median is
    # never used — skip the empty-slice RuntimeWarning/NaN.
    last_beta_median = (float(np.median(list(last_beta_dict.values())))
                        if last_beta_dict else float("nan"))
    for channel, cdict in photometries.items():
        for field, fdict in cdict.items():
            for (h, w), (category, intensities, row) in fdict.items():
                adjusted_intensities = [
                    (intensity - alpha) * last_beta_median /
                    last_beta_dict[(i, field)]
                    if (i < len(intensities) - 1 and
                        (i, field) in last_beta_dict)
                    else intensity
                    for i, intensity in enumerate(intensities)]
                adjusted.setdefault(channel, {}).setdefault(
                    field, {}).setdefault(
                    (h, w), (category, tuple(adjusted_intensities), row))
    return adjusted


def signal_to_sequence(signal, num_frames, starting_intensity=None):
    """(jupyter_development.py:189-202)"""
    intensity = (len(signal) if starting_intensity is None
                 else starting_intensity)
    drop_positions = set(pos for aa, pos in signal)
    drop_counts = {pos: len([p for aa, p in signal if p == pos])
                   for pos in drop_positions}
    seq = []
    for frame in range(num_frames):
        if frame in drop_positions:
            intensity -= drop_counts[frame]
        seq.append(intensity)
    return tuple(seq)


def sequence_to_signal(seq):
    """(jupyter_development.py:204-213)"""
    signal_TFn = [seq[f] - fc for f, fc in enumerate(seq[1:])]
    signal = []
    for i, tf in enumerate(signal_TFn):
        if tf > 0:
            signal += [("A", i + 1)] * tf
        elif tf < 0:
            signal = None
            break
    return tuple(signal) if signal is not None else None


def sequence_to_category(seq):
    return tuple(s > 0 for s in seq)


def r_squared(data, fit):
    data, fit = np.array(data), np.array(fit)
    res = float(np.sum((data - fit) ** 2))
    tot = float(np.sum((data - np.mean(data)) ** 2))
    return 1.0 - res / tot


def make_histx(bins):
    return [np.mean([x1, x2]) for x1, x2 in _pairwise(tuple(bins))]


def fast_mode(array):
    from scipy.stats import find_repeats
    array = np.asarray(array)
    values, counts = find_repeats(array)
    if len(counts) == 0:
        array = np.sort(array)
        return array[0], 1.0
    position = counts.argmax()
    return values[position], counts[position]


def qq(sample1, sample2, num_quantiles=101):
    s1, s2 = sorted(sample1), sorted(sample2)
    quantiles = np.linspace(0, 100, num_quantiles)
    return tuple((np.percentile(s1, q), np.percentile(s2, q))
                 for q in quantiles)


def generate_intensities(fluorosequence, beta, beta_sigma, number,
                         quench_factors=None):
    if quench_factors is None:
        quench_factors = [0.0] * len(fluorosequence)
    category = tuple(seq != 0 for seq in fluorosequence)
    intensities = [np.random.lognormal(
        mean=math.log(beta) + math.log(seq) - quench_factors[seq - 1],
        sigma=beta_sigma, size=number)
        if seq > 0 else [0.0] * number
        for seq in fluorosequence]
    return category, tuple(zip(*intensities))


def generate_sequences(max_possible, num_cycles, num_samples, category):
    return tuple(zip(*[[choice(range(1, max_possible + 1))
                        for _ in range(num_samples)]
                       if category[cycle] else [0] * num_samples
                       for cycle in range(num_cycles)]))


def split_heatmap(num_cycles, cycle):
    """(jupyter_development.py:227-248)"""
    all_SD = [(("A", c),) for c in range(1, num_cycles + 1)]
    all_DD = [(("A", b), ("A", c))
              for c in range(1, num_cycles + 1) for b in range(1, c)]
    before = ([(((aa, c),), True, 1) for ((aa, c),) in all_SD if c < cycle] +
              [(((a1, b), (a2, c)), True, 2)
               for ((a1, b), (a2, c)) in all_DD if c < cycle])
    after = ([(((aa, c),), True, 1) for ((aa, c),) in all_SD if c >= cycle] +
             [(((a1, b), (a2, c)), True, 2)
              for ((a1, b), (a2, c)) in all_DD if c >= cycle])
    return tuple(before), tuple(after)


def unwind_photometries(photometries):
    for channel, cdict in photometries.items():
        for field, fdict in cdict.items():
            for (h, w), (category, intensities, row) in fdict.items():
                yield (channel, field, h, w, category, intensities, row)


def diff_signals(boc_signals, ac_signals, zero_only=True,
                 allow_multidrop=False, filter_negatives=True,
                 max_baseline_method=False, percent_change=False):
    """Experiment-minus-control signal subtraction
    (jupyter_development.py:1319-1358): filter to zero-level non-multidrop
    signals, normalize control counts (total ratio or max-baseline), then
    per-key rounded difference."""
    def _keep(s, z):
        return not (zero_only and not z) and \
            not (not allow_multidrop and len(s) < len(set(s)))

    filtered_boc = {(s, z, si): count
                    for (s, z, si), count in boc_signals.items()
                    if _keep(s, z)}
    filtered_ac = {(s, z, si): count
                   for (s, z, si), count in ac_signals.items()
                   if _keep(s, z)}
    if max_baseline_method:
        ratios = {}
        for key, ac_count in filtered_ac.items():
            assert ac_count > 0
            ratios[key] = float(filtered_boc.get(key, 0)) / ac_count
        normalization_ratio = min(ratios.values())
    else:
        normalization_ratio = (float(sum(filtered_boc.values())) /
                               sum(filtered_ac.values()))
    diff = {}
    for key in set(filtered_boc) | set(filtered_ac):
        boc_count = filtered_boc.get(key, 0)
        ac_count = filtered_ac.get(key, 0)
        diff[key] = _py2_round(boc_count - ac_count * normalization_ratio)
    if filter_negatives:
        diff = {key: count for key, count in diff.items() if count > 0}
    if percent_change:
        pc = {}
        for key, count in diff.items():
            boc_count = filtered_boc.get(key, 0)
            if boc_count != 0:
                pc.setdefault(key, float(count) / boc_count)
        diff = pc
    return diff


def sig(peptides, acid="C"):
    """Per-peptide acid-position signatures (jupyter_development.py:1302)."""
    signature = []
    for head, tail in peptides:
        if acid in head:
            s = head.split(acid)
            if s[-1] == acid:
                sigt = tuple([len(c) + 1 for c in s])
            else:
                sigt = tuple([len(c) + 1 for c in s][:-1])
            signature.append(sigt)
    return set(signature), signature


def signal_to_cumulative(signal):
    """Cumulative positions of a gap signal (jupyter_development.py:1314)."""
    return tuple(s + sum(signal[:i]) for i, s in enumerate(signal))


def grab_ith_intensities(all_fit_info, i=1, grab_signal=None,
                         allow_nonzero=False, log_xform=True,
                         alpha_adjust=None, grab_category=None,
                         grab_well_sequenced=None, grab_poorly_sequenced=None,
                         grab_last_on=None):
    """Per-field i-th frame intensities from v8 fit info
    (jupyter_development.py:86-120)."""
    i -= 1
    intensities_by_field = {}
    for (channel, field, h, w, row, category, intensities, signal, is_zero,
         dye_sequence, lmii, total_score, per_frame_scores,
         starting_intensity) in all_fit_info:
        if grab_signal is not None and (signal is None or
                                        grab_signal != signal):
            continue
        if grab_category is not None and category != grab_category:
            continue
        if not allow_nonzero and (is_zero is None or not is_zero):
            continue
        if (grab_well_sequenced is not None and grab_well_sequenced and
                signal is None):
            continue
        if (grab_poorly_sequenced is not None and grab_poorly_sequenced and
                signal is not None):
            continue
        if (grab_last_on is not None and grab_last_on and
                (i == len(intensities) - 1 or
                 not (category[i] and not category[i + 1]))):
            continue
        target = intensities[i]
        if alpha_adjust is not None:
            target -= alpha_adjust
        if log_xform and target <= 0:
            continue
        target = math.log(target) if log_xform else target
        intensities_by_field.setdefault(field, []).append(target)
    return {field: tuple(v) for field, v in intensities_by_field.items()}


def grab_ith_jth_intensities(all_fit_info, i=1, j=5, grab_signal=None,
                             allow_nonzero=False, log_xform=True,
                             alpha_adjust=None, norm_scoring=None):
    """Paired (i-th, j-th) frame intensities from v8 fit info
    (jupyter_development.py:144-172)."""
    i -= 1
    j -= 1
    pairs_by_field = {}
    for (channel, field, h, w, row, category, intensities, signal, is_zero,
         dye_sequence, lmii, total_score, per_frame_scores,
         starting_intensity) in all_fit_info:
        if signal is not None and signal != grab_signal:
            continue
        if not is_zero and not allow_nonzero:
            continue
        ti, tj = intensities[i], intensities[j]
        if alpha_adjust is not None:
            ti -= alpha_adjust
            tj -= alpha_adjust
        vi = math.log(ti) if log_xform else ti
        vj = math.log(tj) if log_xform else tj
        if norm_scoring is not None:
            mean_i, std_i, mean_j, std_j = norm_scoring
            vi = float(vi - mean_i) / std_i
            vj = float(vj - mean_j) / std_j
        pairs_by_field.setdefault(field, []).append((vi, vj))
    return {field: tuple(v) for field, v in pairs_by_field.items()}


def gmm_raw_photometries(raw_photometries):
    """One-component GMM of raw photometries -> (model, mean, std)
    (jupyter_development.py:174-180)."""
    from .ops.mixture import GaussianMixture
    nested = [[p] for p in raw_photometries]
    g = GaussianMixture(n_components=1, n_init=10, max_iter=100,
                        covariance_type="full")
    g.fit(nested)
    mean = float(g.means_[0])
    std = float(math.sqrt(g.covariances_[0]))
    return g, mean, std


def signal_correlation(observed_signals, fit_signals, heatmap_only=True,
                       zero_only=True, metric="naive",
                       normalize_counts=False, matching_p=0.10,
                       exclude_signals=None, print_included_signals=False,
                       select_signals=None, heatmap_normalize_counts=False,
                       allow_multidrop=False, small_count_cutoff=None,
                       euclidean_weights=None):
    """Observed-vs-fit signal-count agreement metrics
    (jupyter_development.py:279-578). Implements every metric branch the
    reference actually computes; branches the reference stubs out with
    NotImplementedError raise the same way. Returns
    ``(result, (normalization_factor, contributions))``."""
    def _included(key, s, z):
        if select_signals is not None and key not in select_signals:
            return False
        if zero_only and not z:
            return False
        if heatmap_only and len(s) not in (1, 2):
            return False
        if not allow_multidrop and len(set(s)) < len(s):
            return False
        if exclude_signals is not None and key in exclude_signals:
            return False
        return True

    paired = []
    for (s, z, si), observed_count in observed_signals.items():
        if not _included((s, z, si), s, z):
            continue
        if print_included_signals:
            print("Including signal " + str((s, z, si)))
        paired.append((observed_count, fit_signals.get((s, z, si), 0),
                       (s, z, si)))
    for (s, z, si), fit_count in fit_signals.items():
        if (s, z, si) in observed_signals:
            continue
        if not _included((s, z, si), s, z):
            continue
        if print_included_signals:
            print("Including signal " + str((s, z, si)))
        paired.append((observed_signals.get((s, z, si), 0), fit_count,
                       (s, z, si)))
    if small_count_cutoff is not None:
        paired = [(o, f, k) for o, f, k in paired
                  if o >= small_count_cutoff and f >= small_count_cutoff]
    observed_counts = np.array([o for o, f, k in paired])
    fit_counts = np.array([f for o, f, k in paired])
    if normalize_counts and len(paired) > 0 and np.sum(fit_counts) > 0:
        normalization_factor = (float(np.sum(observed_counts)) /
                                np.sum(fit_counts))
    elif heatmap_normalize_counts:
        obs_total, fit_total = 0, 0
        for (s, z, si), observed_count in observed_signals.items():
            if not z or len(s) not in (1, 2) or len(set(s)) < len(s):
                continue
            obs_total += observed_count
            fit_total += fit_signals.get((s, z, si), 0)
        for (s, z, si), fit_count in fit_signals.items():
            if (s, z, si) in observed_signals:
                continue
            if not z or len(s) not in (1, 2) or len(set(s)) < len(s):
                continue
            fit_total += fit_count
        normalization_factor = float(obs_total) / float(fit_total)
    else:
        normalization_factor = 1.0
    fit_counts = fit_counts * float(normalization_factor)
    paired = [(o, f * float(normalization_factor), k) for o, f, k in paired]

    def _observed_n():
        return sum(observed_count
                   for (s, z, si), observed_count in observed_signals.items()
                   if (not zero_only or z) and
                   (allow_multidrop or len(set(s)) == len(s)))

    contributions = {}
    if len(paired) == 0:
        result = None
    elif metric == "naive":
        contributions = {k: o * f for o, f, k in paired}
        result = sum(contributions.values())
    elif metric in ("pearson", "euclidean", "chebyshev", "canberra",
                    "kendalltau"):
        raise NotImplementedError()
    elif metric == "my_chebyshev":
        contributions = {k: abs(o - f) for o, f, k in paired}
        result = np.amax(list(contributions.values()))
    elif metric == "my_normalized_chebyshev":
        contributions = {k: abs(o - f) / float(o) for o, f, k in paired
                         if o > 0}
        result = np.amax(list(contributions.values()))
    elif metric == "my_std_normalized_chebyshev":
        n = _observed_n()
        stds = {k: math.sqrt(o * (n - o) / float(n)) if o > 0 else 1
                for o, f, k in paired}
        contributions = {k: abs(o - f) / float(stds[k]) for o, f, k in paired}
        result = np.amax(list(contributions.values()))
    elif metric == "matching":
        if matching_p is None:
            raise ValueError("If matching, matching_p cannot be None")
        contributions = {k: abs(o - f) / float(o) <= matching_p
                         for o, f, k in paired}
        result = sum(1 for m in contributions.values() if m)
    elif metric == "matching_10p":
        matching = [abs(fit_counts[i] - v) / float(v) <= 0.10
                    for i, v in enumerate(observed_counts)]
        result = sum(1 for m in matching if m)
    elif metric == "my_euclidean":
        contributions = {k: (f - o) ** 2 for o, f, k in paired}
        result = math.sqrt(sum(contributions.values()))
    elif metric == "normalized_euclidean":
        contributions = {k: (float(f - o) / o) ** 2 for o, f, k in paired
                         if o > 0}
        result = math.sqrt(sum(contributions.values()))
    elif metric == "my_std_normalized_euclidean":
        n = _observed_n()
        stds = {k: math.sqrt(o * (n - o) / float(n)) if o > 0 else 1
                for o, f, k in paired}
        contributions = {k: (float(f - o) / stds[k]) ** 2 for o, f, k in
                         paired}
        result = math.sqrt(sum(contributions.values()))
    elif metric == "my_sim_std_normalized_euclidean":
        n = sum(fit_signals.values())
        stds = {k: math.sqrt(f * (n - f) / float(n)) if f > 0 else 1
                for o, f, k in paired}
        contributions = {k: (float(f - o) / stds[k]) ** 2 for o, f, k in
                         paired}
        result = math.sqrt(sum(contributions.values()))
    elif metric == "my_weighted_std_normalized_euclidean":
        if euclidean_weights is None:
            raise ValueError("my_weighted_std_normalized_euclidean "
                             "requires euclidean_weights.")
        n = _observed_n()
        stds = {k: math.sqrt(o * (n - o) / float(n)) if o > 0 else 1
                for o, f, k in paired}
        weights = dict(euclidean_weights)
        for o, f, k in paired:
            weights.setdefault(k, 0)
        contributions = {k: (float(f - o) * weights[k] / stds[k]) ** 2
                         for o, f, k in paired}
        result = math.sqrt(sum(contributions.values()))
    elif metric == "log_rmsd":
        contributions = {k: float(math.log(o + 1) - math.log(f + 1)) ** 2
                         for o, f, k in paired}
        if len(contributions) > 0:
            result = math.sqrt(sum(contributions.values()) /
                               float(len(contributions)))
        else:
            result = None
    elif metric == "my_canberra":
        contributions = {k: float(abs(o - f)) / (abs(o) + abs(f))
                         for o, f, k in paired}
        result = sum(contributions.values())
    elif metric == "my_pearson":
        diffs = {k: (o - f, o, f) for o, f, k in paired}
        o_sigma = np.std([o for d, o, f in diffs.values()])
        f_sigma = np.std([f for d, o, f in diffs.values()])
        o_mean = np.mean([o for d, o, f in diffs.values()])
        f_mean = np.mean([f for d, o, f in diffs.values()])
        contributions = {k: (o - o_mean) * (f - f_mean)
                         for k, (d, o, f) in diffs.items()}
        n = len(contributions)
        result = sum(contributions.values()) / float(f_sigma * o_sigma * n)
    elif metric == "my_kendalltau":
        contributions = {}
        for ii, (o_i, f_i, k_i) in enumerate(paired):
            for jj, (o_j, f_j, k_j) in enumerate(paired):
                if ii == jj:
                    continue
                d_o = o_i - o_j
                d_f = f_i - f_j
                if d_o == 0 or d_f == 0:
                    continue
                sign = (-1 if d_o < 0 else 1) * (-1 if d_f < 0 else 1)
                contributions.setdefault(k_i, 0)
                contributions[k_i] += sign
                contributions.setdefault(k_j, 0)
                contributions[k_j] += sign
        numerator = sum(contributions.values())
        denominator = len(paired) * (len(paired) - 1) / 2.0 * 4.0
        result = numerator / denominator if denominator != 0 else None
    elif metric == "my_spearman_rho":
        by_obs = sorted(enumerate(paired), key=lambda x: x[1][0])
        by_fit = sorted(enumerate(paired), key=lambda x: x[1][1])
        mean_rank = (len(by_fit) - 1) / 2.0
        o_deltas = {p[2]: j - mean_rank for j, (i, p) in enumerate(by_obs)}
        f_deltas = {p[2]: j - mean_rank for j, (i, p) in enumerate(by_fit)}
        contributions = {k: od * f_deltas[k] for k, od in o_deltas.items()}
        numerator = sum(contributions.values())
        denominator = math.sqrt(sum(v ** 2 for v in o_deltas.values()) *
                                sum(v ** 2 for v in f_deltas.values()))
        result = numerator / denominator if denominator != 0 else None
    else:
        raise ValueError("Invalid metric chosen.")
    return result, (normalization_factor, contributions)


def fasta_to_dict(fasta_path):
    """Parse a FASTA file to {name: sequence}
    (jupyter_development.py:1262+)."""
    out = {}
    name = None
    seq_parts = []
    with open(fasta_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    out[name] = "".join(seq_parts)
                name = line[1:].split()[0]
                seq_parts = []
            else:
                seq_parts.append(line)
    if name is not None:
        out[name] = "".join(seq_parts)
    return out


import collections

IncompatibilityKey = collections.namedtuple(
    "IncompatibilityKey",
    ["metric", "reverse_order", "normalize_counts",
     "heatmap_normalize_counts", "heatmap_only", "zero_only",
     "allow_multidrop", "small_count_cutoff", "matching_p", "split_cycle",
     "incompatibility_threshold", "compute_incompatibility_scores"])

incompatibility_scores_cache = {}


def match_diagnostic(all_simulations, observed_signals, metric,
                     reverse_order, normalize_counts,
                     heatmap_normalize_counts, heatmap_only, zero_only,
                     allow_multidrop, small_count_cutoff, matching_p,
                     split_cycle, incompatibility_threshold,
                     compute_incompatibility_scores, num_mocks,
                     num_mocks_omitted, num_edmans):
    """Sim-vs-observed diagnostic (jupyter_development.py:786-1010 core).

    Scores every simulated (p, b, u) parameter point against the observed
    signal counts with :func:`signal_correlation`, picks the best by the
    requested metric/order, and returns the normalized best-fit signals and
    their per-signal %diff against the observations. The reference's
    incompatibility pass depends on an undefined notebook global
    (``ADJ_SDL_signals``) and a shelve file; here it runs against
    ``observed_signals`` with an in-module cache. The plotly subplot
    rendering at the tail of the reference is notebook-side display and is
    not reproduced; the returned dict carries everything those panels show.

    Returns dict with: optimal_pbu, normalization_factor, contributions,
    normalized_plot_signals, normalized_plot_molecular_signals,
    diff_plot_signals, exclude_signals, incompatibility_scores.
    """
    num_cycles = num_mocks + num_mocks_omitted - num_edmans
    if normalize_counts == heatmap_normalize_counts:
        raise ValueError("normalize_counts == heatmap_normalize_counts")
    if heatmap_only:
        if not heatmap_normalize_counts or allow_multidrop:
            raise ValueError("If heatmap_only, then "
                             "heatmap_normalize_counts "
                             "and not allow_multidrop")
    if (incompatibility_threshold is not None and
            not compute_incompatibility_scores):
        raise ValueError("If incompatibility_threshold is not None, "
                         "then compute_incompatibility_scores")
    key = IncompatibilityKey(
        metric=metric, reverse_order=reverse_order,
        normalize_counts=normalize_counts,
        heatmap_normalize_counts=heatmap_normalize_counts,
        heatmap_only=heatmap_only, zero_only=zero_only,
        allow_multidrop=allow_multidrop,
        small_count_cutoff=small_count_cutoff, matching_p=matching_p,
        split_cycle=split_cycle,
        incompatibility_threshold=incompatibility_threshold,
        compute_incompatibility_scores=compute_incompatibility_scores)

    def _best(correlations):
        ranked = sorted(correlations.items(), key=lambda x: x[1][0],
                        reverse=reverse_order)
        (pbu, (result, (nf, contrib))) = ranked[0]
        return pbu, nf, contrib

    def _correlate(select_signals):
        return {pbu: signal_correlation(
            observed_signals=observed_signals, fit_signals=signals,
            heatmap_only=heatmap_only, zero_only=zero_only,
            normalize_counts=normalize_counts, metric=metric,
            exclude_signals=None, matching_p=matching_p,
            select_signals=select_signals, print_included_signals=False,
            heatmap_normalize_counts=heatmap_normalize_counts,
            small_count_cutoff=small_count_cutoff)
            for pbu, (signals, molecular_signals) in all_simulations.items()}

    if compute_incompatibility_scores and \
            key not in incompatibility_scores_cache:
        _, all_cycles = split_heatmap(num_cycles=num_cycles, cycle=0)
        incompatibilities = {}
        for ss1, ss2 in itertools.combinations(all_cycles, 2):
            pbu, nf, contrib = _best(_correlate({ss1, ss2}))
            incompatibilities.setdefault(ss1, []).append(
                contrib.get(ss1, None))
            incompatibilities.setdefault(ss2, []).append(
                contrib.get(ss2, None))
        agg = min if reverse_order else max
        max_incompat = {}
        for k2, values in incompatibilities.items():
            vals = [v for v in values if v is not None]
            if vals:
                max_incompat[k2] = agg(vals)
        incompatibility_scores_cache[key] = max_incompat
    incompatibility_scores = (incompatibility_scores_cache.get(key, {})
                              if compute_incompatibility_scores else {})

    if incompatibility_threshold is not None:
        exclude_by_incompatibility = set(
            k2 for k2, mi in incompatibility_scores.items()
            if mi > incompatibility_threshold)
    else:
        exclude_by_incompatibility = set()
    before_cycle, after_cycle = split_heatmap(num_cycles=num_cycles,
                                              cycle=split_cycle)
    exclude_signals = exclude_by_incompatibility | set(before_cycle)

    optimal_pbu, normalization_factor, optimal_contributions = \
        _best(_correlate(None))
    plot_signals, plot_molecular_signals = all_simulations[optimal_pbu]
    normalized_plot_signals = {
        k2: _py2_round(count * normalization_factor)
        for k2, count in plot_signals.items()}
    normalized_plot_molecular_signals = {
        k2: _py2_round(count * normalization_factor)
        for k2, count in plot_molecular_signals.items()}
    diff_plot_signals = {
        k2: float(observed_count - normalized_plot_signals[k2]) /
        observed_count
        for k2, observed_count in observed_signals.items()
        if k2 in normalized_plot_signals and observed_count > 0}
    return {
        "optimal_pbu": optimal_pbu,
        "normalization_factor": normalization_factor,
        "contributions": optimal_contributions,
        "normalized_plot_signals": normalized_plot_signals,
        "normalized_plot_molecular_signals":
            normalized_plot_molecular_signals,
        "diff_plot_signals": diff_plot_signals,
        "exclude_signals": exclude_signals,
        "incompatibility_scores": incompatibility_scores,
    }
