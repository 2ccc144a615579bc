"""The v8 lognormal fluor-count fitter: traces -> signals.

Counterpart of fluorosequencingimageanalysis_tpu/inference/lognormal.py,
copied function for function with the ``mesh`` argument turned into
``device``. The reference fans one Pool task out per spot, each enumerating
C(n_cycles + max_fluors, n_cycles) candidate sequences in Python
(MCsimlib.py:5387-5558). Here all traces score all sequences in batched
device calls (ops/lognormal.py); the host code only shapes dicts and
decodes winners. A device list or a ``_device.Mesh`` in ``device``
splits the traces over its data devices, as the JAX functions' mesh does.

``_intensities_to_signal_lognormal_v8`` is kept as an exact single-trace
implementation (used for parity tests and tiny inputs);
``_photometries_lognormal_fit_MP_v8`` preserves the reference signature and
returns (signals, total_count, none_count, all_fit_info) but runs the
batched path (num_processes is accepted and ignored).
"""

from __future__ import annotations

import math

import numpy as np

from ..ops.lognormal import score_traces, seq_to_signal, sequence_table
from .photometries import unwind_photometries


def _norm_pdf(x, loc, scale):
    return (math.exp(-((x - loc) ** 2) / (2.0 * scale ** 2)) /
            (scale * math.sqrt(2.0 * math.pi)))


def _intensities_to_signal_lognormal_v8(intensities, beta, beta_sigma,
                                        max_possible=5, allow_multidrop=True,
                                        allow_upsteps=False, max_deviation=3,
                                        quench_factor=0, categories=None,
                                        log_fluor_boundaries=None,
                                        log_fluor_means=None):
    """Exact single-trace v8 fit (MCsimlib.py:5387-5493)."""
    if categories is None:
        raise ValueError("categories required in v7+")
    if log_fluor_means is None:
        raise ValueError("v8+ requires log_fluor_means to be passed manually")
    lmii = max_possible
    best_seq, best_score, best_scores = None, -1, None
    log_intensities = [math.log(i) if i > 0 else -10000 for i in intensities]
    tab = sequence_table(len(intensities), lmii, allow_upsteps)
    for seq in tab:
        seq = tuple(int(v) for v in seq)
        if any((categories[i] and v == 0) or (not categories[i] and v > 0)
               for i, v in enumerate(seq)):
            continue
        if not allow_multidrop:
            seq_diff = [seq[i] - s for i, s in enumerate(seq[1:])]
            if seq_diff and max(seq_diff) > 1:
                continue
        deviations = [abs(log_intensities[i] - log_fluor_means[v - 1]) /
                      beta_sigma for i, v in enumerate(seq) if v > 0]
        if deviations and max(deviations) > max_deviation:
            continue
        scores = [1.0 if v == 0 else
                  _norm_pdf(log_intensities[i], log_fluor_means[v - 1],
                            beta_sigma)
                  for i, v in enumerate(seq)]
        total = 1.0
        for s in scores:
            total *= s
        if total > best_score:
            best_seq, best_score, best_scores = seq, total, scores
    if best_seq is not None:
        signal, is_zero, starting_intensity = seq_to_signal(best_seq)
    else:
        signal, is_zero, starting_intensity = None, None, None
    return (signal, is_zero, best_seq, lmii, best_score, best_scores,
            starting_intensity)


def photometries_lognormal_fit_v8(photometries, beta, beta_sigma,
                                  max_possible=5, allow_upsteps=False,
                                  allow_multidrop=True, max_deviation=3,
                                  quench_factor=0, quench_factors=None,
                                  device="cuda"):
    """Batched v8 fit over an entire photometries dict, scored on
    ``device``.

    Returns (signals, total_count, none_count, all_fit_info) exactly like
    the reference's _photometries_lognormal_fit_MP_v8 (MCsimlib.py:5496-5558).
    """
    if len(photometries) > 1:
        raise NotImplementedError("Currently puts all photometries together, "
                                  "can't handle multiple channels at once.")
    if quench_factors is None or len(quench_factors) != max_possible + 2:
        raise ValueError("quench_factors required for v8+")
    log_fluor_means = [math.log(beta) + math.log(i + 1.0) - quench_factors[i]
                       for i in range(max_possible + 2)]

    rows = list(unwind_photometries(photometries))
    if not rows:
        return {}, 0, 0, []
    intensities = np.array([r[5] for r in rows], dtype=np.float64)
    categories = np.array([r[4] for r in rows], dtype=bool)

    best_seqs, found, best_ls = score_traces(
        intensities, categories, log_fluor_means, beta_sigma,
        max_possible=max_possible, allow_multidrop=allow_multidrop,
        allow_upsteps=allow_upsteps, max_deviation=max_deviation,
        device=device)

    meta = [(channel, field, h, w, row, category, ints)
            for channel, field, h, w, category, ints, row in rows]
    return _decode_and_aggregate(meta, best_seqs, found, best_ls,
                                 log_fluor_means, beta_sigma, max_possible)


def _decode_and_aggregate(meta, best_seqs, found, best_ls, log_fluor_means,
                          beta_sigma, max_possible):
    """Winner decode + signals aggregation shared by the dict and
    dict-free arrays paths (MCsimlib.py:5467-5493 / 5541-5557 semantics:
    key = (signal, is_zero, starting_intensity), unfit traces counted in
    none_count, fit_info row per trace).

    meta: list of (channel, field, h, w, row, category, ints) per trace,
    index-aligned with the score_traces outputs.
    """
    found = np.asarray(found)
    best_seqs = np.asarray(best_seqs)
    best_ls = np.asarray(best_ls)
    signals = {}
    none_count = 0
    all_fit_info = []
    for i, (channel, field, h, w, row, category, ints) in enumerate(meta):
        if not found[i]:
            signal, is_zero, best_seq, starting_intensity = (None, None,
                                                             None, None)
            best_score = -1
            best_scores = None
        else:
            best_seq = tuple(int(v) for v in best_seqs[i])
            signal, is_zero, starting_intensity = seq_to_signal(best_seq)
            best_score = float(np.exp(best_ls[i]))
            log_int = [math.log(x) if x > 0 else -10000 for x in ints]
            best_scores = [1.0 if v == 0 else
                           _norm_pdf(log_int[f], log_fluor_means[v - 1],
                                     beta_sigma)
                           for f, v in enumerate(best_seq)]
        all_fit_info.append((channel, field, h, w, row, category, ints,
                             signal, is_zero, best_seq, max_possible,
                             best_score, best_scores, starting_intensity))
        if signal is None:
            none_count += 1
        else:
            key = (signal, is_zero, starting_intensity)
            signals[key] = signals.get(key, 0) + 1
    return signals, len(meta), none_count, all_fit_info


def _photometries_lognormal_fit_MP_v8(photometries, beta, beta_sigma,
                                      max_possible=5, num_processes=None,
                                      allow_upsteps=False,
                                      allow_multidrop=True, max_deviation=3,
                                      quench_factor=0, quench_factors=None):
    """Reference-signature wrapper; runs the batched path on the
    default device (num_processes accepted for compatibility, unused)."""
    return photometries_lognormal_fit_v8(
        photometries, beta, beta_sigma, max_possible=max_possible,
        allow_upsteps=allow_upsteps, allow_multidrop=allow_multidrop,
        max_deviation=max_deviation, quench_factor=quench_factor,
        quench_factors=quench_factors)


def lognormal_fit_v8_from_csv(path, beta, beta_sigma, max_possible=5,
                              allow_upsteps=False, allow_multidrop=True,
                              max_deviation=3, quench_factors=None,
                              downstep_filtered=False, head_truncate=0,
                              tail_truncate=0, alpha_adjust=0.0,
                              channels=None, device="cuda"):
    """End-to-end arrays path: track CSV -> batched v8 fit, dict-free.

    The reference pipeline is CSV -> photometries dict -> one Pool task per
    trace (MCsimlib.py:5517-5540). Here the native parser
    (csrc/trackcsv.cpp) emits flat (N, F) arrays which feed the batched
    scorer directly; the signals dict is only assembled for the final
    aggregated output. A file the native parser refuses (ragged frame
    counts) goes through the dict reader.

    ``channels``: optional iterable of channel names to keep — the way to
    fluor-count one channel of a multi-channel experiment CSV (a single
    beta/quench calibration cannot apply across channels, so mixed
    channels raise).

    Returns (signals, total_count, none_count, all_fit_info) with the same
    structure as photometries_lognormal_fit_v8.
    """
    from ..native.trackcsv import read_track_photometries_arrays

    def _take(arrs, idx):
        """Row-filter every column of the arrays dict (bool mask or
        integer index array; list columns filter positionally)."""
        sel = np.asarray(idx)
        pick = ((lambda v: [x for x, m in zip(v, sel) if m])
                if sel.dtype == bool
                else (lambda v: [v[i] for i in sel]))
        return {k: (np.asarray(v)[sel] if not isinstance(v, list)
                    else pick(v))
                for k, v in arrs.items()}

    arrs = read_track_photometries_arrays(
        path, downstep_filtered=downstep_filtered,
        head_truncate=head_truncate, tail_truncate=tail_truncate)
    if arrs is not None and channels is not None:
        chans = set(channels)
        keep = np.asarray([c in chans for c in arrs["channels"]], bool)
        if not keep.all():
            arrs = _take(arrs, keep)
    if arrs is None:
        from .photometries import (alpha_adjust_photometries,
                                   read_track_photometries_csv)
        photometries, _ = read_track_photometries_csv(
            path, downstep_filtered=downstep_filtered,
            head_truncate=head_truncate, tail_truncate=tail_truncate,
            channels=list(channels) if channels is not None else None)
        if alpha_adjust:
            photometries = alpha_adjust_photometries(photometries,
                                                     alpha_adjust)
        return photometries_lognormal_fit_v8(
            photometries, beta, beta_sigma, max_possible=max_possible,
            allow_upsteps=allow_upsteps, allow_multidrop=allow_multidrop,
            max_deviation=max_deviation, quench_factors=quench_factors,
            device=device)

    if quench_factors is None or len(quench_factors) != max_possible + 2:
        raise ValueError("quench_factors required for v8+")
    log_fluor_means = [math.log(beta) + math.log(i + 1.0) - quench_factors[i]
                       for i in range(max_possible + 2)]
    n = arrs["intensities"].shape[0]
    if n == 0:
        return {}, 0, 0, []
    if len(set(arrs["channels"])) > 1:
        # Same restriction (and message) as the dict path — the caller's
        # single beta/quench calibration cannot apply across channels.
        raise NotImplementedError("Currently puts all photometries "
                                  "together, can't handle multiple "
                                  "channels at once.")
    # Dedupe duplicate (channel, field, h, w) keys FIRST-WINS, exactly
    # like the dict reader's setdefault (MCsimlib.py:2572-2573): two
    # spots whose float centers round to the same pixel must collapse to
    # the first row on both paths.
    seen = set()
    keep = []
    for i in range(n):
        k = (arrs["channels"][i], int(arrs["fields"][i]),
             int(arrs["hs"][i]), int(arrs["ws"][i]))
        if k not in seen:
            seen.add(k)
            keep.append(i)
    if len(keep) != n:
        arrs = _take(arrs, np.asarray(keep))
        n = len(keep)
    intensities = arrs["intensities"].astype(np.float64) - alpha_adjust
    categories = arrs["categories"]
    best_seqs, found, best_ls = score_traces(
        intensities, categories, log_fluor_means, beta_sigma,
        max_possible=max_possible, allow_multidrop=allow_multidrop,
        allow_upsteps=allow_upsteps, max_deviation=max_deviation,
        device=device)

    # fit_info carries the same VALUES AND TYPES as the dict path: the
    # CSV reader parses ints, so with no alpha adjustment the rows hold
    # Python ints (float64 of an int64 is exact, so the scorer saw
    # identical numbers); an adjustment makes them floats on both paths.
    meta_ints = (arrs["intensities"].tolist() if alpha_adjust == 0
                 else intensities.tolist())
    meta = [(arrs["channels"][i], int(arrs["fields"][i]),
             int(arrs["hs"][i]), int(arrs["ws"][i]),
             int(arrs["rows"][i]), tuple(categories[i].tolist()),
             tuple(meta_ints[i])) for i in range(n)]
    return _decode_and_aggregate(meta, best_seqs, found, best_ls,
                                 log_fluor_means, beta_sigma, max_possible)
