"""Track-photometry ingestion and adjustment.

Counterpart of fluorosequencingimageanalysis_tpu/inference/photometries.py:
parity with the reference's CSV round-trip and remainder adjustments
(MCsimlib.py:2534-2575, 3398-3472, 5560-5586). Host code, copied from the
JAX package function for function; only ``read_track_photometries_csv``
differs (a native parser that fails to build raises here).

The photometries dict convention (the compatibility surface):
    {channel: {field: {(h, w): (category, intensities, row)}}}
"""

from __future__ import annotations

import csv
import itertools

import numpy as np


def _pairwise(iterable):
    a, b = itertools.tee(iterable)
    next(b, None)
    return zip(a, b)


from ..utils.rounding import py2_round as _py2_round  # noqa: E402


def read_track_photometries_csv(path, downstep_filtered=False, head_truncate=0,
                                tail_truncate=0, omit_header=True,
                                channels=None, use_native=True):
    """Parse a track_photometries CSV (MCsimlib.py:2534-2575).

    Returns (d, d2): d is the photometries dict; d2 maps CSV row index to
    the parsed row tuple.

    With ``use_native`` (default) the tokenizing/number-parsing pass runs
    in the C++ parser (csrc/trackcsv.cpp) and only the dict assembly stays
    in Python; identical output. A file the parser refuses (ragged frame
    counts) goes to the pure-Python reader below; a parser that cannot be
    built raises.
    """
    if use_native:
        from ..native.trackcsv import parse_track_csv_native
        out = parse_track_csv_native(
            path, downstep_filtered=downstep_filtered,
            head_truncate=head_truncate, tail_truncate=tail_truncate,
            omit_header=omit_header, channels=channels)
        if out is not None:
            return out
    with open(path) as f:
        reader = csv.reader(f)
        d = {}
        d2 = {}
        for r, row in enumerate(reader):
            if r == 0 and omit_header:
                continue
            head, frames = row[:5], row[5:]
            channel, field, h, w, category = head
            if channels is not None and channel not in channels:
                continue
            if h == "None" or w == "None":
                continue
            # Py2 int(round(x)) rounds half AWAY from zero; Python 3's
            # banker's rounding would disagree on *.5 values
            # (MCsimlib.py:2550-2552).
            field, h, w = (_py2_round(float(field)), _py2_round(float(h)),
                           _py2_round(float(w)))
            category = category[1:-1]
            category = category.split(" ")
            parsed_cat = tuple(c in ("True,", "True") for c in category)
            if tail_truncate > 0:
                parsed_cat = parsed_cat[head_truncate:-tail_truncate]
            else:
                parsed_cat = parsed_cat[head_truncate:]
            parsed_cat = tuple(parsed_cat)
            if downstep_filtered:
                if not (tuple(sorted(parsed_cat, reverse=True)) == parsed_cat
                        and parsed_cat[0]):
                    continue
            parsed_frames = [_py2_round(float(x)) for x in frames]
            if tail_truncate > 0:
                parsed_frames = parsed_frames[head_truncate:-tail_truncate]
            else:
                parsed_frames = parsed_frames[head_truncate:]
            parsed_frames = tuple(parsed_frames)
            d.setdefault(channel, {}).setdefault(field, {}).setdefault(
                (h, w), (parsed_cat, parsed_frames, r))
            d2.setdefault(r, (channel, field, h, w, parsed_cat, parsed_frames))
    return d, d2


def unwind_photometries(photometries):
    """Flatten the photometries dict (MCsimlib.py:5560-5564)."""
    for channel, cdict in photometries.items():
        for field, fdict in cdict.items():
            for (h, w), (category, intensities, row) in fdict.items():
                yield (channel, field, h, w, category, intensities, row)


def alpha_adjust_photometries(photometries, alpha):
    """Subtract the alpha zero-level from every intensity (the
    lognormal_fitter_v2 adjustment, reference lognormal_fitter_v2.py:
    136-143), leaving categories/rows untouched."""
    return {c: {f: {hw: (cat, tuple(x - alpha for x in ints), row)
                    for hw, (cat, ints, row) in fd.items()}
                for f, fd in cd.items()}
            for c, cd in photometries.items()}


def write_photometries_dict_to_csv(photometries, filepath, dialect="excel"):
    """Inverse of read_track_photometries_csv (MCsimlib.py:5566-5586)."""
    with open(filepath, "w", newline="") as f:
        output_writer = csv.writer(f, dialect=dialect)
        cdict = next(iter(photometries.values()))
        fdict = next(iter(cdict.values()))
        category, intensities, row = next(iter(fdict.values()))
        num_cycles = len(category)
        output_writer.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                               ["FRAME " + str(i) for i in range(num_cycles)])
        row_counter = 0
        for (channel, field, h, w, category, intensities,
             row) in unwind_photometries(photometries):
            output_writer.writerow(
                [str(channel), str(field), str(h), str(w), str(category)] +
                [str(i) for i in intensities])
            row_counter += 1
    return row_counter


def _r_2(a, b):
    """a is data, b is fit (MCsimlib.py:2584-2587)."""
    a, b = np.array(a, dtype=float), np.array(b, dtype=float)
    return 1.0 - np.sum((a - b) ** 2) / np.sum((a - np.mean(a)) ** 2)


def _check_no_downsteps(plateaus):
    return not any(p1[0] < p2[0] for p1, p2 in _pairwise(plateaus))


def _plateau_fit(intensities, max_num_drops, include_original_intensities=False,
                 downsteps_only=False, use_adjusted_r_2=False, delta_r_2=0.05,
                 original_intensities_only=True, **kwargs):
    """Exhaustive drop-position plateau fit (MCsimlib.py:2597-2673)."""
    best_fit, best_r_2, best_adj_r_2 = None, -1, -1
    if len(set(intensities)) == 1:
        # The reference assigns the 1.0 to a dead variable (a
        # `best_adjusted_r2` typo, MCsimlib.py:2604), so under
        # use_adjusted_r_2=True a uniform trace returns r_2 == -1.
        # Replicated bug-for-bug: callers key off that sentinel.
        best_fit, best_r_2 = [[x for x in intensities]], 1.0
    else:
        for drops in itertools.product(range(len(intensities)),
                                       repeat=max_num_drops):
            drops = sorted(set(drops))
            drop_ends = [d - 1 for d in drops] + [len(intensities) - 1]
            if drop_ends[0] < 0:
                drop_ends = drop_ends[1:]
            else:
                drops.insert(0, 0)
            plateau_tuples = list(zip(drops, drop_ends))
            plateaus = [intensities[start:stop + 1]
                        for start, stop in plateau_tuples]
            plateau_fits = [[np.mean(p)] * len(p) for p in plateaus]
            merged = list(itertools.chain(*plateau_fits))
            r_2 = _r_2(intensities, merged)
            if np.isnan(r_2):
                continue
            if downsteps_only and not _check_no_downsteps(plateau_fits):
                continue
            if use_adjusted_r_2:
                k = 2.0 * len(plateau_fits) - 1.0
                # len(intensities) == k + 1 makes the denominator zero;
                # the reference's numpy scalars yield inf/nan there (and a
                # RuntimeWarning) — keep the values, silence the warning.
                with np.errstate(divide="ignore", invalid="ignore"):
                    adj = (1.0 - (1.0 - r_2) * (len(intensities) - 1.0) /
                           np.float64(len(intensities) - k - 1.0))
                if best_fit is None or len(plateau_fits) <= len(best_fit):
                    if adj > best_adj_r_2:
                        best_fit, best_adj_r_2 = plateau_fits, adj
                elif len(plateau_fits) > len(best_fit):
                    if adj > best_adj_r_2 + delta_r_2:
                        best_fit, best_adj_r_2 = plateau_fits, adj
            else:
                if best_fit is None or len(plateau_fits) <= len(best_fit):
                    if r_2 > best_r_2:
                        best_fit, best_r_2 = plateau_fits, r_2
                elif len(plateau_fits) > len(best_fit):
                    if r_2 > best_r_2 + delta_r_2:
                        best_fit, best_r_2 = plateau_fits, r_2
    if include_original_intensities and original_intensities_only:
        raise Exception
    if include_original_intensities:
        i = 0
        out = []
        for plateau in best_fit:
            out.append([])
            for v in plateau:
                out[-1].append((v, intensities[i]))
                i += 1
        best_fit = out
    elif original_intensities_only:
        i = 0
        out = []
        for plateau in best_fit:
            out.append([])
            for v in plateau:
                out[-1].append(intensities[i])
                i += 1
        best_fit = out
    if use_adjusted_r_2:
        best_r_2 = best_adj_r_2
    return best_fit, best_r_2


def _all_plateau_fits(intensities, max_num_drops, storage_r_2_cutoff=0.7):
    """All drop-position fits above an R^2 cutoff (MCsimlib.py:2676-2720)."""
    all_fits = []
    if len(set(intensities)) == 1:
        fit = [[(x, x) for x in intensities]]
        all_fits.append((tuple(fit), 1.0, 1.0))
        return all_fits
    for drops in itertools.product(range(len(intensities)),
                                   repeat=max_num_drops):
        drops = sorted(set(drops))
        drop_ends = [d - 1 for d in drops] + [len(intensities) - 1]
        if drop_ends[0] < 0:
            drop_ends = drop_ends[1:]
        else:
            drops.insert(0, 0)
        plateau_tuples = list(zip(drops, drop_ends))
        plateaus = [intensities[start:stop + 1]
                    for start, stop in plateau_tuples]
        plateau_fits = [[np.mean(p)] * len(p) for p in plateaus]
        merged = list(itertools.chain(*plateau_fits))
        r_2 = _r_2(intensities, merged)
        if r_2 < storage_r_2_cutoff:
            continue
        k = 2.0 * len(plateau_fits) - 1.0
        adj = (1.0 - (1.0 - r_2) * (len(intensities) - 1.0) /
               (len(intensities) - k - 1.0))
        i = 0
        out = []
        for plateau in plateau_fits:
            out.append([])
            for v in plateau:
                out[-1].append((v, intensities[i]))
                i += 1
        all_fits.append((tuple(out), r_2, adj))
    return all_fits


def _remainder_adjust(photometries, num_frames, minimum_r_per_field=5):
    """Additive per-field remainder-median adjustment
    (MCsimlib.py:3398-3431)."""
    remainder_values = {}
    for channel, cdict in photometries.items():
        for field, fdict in cdict.items():
            for (h, w), (category, intensities, row) in fdict.items():
                if set(category) != {True}:
                    continue
                remainder_values.setdefault(channel, {}).setdefault(
                    field, [[] for _ in range(num_frames)])
                for frame, intensity in enumerate(intensities):
                    remainder_values[channel][field][frame].append(intensity)
    remainder_adjustments = {}
    for channel, cdict in remainder_values.items():
        for field, remainder_lists in cdict.items():
            if len(remainder_lists[0]) < minimum_r_per_field:
                continue
            medians = [np.median(rl) for rl in remainder_lists]
            adjustments = [m - medians[0] for m in medians]
            remainder_adjustments.setdefault(channel, {}).setdefault(
                field, adjustments)
    adjusted = {}
    for channel, cdict in remainder_adjustments.items():
        adjusted.setdefault(channel, {})
        for field, adjustments in cdict.items():
            adjusted[channel].setdefault(field, {})
            for (h, w), (category, intensities,
                         row) in photometries[channel][field].items():
                adj_int = [i - adjustments[f]
                           for f, i in enumerate(intensities)]
                adjusted[channel][field].setdefault(
                    (h, w), (category, adj_int, row))
    return adjusted, remainder_adjustments


def remainder_adjust_diff_median(photometries, num_frames,
                                 minimum_r_per_field=5, use_median=False):
    """Method-1 remainder correction: subtract the per-field per-frame
    median of each remainder's deviation from its own mean (or median)
    (reference remainder_correction.py:61-99)."""
    remainder_diffs = {}
    for channel, cdict in photometries.items():
        for field, fdict in cdict.items():
            remainder_diffs.setdefault(channel, {}).setdefault(
                field, [[] for _ in range(num_frames)])
            for (h, w), (category, intensities, row) in fdict.items():
                if set(category) != {True}:
                    continue
                m = (np.median(intensities) if use_median
                     else np.mean(intensities))
                for frame, intensity in enumerate(intensities):
                    remainder_diffs[channel][field][frame].append(
                        intensity - m)
    remainder_medians = {}
    for channel, cdict in remainder_diffs.items():
        for field, diff_lists in cdict.items():
            if any(len(d) < minimum_r_per_field for d in diff_lists):
                continue
            remainder_medians.setdefault(channel, {}).setdefault(
                field, [np.median(d) for d in diff_lists])
    adjusted = {}
    for channel, cdict in remainder_medians.items():
        adjusted.setdefault(channel, {})
        for field, medians in cdict.items():
            adjusted[channel].setdefault(field, {})
            for (h, w), (category, intensities,
                         row) in photometries[channel][field].items():
                adj = [i - medians[f] for f, i in enumerate(intensities)]
                adjusted[channel][field].setdefault((h, w),
                                                    (category, adj, row))
    return adjusted, remainder_medians


def remainder_adjust_frame0_ratio(photometries, num_frames,
                                  minimum_r_per_field=5):
    """Method-3 remainder correction: scale every frame by the ratio of
    the field's frame-0 remainder median to that frame's remainder
    median (reference remainder_correction.py:137-170)."""
    remainder_values = {}
    for channel, cdict in photometries.items():
        for field, fdict in cdict.items():
            for (h, w), (category, intensities, row) in fdict.items():
                if set(category) != {True}:
                    continue
                remainder_values.setdefault(channel, {}).setdefault(
                    field, [[] for _ in range(num_frames)])
                for frame, intensity in enumerate(intensities):
                    remainder_values[channel][field][frame].append(intensity)
    adjustments = {}
    for channel, cdict in remainder_values.items():
        for field, rl in cdict.items():
            if len(rl[0]) < minimum_r_per_field:
                continue
            medians = [np.median(r) for r in rl]
            adjustments.setdefault(channel, {}).setdefault(
                field, [medians[0] / float(m) for m in medians])
    adjusted = {}
    for channel, cdict in adjustments.items():
        adjusted.setdefault(channel, {})
        for field, adj in cdict.items():
            adjusted[channel].setdefault(field, {})
            for (h, w), (category, intensities,
                         row) in photometries[channel][field].items():
                a = [i * adj[f] for f, i in enumerate(intensities)]
                adjusted[channel][field].setdefault((h, w),
                                                    (category, a, row))
    return adjusted, adjustments


def remainder_correct(photometries, num_frames, method=4,
                      minimum_r_per_field=5, use_median=False):
    """Remainder-based photometry correction, methods 1-4 (the
    remainder_correction app's full menu; reference
    remainder_correction.py:44-191):

    1. subtract per-field per-frame medians of remainder deviations;
    2. subtract additive remainder medians relative to frame 0
       (MCsimlib._remainder_adjust);
    3. multiply by the frame-0 remainder-median ratio;
    4. multiplicative median-ratio I*(1-median deviation ratio)
       (MCsimlib._remainder_adjust_2) — the reference's default.

    Returns (adjusted photometries dict, adjustments dict).
    """
    if method == 1:
        return remainder_adjust_diff_median(
            photometries, num_frames, minimum_r_per_field=minimum_r_per_field,
            use_median=use_median)
    if method == 2:
        return _remainder_adjust(photometries, num_frames,
                                 minimum_r_per_field=minimum_r_per_field)
    if method == 3:
        return remainder_adjust_frame0_ratio(
            photometries, num_frames, minimum_r_per_field=minimum_r_per_field)
    if method == 4:
        return _remainder_adjust_2(photometries, num_frames,
                                   minimum_r_per_field=minimum_r_per_field)
    raise ValueError("Unknown method.")


def _remainder_adjust_2(photometries, num_frames, minimum_r_per_field=5):
    """Multiplicative median-ratio adjustment (MCsimlib.py:3434-3472)."""
    adjustment_ratios = {}
    for channel, cdict in photometries.items():
        adjustment_ratios.setdefault(channel, {})
        for field, fdict in cdict.items():
            adjustment_ratios[channel].setdefault(
                field, [[] for _ in range(num_frames)])
            for (h, w), (category, intensities, row) in fdict.items():
                if set(category) == {True}:
                    m = np.median(intensities)
                    for i, intensity in enumerate(intensities):
                        adjustment_ratios[channel][field][i].append(
                            float(intensity - m) / m)
    medians = {}
    for channel, cdict in adjustment_ratios.items():
        for field, field_ratios in cdict.items():
            if any(len(r) < minimum_r_per_field for r in field_ratios):
                continue
            medians.setdefault(channel, {}).setdefault(
                field, [np.median(r) for r in field_ratios])
    adjusted = {}
    for channel, cdict in photometries.items():
        if channel not in medians:
            continue
        adjusted.setdefault(channel, {})
        for field, fdict in cdict.items():
            if field not in medians[channel]:
                continue
            adjusted[channel].setdefault(field, {})
            ar = medians[channel][field]
            for (h, w), (category, intensities, row) in fdict.items():
                adj_int = [intensity * (1.0 - ar[i])
                           for i, intensity in enumerate(intensities)]
                adjusted[channel][field].setdefault(
                    (h, w), (category, adj_int, row))
    return adjusted, medians
