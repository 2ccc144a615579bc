"""Step fitting: plateaus fitted to per-spot luminosity traces.

A plateau is ``(start_frame, stop_frame, height)`` with inclusive stops; a
step fit is a list of plateaus covering all frames. API and semantics parity
with the reference's stepfitting_library
(stepfitting_library.py):

- Kerssemakers chi-squared fitter with counter-fits (:342-505),
- sliding-window Welch's-t fitter (:929-1066) — note it intersects step
  sets across radii range(5, window_radius) and picks the LAST frame of
  each consecutive group (the reference sorts by frame despite its
  variable naming),
- Chung-Kennedy forward/backward predictor filter (:1081-1273),
- upstep / small-step / Welch-t merge filters (:732-926, 1328-1480) with
  the reference's single-pass-until-stable iteration structure,
- mirror utilities (:1703-1746).

These functions are host-side (NumPy/SciPy) and exact: the float64
specification of every step-fit function. The module is a copy of
fluorosequencingimageanalysis_tpu/stepfitting.py (which imports no jax),
held equal to it function by function by tests/test_torch_import.py,
``chi_squared_fit_batch`` apart (no engine probe, no Python fallback). The
batched many-traces path lives in ops/stepfit_batch.py.
"""

from __future__ import annotations

import itertools
import math
import warnings

import numpy as np
from scipy.stats import linregress


def _pairwise(iterable):
    a, b = itertools.tee(iterable)
    next(b, None)
    return zip(a, b)


def _welch_t(left, right):
    """Two-tailed Welch t-test (t, p); nan-safe like scipy on degenerate
    inputs (empty or single-element windows -> nan p).

    Direct transcription of scipy.stats.ttest_ind(equal_var=False)'s
    math (Welch denominator + Welch-Satterthwaite df + student-t sf),
    bit-compared against scipy in tests/test_stepfit.py — the scipy
    wrapper's per-call overhead (~1.7 ms of axis/nan policy machinery)
    dominated whole-experiment step fitting."""
    if len(left) == 0 or len(right) == 0:
        return float("nan"), float("nan")
    from scipy.special import stdtr
    a = np.asarray(left, dtype=np.float64)
    b = np.asarray(right, dtype=np.float64)
    n1, n2 = a.size, b.size
    with np.errstate(divide="ignore", invalid="ignore"):
        # scipy's _var: second central moment scaled by n/(n-1) — same
        # value as np.var(ddof=1) but a different float op order; keep
        # scipy's so results stay bit-identical.
        v1 = np.mean((a - a.mean()) ** 2) * \
            np.divide(np.float64(n1), np.float64(n1 - 1))
        v2 = np.mean((b - b.mean()) ** 2) * \
            np.divide(np.float64(n2), np.float64(n2 - 1))
        vn1, vn2 = v1 / n1, v2 / n2
        df = (vn1 + vn2) ** 2 / (vn1 ** 2 / (n1 - 1) + vn2 ** 2 / (n2 - 1))
        if np.isnan(df):
            # scipy's carve-out: all-zero variances -> df of 1
            df = 1.0
        t = (a.mean() - b.mean()) / np.sqrt(vn1 + vn2)
        p = 2.0 * stdtr(df, -np.abs(t))
    return float(t), float(p)


def _plateau_squared_residuals(luminosities, plateau):
    # Builtin sequential sum, NOT np.sum: the reference's
    # ``sum([(lum - height)**2 ...])`` (stepfitting_library.py:80) adds
    # left-to-right, while numpy's pairwise reduction pairs differently —
    # bit-different residuals flip near-tied split/merge decisions
    # (the <=-last-tie-wins rule, _best_split's <, the Kerssemakers S
    # ranking), forking the whole fit chain from the reference.
    start, stop, height = plateau
    return float(sum([(lum - height) ** 2
                      for lum in luminosities[start:stop + 1]]))


def _plateaus_squared_residuals(luminosities, plateaus):
    return sum(_plateau_squared_residuals(luminosities, p) for p in plateaus)


def _fit_plateau(luminosities, starting_frame, stopping_frame):
    if not 0 <= starting_frame <= stopping_frame < len(luminosities):
        raise ValueError(
            "Invalid (starting_frame, stopping_frame): " +
            str((starting_frame, stopping_frame)) +
            " with len(luminosities) = " + str(len(luminosities)))
    return (starting_frame, stopping_frame,
            float(np.mean(luminosities[starting_frame:stopping_frame + 1])))


def _split_plateau(luminosities, plateau, forbidden_splits=None,
                   min_step_magnitude=5000):
    """Best binary split of one plateau (stepfitting_library.py:113-179)."""
    start, stop, height = plateau
    if not 0 <= start <= stop < len(luminosities):
        raise ValueError("plateau start and stop does not fit within "
                         "luminosities")
    forbidden = set(forbidden_splits) if forbidden_splits else set()
    span = float(np.max(np.asarray(luminosities, dtype=float)) -
                 np.min(np.asarray(luminosities, dtype=float)))
    big = len(luminosities) * span ** 2
    best = (None, big, None, big, 2 * big)
    # Per-split np.mean + sequential residual sums: the reference's exact
    # float-op order. A prefix-sum form (left_sq - left_sum^2/k) was
    # tried and dropped — at photometry magnitudes (~6e4, squared sums
    # ~1e11) it loses 2-3 digits to cancellation, and near-tied split
    # candidates under the <=-last-tie-wins rule can then pick a
    # DIFFERENT split than the reference, diverging the whole
    # Kerssemakers chain discretely.
    for s in range(start, stop):
        if (s, s + 1) in forbidden:
            continue
        left = _fit_plateau(luminosities, start, s)
        right = _fit_plateau(luminosities, s + 1, stop)
        if abs(left[2] - right[2]) < min_step_magnitude:
            continue
        left_res = _plateau_squared_residuals(luminosities, left)
        right_res = _plateau_squared_residuals(luminosities, right)
        total = left_res + right_res
        if total <= best[4]:  # <= for the flat case, like the reference
            best = (left, left_res, right, right_res, total)
    return best


def _best_split(luminosities, plateaus, bestfit_plateaus=None,
                min_step_length=2, min_step_magnitude=5000):
    """Split whichever plateau yields the lowest total residual
    (stepfitting_library.py:182-271), honoring counter-fit constraints."""
    forbidden = []
    if bestfit_plateaus is not None:
        for p, (start, stop, height) in enumerate(bestfit_plateaus[:-1]):
            next_start = bestfit_plateaus[p + 1][0]
            forbidden.append((stop, next_start))
        all_cf_starts = [s for (s, e, h) in plateaus]
        for (start, stop, height) in bestfit_plateaus:
            for f in range(start, stop + 1):
                if f in all_cf_starts:
                    forbidden += [(u, u + 1) for u in range(start, stop)]
    for (start, stop, height) in plateaus:
        if stop - start < min_step_length:
            forbidden += [(u, u + 1) for u in range(start, stop)]
    for (start, stop, height) in plateaus:
        for u in range(start, stop):
            if u - start < min_step_length or stop - u < min_step_length:
                forbidden.append((u, u + 1))

    lum = np.asarray(luminosities, dtype=float)
    best_index = None
    best_residuals = len(lum) * float(np.max(lum) - np.min(lum)) ** 2
    best_results = None
    for p, plateau in enumerate(plateaus):
        (lp, lr, rp, rr, tot) = _split_plateau(
            luminosities, plateau, forbidden_splits=forbidden,
            min_step_magnitude=min_step_magnitude)
        if lp is not None and rp is not None and tot < best_residuals:
            best_index, best_residuals = p, tot
            best_results = (lp, lr, rp, rr, tot)
    if best_index is None:
        return None
    lp, lr, rp, rr, tot = best_results
    return plateaus[:best_index] + [lp, rp] + plateaus[best_index + 1:]


def _fit_steps(luminosities, num_plateaus, bestfit_plateaus=None,
               existing_fit=None, min_step_length=2, min_step_magnitude=5000):
    """Iterative best-split fitting loop (stepfitting_library.py:274-339)."""
    if len(luminosities) < num_plateaus:
        raise ValueError("num_plateaus = " + str(num_plateaus) +
                         " is greater than len(luminosities) = " +
                         str(len(luminosities)))
    if (bestfit_plateaus is not None and
            len(bestfit_plateaus) + 1 != num_plateaus):
        raise ValueError("len(bestfit_plateaus) + 1 != num_plateaus")
    if existing_fit is not None and num_plateaus < len(existing_fit):
        raise ValueError("num_plateaus < len(existing_fit)")
    if existing_fit is None:
        plateaus = [_fit_plateau(luminosities, 0, len(luminosities) - 1)]
    else:
        plateaus = existing_fit
    while len(plateaus) < num_plateaus:
        new_plateaus = _best_split(luminosities, plateaus,
                                   bestfit_plateaus=bestfit_plateaus,
                                   min_step_length=min_step_length,
                                   min_step_magnitude=min_step_magnitude)
        if new_plateaus is None:
            break
        plateaus = new_plateaus
    return plateaus


def chi_squared_step_fitter(luminosity_sequence, num_steps_multiplier=1,
                            num_steps=None, min_step_length=2,
                            min_step_magnitude=0.0, ignore_counterfits=False):
    """Kerssemakers et al. best-fit/counter-fit step fitter
    (stepfitting_library.py:342-505)."""
    if not 0 < num_steps_multiplier <= 1:
        raise ValueError("num_steps_multiplier has an invalid value of " +
                         str(num_steps_multiplier))
    if (num_steps is not None and
            not 0 < num_steps < len(luminosity_sequence)):
        raise ValueError("num_steps has an invalid value of " +
                         str(num_steps))
    if num_steps is None:
        num_steps = min(int(np.ceil(num_steps_multiplier *
                                    len(luminosity_sequence))),
                        len(luminosity_sequence) - 2)
    num_plateaus = num_steps + 1
    plateau_fits = []
    for p in range(1, num_plateaus + 1):
        existing_fit = plateau_fits[-1][0] if plateau_fits else None
        best_fit = _fit_steps(luminosity_sequence, p,
                              bestfit_plateaus=None,
                              existing_fit=existing_fit,
                              min_step_length=min_step_length,
                              min_step_magnitude=min_step_magnitude)
        if plateau_fits and len(best_fit) == len(plateau_fits[-1][0]):
            break
        bf_res = _plateaus_squared_residuals(luminosity_sequence, best_fit)
        counter_fit = _fit_steps(luminosity_sequence, p + 1,
                                 bestfit_plateaus=best_fit,
                                 existing_fit=None,
                                 min_step_length=0,
                                 min_step_magnitude=min_step_magnitude)
        cf_res = _plateaus_squared_residuals(luminosity_sequence, counter_fit)
        S = (float(cf_res) / float(bf_res)) if bf_res != 0 else 10 ** 10
        plateau_fits.append((best_fit, counter_fit, S))
    if ignore_counterfits:
        return sorted(plateau_fits, key=lambda x: len(x[0]),
                      reverse=True)[0][0]
    return sorted(plateau_fits, key=lambda x: x[2], reverse=True)[0][0]


def chi_squared_fit_batch(traces, num_steps_multiplier=1, num_steps=None,
                          min_step_length=2, min_step_magnitude=0.0,
                          ignore_counterfits=False, n_threads=None,
                          engine=None, device="cuda"):
    """Batched Kerssemakers chi-squared fitter over an (N, T) trace stack.

    ``engine``: None or "native" run the native C++ core
    (csrc/chisqfit.cpp, built with g++ at first use; a failed build
    raises, there is no Python fallback): host work, threaded over the
    batch, per-trace results bit-equal to :func:`chi_squared_step_fitter`
    (the host oracle, itself the exact port of
    stepfitting_library.py:342-505). "device" runs the [N, T] float64
    program of ops/chisq_batch_device.py on ``device`` ("cuda" unless the
    caller passes "cpu"): equal in exact arithmetic, it may differ from the
    oracle only on last-ulp-tied split decisions; heights are the host's
    exact np.mean either way. The ``num_steps = T - 1`` edge, which the
    device program excludes, runs on the native core whatever the engine.

    Returns a list of N step fits (each a list of (start, stop, height)
    plateau triples).
    """
    traces = np.asarray(traces, dtype=np.float64)
    if traces.ndim != 2:
        raise ValueError("traces must be an (N, T) stack")
    N, T = traces.shape
    # Same validation as chi_squared_step_fitter (the reference's
    # wrapper, stepfitting_library.py:342-380).
    if not 0 < num_steps_multiplier <= 1:
        raise ValueError("num_steps_multiplier has an invalid value of " +
                         str(num_steps_multiplier))
    if num_steps is not None and not 0 < num_steps < T:
        raise ValueError("num_steps has an invalid value of " +
                         str(num_steps))
    if T < 2:
        raise ValueError("chi-squared fitting needs at least 2 frames")
    if engine not in (None, "native", "device"):
        raise ValueError(f"engine must be None, 'native' or 'device' (got "
                         f"{engine!r})")
    if num_steps is None:
        num_steps = min(int(np.ceil(num_steps_multiplier * T)), T - 2)
    num_plateaus = num_steps + 1
    if N == 0:
        return []
    if engine == "device" and num_steps <= T - 2:
        from .ops.chisq_batch_device import chi_squared_fit_device
        return chi_squared_fit_device(
            traces, num_steps=num_steps, min_step_length=min_step_length,
            min_step_magnitude=min_step_magnitude,
            ignore_counterfits=ignore_counterfits, device=device)
    from .native import chisqfit as _ncf

    n, start, stop, height = _ncf.chisq_fit_batch_native(
        traces, num_plateaus, min_step_length, min_step_magnitude,
        ignore_counterfits, n_threads=n_threads)
    if (n < 0).any():
        # Native flags the trace whose counterfit target p + 1 exceeded T
        # (num_steps = T - 1 with min_step_length = 0 and a best fit that
        # grew to T plateaus); the host chain raises inside _fit_steps
        # there, with this error.
        raise ValueError("num_plateaus = " + str(T + 1) +
                         " is greater than len(luminosities) = " +
                         str(T))
    return [
        [(int(start[i, j]), int(stop[i, j]), float(height[i, j]))
         for j in range(int(n[i]))]
        for i in range(N)
    ]


def plateau_value(plateaus, frame):
    for (start, stop, height) in plateaus:
        if start <= frame <= stop:
            return height
    raise ValueError("frame " + str(frame) + " is outside of plateaus " +
                     str(plateaus))


def plateaus_to_steps(plateaus):
    return [(a[1], b[0], b[2] - a[2]) for a, b in _pairwise(plateaus)]


def last_step_info(steps, frame):
    if frame < 0:
        raise ValueError("frame must be a positive integer.")
    for s, (step_a, step_b) in enumerate(_pairwise(steps)):
        pre_a, post_a, mag_a = step_a
        pre_b, post_b, mag_b = step_b
        if post_a <= frame <= pre_b:
            return (s, pre_a, mag_a)
    if len(steps) == 0:
        return None, None, None
    last_pre, last_post, last_mag = steps[-1]
    if frame >= last_pre:
        return (len(steps) - 1, last_pre, last_mag)
    return None, None, None


def frame_plateau(plateaus, frame):
    for p, (start, stop, height) in enumerate(plateaus):
        if start <= frame <= stop:
            return (start, stop, height), p
    return (None, None, None), None


def plateau_starts(plateaus):
    return set(start for (start, stop, height) in plateaus)


def _consecutive_integers(integers):
    out = []
    for k, g in itertools.groupby(enumerate(integers), lambda t: t[0] - t[1]):
        out.append([x for _, x in g])
    return out


def _merge_plateaus(luminosities, plateau_a, plateau_b):
    start_a, stop_a, _ = plateau_a
    start_b, stop_b, _ = plateau_b
    if stop_a + 1 != start_b:
        raise ValueError("Merged plateaus must be consecutive.")
    return _fit_plateau(luminosities, start_a, stop_b)


def _adjacent_merge_pass(luminosities, plateaus, should_merge):
    """Shared single-pass merge structure (merge a with b when
    should_merge(a, b); skip a's already consumed; append trailing b)."""
    if len(plateaus) < 2:
        return plateaus
    filtered = []
    for a, b in _pairwise(plateaus):
        if filtered and a[1] == filtered[-1][1]:
            continue
        if should_merge(a, b):
            filtered.append(_merge_plateaus(luminosities, a, b))
        else:
            filtered.append(a)
    if plateaus[-1][1] != filtered[-1][1]:
        filtered.append(plateaus[-1])
    return filtered


def _filter_upsteps_singlepass(luminosities, plateaus):
    return _adjacent_merge_pass(luminosities, plateaus,
                                lambda a, b: b[2] > a[2])


def filter_upsteps(luminosities, plateaus):
    filtered = plateaus
    for _ in range(len(plateaus) - 1):
        filtered = _filter_upsteps_singlepass(luminosities, filtered)
    return filtered


def _filter_small_steps_singlepass(luminosities, plateaus, min_magnitude=None,
                                   min_noise_ratio=None):
    def should_merge(a, b):
        step_size = abs(a[2] - b[2])
        if min_noise_ratio is not None:
            max_noise = max(
                math.sqrt(_plateau_squared_residuals(luminosities, a)),
                math.sqrt(_plateau_squared_residuals(luminosities, b)))
            if step_size < max_noise * min_noise_ratio:
                return True
        return min_magnitude is not None and step_size < min_magnitude

    return _adjacent_merge_pass(luminosities, plateaus, should_merge)


def filter_small_steps(luminosities, plateaus, min_magnitude=None,
                       min_noise_ratio=None):
    if min_magnitude is not None and min_magnitude < 0:
        raise ValueError("min_step_magnitude < 0 makes no sense.")
    if min_noise_ratio is not None and min_noise_ratio < 0:
        raise ValueError("min_step_noise_ratio < 0 makes no sense.")
    filtered = plateaus
    for _ in range(len(plateaus) - 1):
        filtered = _filter_small_steps_singlepass(
            luminosities, filtered, min_magnitude=min_magnitude,
            min_noise_ratio=min_noise_ratio)
    return filtered


def sliding_t_fitter(luminosity_sequence, window_radius=20, p_threshold=0.001,
                     median_filter_size=None, downsteps_only=False,
                     min_step_magnitude=None):
    """Sliding-window Welch's-t step fitter (stepfitting_library.py:929-1066).

    Parity notes:
    - windows use Python slice semantics ``seq[f-radius:f]`` — for f < radius
      (with len(seq) > radius) the left window is empty and the t-test yields
      nan, i.e. no step can be detected in the first `radius` frames;
    - step candidates are intersected across radii range(5, window_radius);
    - per consecutive group the LAST frame is chosen (the reference sorts by
      frame index, not by t, stepfitting_library.py:1033-1037).
    """
    seq = list(luminosity_sequence)
    if median_filter_size is not None:
        from scipy.signal import medfilt
        seq = list(medfilt(seq, kernel_size=median_filter_size))
    step_positions_by_radius = []
    for radius in range(5, window_radius):
        step_positions_by_radius.append([])
        for f in range(len(seq)):
            left = seq[f - radius:f]
            right = seq[f:f + radius]
            _t, p = _welch_t(left, right)
            if p < p_threshold:
                step_positions_by_radius[-1].append(f)
    if step_positions_by_radius:
        step_intersection = set(step_positions_by_radius[0])
    else:
        step_intersection = set()
    for steps in step_positions_by_radius:
        step_intersection &= set(steps)
    step_positions = sorted(step_intersection)
    filtered_positions = [grouping[-1]
                          for grouping in
                          _consecutive_integers(step_positions)]
    step_positions = filtered_positions
    if step_positions:
        plateaus = [_fit_plateau(seq, 0, step_positions[0] - 1)]
        for f1, f2 in _pairwise(step_positions):
            plateaus.append(_fit_plateau(seq, f1, f2 - 1))
        plateaus.append(_fit_plateau(seq, step_positions[-1], len(seq) - 1))
    else:
        plateaus = [_fit_plateau(seq, 0, len(seq) - 1)]
    if downsteps_only:
        plateaus = filter_upsteps(seq, plateaus)
    if min_step_magnitude is not None:
        plateaus = filter_small_steps(seq, plateaus,
                                      min_magnitude=min_step_magnitude)
    return plateaus


def chung_kennedy_filter(luminosities, window_lengths=tuple(range(2, 17)),
                         M=10, p=2):
    """Chung & Kennedy forward/backward non-linear filter
    (stepfitting_library.py:1081-1273).

    For each window length w: the front predictor at frame L is the mean of
    the w+1-frame window strictly before L (the reference's rear_window is
    ``seq[max(L-w-1,0):L]``), the back predictor the mean of the w-frame
    window strictly after. Weights are inverse p-th powers of the windowed
    prediction errors (window M, with the reference's edge truncations);
    edge frames use only the one-sided predictor.
    """
    lum = [float(x) for x in luminosities]
    n = len(lum)
    if not n > 2:
        raise ValueError("luminosities must have len(luminosities) > 2")
    front_pred = {}
    back_pred = {}
    for w in window_lengths:
        fp = [None] * n
        bp = [None] * n
        for L in range(n):
            rear = lum[max(L - w - 1, 0):L]
            front = lum[L + 1:L + w + 1]
            fp[L] = float(np.mean(rear)) if rear else None
            bp[L] = float(np.mean(front)) if front else None
        front_pred[w] = fp
        back_pred[w] = bp
    front_w = {w: [0.0] * n for w in window_lengths}
    back_w = {w: [0.0] * n for w in window_lengths}
    for w in window_lengths:
        for L in range(n):
            if L == 0:
                front_w[w][L], back_w[w][L] = 0.0, 1.0
            elif L == n - 1:
                front_w[w][L], back_w[w][L] = 1.0, 0.0
            else:
                rear_window = lum[max(L - M + 1, 0):L + 1]
                f_preds = front_pred[w][max(L - M + 1, 0):L + 1]
                front_window = lum[L:L + M]
                b_preds = back_pred[w][L:L + M]
                if L - M < 0:
                    rear_window = rear_window[1:]
                    f_preds = f_preds[1:]
                if L + M >= n - 1:
                    front_window = front_window[:-1]
                    b_preds = b_preds[:-1]
                # Builtin sequential sum like the reference
                # (stepfitting_library.py:1194-1196) — np.sum's pairwise
                # pairing bit-differs on these <= M=10 element windows,
                # rippling into the predictor weights.
                b_diff = float(sum((np.array(rear_window) -
                                    np.array(f_preds)) ** 2))
                f_diff = float(sum((np.array(front_window) -
                                    np.array(b_preds)) ** 2))
                if b_diff != 0 and f_diff != 0:
                    front_w[w][L] = b_diff ** -p
                    back_w[w][L] = f_diff ** -p
                elif b_diff == 0 and f_diff != 0:
                    front_w[w][L] = 1.0
                    back_w[w][L] = 0.0
                elif b_diff != 0 and f_diff == 0:
                    front_w[w][L] = 0.0
                    back_w[w][L] = 1.0
                else:
                    front_w[w][L] = 1.0
                    back_w[w][L] = 0.0
    totals = [sum(front_w[w][L] for w in window_lengths) +
              sum(back_w[w][L] for w in window_lengths) for L in range(n)]
    out = [0.0] * n
    for L in range(n):
        if L == 0:
            out[L] = sum(back_w[w][L] / totals[L] * back_pred[w][L]
                         for w in window_lengths)
        elif L == n - 1:
            out[L] = sum(front_w[w][L] / totals[L] * front_pred[w][L]
                         for w in window_lengths)
        else:
            out[L] = sum(front_w[w][L] / totals[L] * front_pred[w][L] +
                         back_w[w][L] / totals[L] * back_pred[w][L]
                         for w in window_lengths)
    return out


def refit_plateaus(luminosities, plateaus):
    return [_fit_plateau(luminosities, start, stop)
            for start, stop, height in plateaus]


def _t_test_filter_singlepass(luminosities, plateaus, p_threshold,
                              drop_sort=True, no_merge_start=0):
    """One merge pass of the Welch-t plateau filter
    (stepfitting_library.py:1328-1438), including the drop_sort variant's
    conflict resolution (merges ranked by descending p; neighbors of an
    accepted merge are vetoed)."""
    if len(plateaus) < 2:
        return plateaus
    if not drop_sort:
        def should_merge(a, b):
            if a[1] < no_merge_start:
                return False
            t, p = _welch_t(luminosities[a[0]:a[1] + 1],
                            luminosities[b[0]:b[1] + 1])
            return p >= p_threshold

        return _adjacent_merge_pass(luminosities, plateaus, should_merge)

    pair_drops = []
    for r, (a, b) in enumerate(_pairwise(plateaus)):
        t, p = _welch_t(luminosities[a[0]:a[1] + 1],
                        luminosities[b[0]:b[1] + 1])
        pair_drops.append([a, b, p, r])
    # NaN p-values (zero-variance equal-mean plateau pairs, e.g. exact-0
    # absent-frame tails) sort LAST under a deterministic total order.
    # The reference's sorted() with NaN keys is Timsort-implementation-
    # defined (a NaN mid-list can leave REAL p-values mutually
    # misordered); for real-valued p this key is identical to the
    # reference's, and the deterministic corner matches the native core
    # (native/stepchain.cpp tfilter_singlepass). See PARITY.md.
    s_pairs = sorted(pair_drops,
                     key=lambda x: float("-inf") if math.isnan(x[2])
                     else x[2], reverse=True)
    merge_bools = [False] * len(s_pairs)
    for i, (a, b, p, r) in enumerate(s_pairs):
        if p >= p_threshold and a[1] >= no_merge_start:
            merge_bools[i] = True
    for i, (a, b, p, r) in enumerate(s_pairs):
        if merge_bools[i]:
            for j, (a2, b2, p2, r2) in enumerate(s_pairs):
                if j <= i:
                    continue
                if a == b2 or b == a2:
                    merge_bools[j] = False
    merge_by_rank = {r: merge_bools[i]
                     for i, (a, b, p, r) in enumerate(s_pairs)}
    filtered = []
    for r, (a, b) in enumerate(_pairwise(plateaus)):
        if filtered and a[1] == filtered[-1][1]:
            continue
        if merge_by_rank[r]:
            filtered.append(_merge_plateaus(luminosities, a, b))
        else:
            filtered.append(a)
    if plateaus[-1][1] != filtered[-1][1]:
        filtered.append(plateaus[-1])
    return filtered


def t_test_filter(luminosities, plateaus, p_threshold, drop_sort=True,
                  no_merge_start=0):
    filtered = plateaus
    for _ in range(len(plateaus) - 1):
        filtered = _t_test_filter_singlepass(luminosities, filtered,
                                             p_threshold,
                                             drop_sort=drop_sort,
                                             no_merge_start=no_merge_start)
    return filtered


def stepfit_r_squared(luminosities, plateaus):
    first_start = plateaus[0][0]
    last_stop = plateaus[-1][1]
    mean_plateau = _fit_plateau(luminosities, first_start, last_stop)
    return 1.0 - (float(_plateaus_squared_residuals(luminosities, plateaus)) /
                  _plateau_squared_residuals(luminosities, mean_plateau))


def linear_fits(luminosities, plateaus, midpoint_fits=True):
    """Line-vs-step comparison across plateau pairs
    (stepfitting_library.py:1506-1575)."""
    r_2 = {}
    indexed = list(enumerate(plateaus))
    for (ia, pa), (ib, pb) in itertools.combinations(indexed, 2):
        a_start, a_stop, a_height = pa
        b_start, b_stop, b_height = pb
        if midpoint_fits:
            a_mid = int(np.around((a_stop - a_start) / 2.0) + a_start)
            b_mid = int(np.around((b_stop - b_start) / 2.0) + b_start)
            pts = list(enumerate(luminosities))[a_mid:b_mid + 1]
            step_to_fit = ([(a_mid, a_stop, a_height)] +
                           plateaus[ia + 1:ib] +
                           [(b_start, b_mid, b_height)])
        else:
            pts = list(enumerate(luminosities))[a_start:b_stop + 1]
            step_to_fit = plateaus[ia:ib + 1]
        xs, ys = zip(*pts)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            slope, intercept, r_val, p_val, stderr = linregress(xs, ys)
        r_2.setdefault((ia, ib),
                       (r_val ** 2, stepfit_r_squared(luminosities,
                                                      step_to_fit)))
    return r_2


def best_linear_explainer(r_2, steepest=True, longest=False,
                          r2_ratio_threshold=1.0, plateaus=None,
                          track_index=None):
    """Pick the plateau pair best explained by a line
    (stepfitting_library.py:1578-1663). Faithful to the reference's
    branch structure, including the quirk that the `steepest` branch
    never updates the running best (case 4 falls through)."""
    if (steepest and longest) or (not steepest and not longest):
        raise ValueError("Must select either steepest or longest as criteria.")
    best = (None, None, None)
    for (ia, ib), (linear_r_2, stepfit_r_2) in r_2.items():
        LLa, LLb, LLr = best
        if stepfit_r_2 == 0:
            continue
        ratio = float(linear_r_2) / stepfit_r_2
        if LLa is None and ratio > r2_ratio_threshold:
            best = (ia, ib, ratio)
        elif LLr is None:
            continue
        elif longest and LLb - LLa < ib - ia and ratio > r2_ratio_threshold:
            best = (ia, ib, ratio)
        elif steepest and ratio > LLr:
            pass  # reference case 4: logged but not updated
        elif LLb - LLa == ib - ia and ratio > LLr:
            best = (ia, ib, ratio)
    return best


def mirror_photometries(photometries, mirror_size):
    if mirror_size < 0:
        raise ValueError("mirror_size must be greater than 0.")
    return (list(reversed(photometries[:mirror_size])) + list(photometries))


def unmirror_photometries(photometries, mirror_size):
    if mirror_size < 0:
        raise ValueError("mirror_size must be greater than 0.")
    return photometries[mirror_size:]


def unmirror_plateaus(plateaus, mirror_size):
    if mirror_size < 0:
        raise ValueError("mirror_size must be greater than 0.")
    out = []
    for a, o, h in [(a - mirror_size, o - mirror_size, h)
                    for a, o, h in plateaus]:
        if a < 0 and o < 0:
            continue
        elif a < 0 <= o:
            out.append((0, o, h))
        else:
            out.append((a, o, h))
    return out


def _triplewise(iterable):
    """s -> (s0,s1,s2), (s1,s2,s3), ... (stepfitting_library.py:570-592)."""
    a, b, c = itertools.tee(iterable, 3)
    next(b, None)
    next(c, None)
    next(c, None)
    return zip(a, b, c)


def mean_filter(luminosities, rank):
    """Deprecated in the reference (stepfitting_library.py:532-543)."""
    raise DeprecationWarning("This function was made, but not used. I'm not "
                             "sure it handles edges the way I want it to "
                             "right now.")


def remove_blips(luminosities, plateaus, smoothing_stddev=0.8):
    """Deprecated in the reference (stepfitting_library.py:1276-1279)."""
    raise DeprecationWarning("This function was made quickly, and has some "
                             "fundamental logical errors. Use at own risk.")


def best_t_test_split(luminosities, plateau_a, plateau_b, p_threshold,
                      split_range=None, find_best_p=True):
    """Deprecated in the reference (stepfitting_library.py:1666-1677)."""
    raise DeprecationWarning("This was used as a function for some algorithm "
                             "we were trying. Not really needed right now.")
