"""Batched step fitting across many traces at once.

Counterpart of fluorosequencingimageanalysis_tpu/ops/stepfit_batch.py. The
host chain (stepfitting.py, the float64 specification) costs
O(T |windows| M) Python per trace; an experiment step-fits thousands of
traces. Here the two hot stages run over an (N, T) trace stack on one
device, in plain torch:

- :func:`chung_kennedy_batch`: the Chung & Kennedy forward/backward
  predictor filter (stepfitting_library.py:1081-1273) as cumulative-sum
  sliding windows, all traces in lockstep;
- :func:`sliding_t_masks`: the sliding-window Welch's-t step detector
  (stepfitting_library.py:929-1066) with p-values from the regularized
  incomplete beta (ops/special.py), intersected across radii, as one
  boolean (N, T) mask.

Both follow the dtype of the tensor they are given. :func:`stepfit_batched`
uploads float64 and computes in float64 on the CPU and on the card: the
specification is float64, the card has native float64 and the work is
small. The rest of the chain (plateau assembly, refit, the drop-sort
Welch-t merge) is ragged and runs in the native core (csrc/stepchain.cpp),
threaded over the traces.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import stepfitting
from .._device import shares
from .._transfer import count_fetched, fetch, wait
from ..utils import profiling
from .special import betainc

# Rows per device dispatch of stepfit_batched: bounds the working set (a
# chunk of 4096 x 110 float64 traces keeps ~60 temporaries of 3.6 MB).
STEPFIT_CHUNK = 4096


def _prefix(x):
    """Exclusive prefix sums along dim 1: out[:, i] = sum(x[:, :i])."""
    out = x.new_zeros((x.shape[0], x.shape[1] + 1))
    torch.cumsum(x, dim=1, out=out[:, 1:])
    return out


def chung_kennedy_batch(traces, window_lengths=(2, 4, 8, 16), M=10, p=2):
    """Chung-Kennedy filter over an (N, T) tensor of traces, in its dtype.

    Matches stepfitting.chung_kennedy_filter including its edge
    truncations: the rear weight window drops its first frame when L < M,
    the front weight window drops its last frame when L + M >= T - 1, and
    frames 0 and T-1 use only the one-sided predictor.
    """
    lum = traces
    N, T = lum.shape
    if T <= 2:
        # The host chain's error (stepfitting.chung_kennedy_filter): with
        # <= 2 frames the one-sided predictors would swap the two samples.
        raise ValueError("luminosities must have len(luminosities) > 2")
    dev, dt = lum.device, lum.dtype
    L = torch.arange(T, device=dev)
    c = _prefix(lum)
    one, zero = lum.new_ones(()), lum.new_zeros(())
    first, last = L == 0, L == T - 1

    num = torch.zeros_like(lum)
    tot = torch.zeros_like(lum)
    for w in window_lengths:
        # Front predictor: mean of lum[max(L-w-1, 0):L] (strictly before L).
        lo = (L - w - 1).clamp(min=0)
        cnt_f = (L - lo).to(dt)
        fp = torch.where(cnt_f > 0,
                         (c[:, :T] - c.index_select(1, lo)) /
                         cnt_f.clamp(min=1), zero)
        # Back predictor: mean of lum[L+1:L+w+1] (strictly after L).
        hi = (L + w + 1).clamp(max=T)
        cnt_b = (hi - (L + 1)).to(dt)
        bp = torch.where(cnt_b > 0,
                         (c.index_select(1, hi) - c[:, 1:]) /
                         cnt_b.clamp(min=1), zero)

        # Prediction-error windows (window M, reference edge truncations);
        # the undefined edge frames contribute nothing.
        sqf = (lum - fp) ** 2
        sqf[:, 0] = 0
        csqf = _prefix(sqf)
        sqb = (lum - bp) ** 2
        sqb[:, T - 1] = 0
        csqb = _prefix(sqb)

        # Rear window [lo2, L]: lo2 = L-M+1, but the reference drops the
        # first frame when L < M.
        lo2 = torch.where(L >= M, L - M + 1, torch.ones_like(L))
        b_diff = csqf[:, 1:] - csqf.index_select(1, torch.minimum(lo2, L + 1))
        # Front window [L, hi2): hi2 = min(L+M, T), minus one when
        # L + M >= T - 1 (dropped even when the slice misses T-1).
        lm = (L + M).clamp(max=T)
        hi2 = torch.where(L + M >= T - 1, lm - 1, lm)
        f_diff = csqb.index_select(1, torch.maximum(hi2, L)) - csqb[:, :T]

        b_zero = b_diff == 0
        f_zero = f_diff == 0
        fw = torch.where(
            b_zero & ~f_zero, one,
            torch.where(~b_zero & f_zero, zero,
                        torch.where(b_zero & f_zero, one,
                                    torch.where(b_diff > 0, b_diff, one)
                                    ** (-float(p)))))
        bw = torch.where(
            b_zero & ~f_zero, zero,
            torch.where(~b_zero & f_zero, one,
                        torch.where(b_zero & f_zero, zero,
                                    torch.where(f_diff > 0, f_diff, one)
                                    ** (-float(p)))))
        # Edge frames: one-sided.
        fw = torch.where(first, zero, torch.where(last, one, fw))
        bw = torch.where(first, one, torch.where(last, zero, bw))

        num = num + fw * fp + bw * bp
        tot = tot + fw + bw
    return num / tot


def _welch_p(mean_l, var_l, n_l, mean_r, var_r, n_r):
    """Two-tailed Welch's-t p-value; NaN where either window has < 2
    samples (as scipy.stats.ttest_ind on degenerate windows)."""
    one = mean_l.new_ones(())
    nan = mean_l.new_full((), float("nan"))
    vl = var_l / n_l
    vr = var_r / n_r
    denom = vl + vr
    pos = denom > 0
    t2 = torch.where(pos, (mean_l - mean_r) ** 2 /
                     torch.where(pos, denom, one),
                     mean_l.new_full((), float("inf")))
    df = torch.where(
        pos,
        denom ** 2 / (torch.where(n_l > 1, vl ** 2 / (n_l - 1), 0.0) +
                      torch.where(n_r > 1, vr ** 2 / (n_r - 1), 0.0) +
                      1e-300),
        one)
    x = df / (df + t2)
    p = betainc(df / 2.0, 0.5, x.clamp(0.0, 1.0))
    # Zero pooled variance: scipy gives p = 0 for differing means
    # (t = inf), NaN for identical ones (0/0).
    p = torch.where(pos, p, torch.where(mean_l == mean_r, nan,
                                        mean_l.new_zeros(())))
    # Windows with < 2 samples: variance undefined, NaN p (no step).
    return torch.where((n_l >= 2) & (n_r >= 2), p, nan)


def sliding_t_masks(traces, window_radius=6, p_threshold=0.001):
    """Boolean (N, T) mask of step positions: p < p_threshold at every
    radius in range(5, window_radius), with the reference's Python-slice
    window semantics (stepfitting_library.py:929-1037):

    - the left window seq[f-radius:f] is empty for f < radius (NaN p);
    - the right window seq[f:f+radius] truncates at the trace end.

    Computed in the dtype of ``traces``.
    """
    seq = traces
    N, T = seq.shape
    dev, dt = seq.device, seq.dtype
    f = torch.arange(T, device=dev)
    # Each trace is centered before the cumulative sums: Welch's t is
    # shift-invariant, but the (sum_sq - sum^2/n) variance form is not
    # numerically. At real photometry magnitudes (DC ~6e4, steps ~1e3) a
    # float32 cumulative sum of squares cancels catastrophically and
    # flips borderline step bits against the float64 host chain.
    # Centered, the squares are O(step^2).
    seq = seq - seq.mean(dim=1, keepdim=True)
    c = _prefix(seq)
    c2 = _prefix(seq ** 2)
    # An empty radius range (window_radius <= 5) means no step positions,
    # like the host chain's empty step_intersection, not all of them.
    mask = torch.full((N, T), window_radius > 5, dtype=torch.bool, device=dev)
    nan = seq.new_full((), float("nan"))
    for radius in range(5, window_radius):
        n_l = torch.where(f >= radius, radius, 0).to(dt)
        lo = (f - radius).clamp(min=0)
        c_lo, c2_lo = c.index_select(1, lo), c2.index_select(1, lo)
        sum_l = c[:, :T] - c_lo
        sq_l = c2[:, :T] - c2_lo
        n_r = (T - f).clamp(max=radius).to(dt)
        hi = (f + radius).clamp(max=T)
        sum_r = c.index_select(1, hi) - c[:, :T]
        sq_r = c2.index_select(1, hi) - c2[:, :T]
        safe_nl = n_l.clamp(min=1.0)
        safe_nr = n_r.clamp(min=1.0)
        mean_l = sum_l / safe_nl
        mean_r = sum_r / safe_nr
        var_l = (sq_l - sum_l ** 2 / safe_nl).clamp(min=0.0) / \
            (n_l - 1.0).clamp(min=1.0)
        var_r = (sq_r - sum_r ** 2 / safe_nr).clamp(min=0.0) / \
            (n_r - 1.0).clamp(min=1.0)
        p = _welch_p(mean_l, var_l, safe_nl, mean_r, var_r, safe_nr)
        p = torch.where((n_l >= 2) & (n_r >= 2), p, nan)
        mask = mask & (p < p_threshold)      # NaN < threshold is False
    return mask


def _ck_and_masks(traces, window_lengths=(2, 4, 8, 16), window_radius=6,
                  p_threshold=0.001):
    """CK filter, then the sliding-t detector on its output, which stays
    on the device between the two."""
    ck = chung_kennedy_batch(traces, window_lengths=window_lengths)
    return ck, sliding_t_masks(ck, window_radius=window_radius,
                               p_threshold=p_threshold)


def _plateaus_from_mask(seq, mask):
    """Host plateau assembly from a step mask: last of each consecutive
    group of step positions (stepfitting_library.py:1033-1037)."""
    positions = np.flatnonzero(mask)
    groups = stepfitting._consecutive_integers(positions.tolist())
    step_positions = [g[-1] for g in groups]
    seq = list(seq)
    if step_positions:
        plateaus = [stepfitting._fit_plateau(seq, 0, step_positions[0] - 1)]
        for f1, f2 in zip(step_positions, step_positions[1:]):
            plateaus.append(stepfitting._fit_plateau(seq, f1, f2 - 1))
        plateaus.append(
            stepfitting._fit_plateau(seq, step_positions[-1], len(seq) - 1))
    else:
        plateaus = [stepfitting._fit_plateau(seq, 0, len(seq) - 1)]
    return plateaus


def _postpass_python(mirrored, ck, masks, p_threshold, mirror_start):
    """The per-trace post-pass in Python over the host chain's functions:
    (un_plateaus, un_t) lists per trace. The oracle the native core
    (native/stepchain.py) is tested against; not on any main path."""
    out = []
    for i in range(mirrored.shape[0]):
        plateaus = _plateaus_from_mask(ck[i], masks[i])
        plateaus = stepfitting.refit_plateaus(list(mirrored[i]), plateaus)
        t_filtered = stepfitting.t_test_filter(
            luminosities=list(mirrored[i]), plateaus=plateaus,
            p_threshold=p_threshold, drop_sort=True,
            no_merge_start=mirror_start)
        out.append((
            stepfitting.unmirror_plateaus(plateaus, mirror_size=mirror_start),
            stepfitting.unmirror_plateaus(t_filtered,
                                          mirror_size=mirror_start)))
    return out


def _unmirror(n, s, e, h, mirror_start):
    """stepfitting.unmirror_plateaus over every row at once: shift by
    -mirror_start, drop plateaus entirely inside the mirror, clamp the
    boundary start to 0. Takes and returns (n, start, stop, height) arrays
    whose row i holds its plateaus in its first n[i] entries."""
    w = max(int(n.max()), 1) if n.size else 1
    s, e, h = s[:, :w], e[:, :w], h[:, :w]
    keep = (np.arange(w)[None, :] < n[:, None]) & ((e - mirror_start) >= 0)
    # Each row's kept plateaus first, in their order.
    order = np.argsort(~keep, axis=1, kind="stable")
    s, e, h = (np.take_along_axis(a, order, axis=1) for a in (s, e, h))
    return (keep.sum(axis=1).astype(np.int32),
            np.maximum(s - mirror_start, 0), e - mirror_start, h)


def _plateau_lists(n, s, e, h):
    """Per-row [(start, stop, height), ...] of (n, start, stop, height)
    arrays, built as one flat zip over all plateaus and cut into rows by
    cumulative counts."""
    keep = np.arange(s.shape[1])[None, :] < n[:, None]
    flat = list(zip(s[keep].tolist(), e[keep].tolist(), h[keep].tolist()))
    bounds = np.zeros(len(n) + 1, np.int64)
    np.cumsum(n, out=bounds[1:])
    return [flat[bounds[i]:bounds[i + 1]] for i in range(len(n))]


class StepfitArrays(NamedTuple):
    """:func:`stepfit_arrays`' result for N traces of T frames: the
    photometries and the CK traces past the mirror, (N, T) float64, and
    the refit and t-filtered plateaus unmirrored, each as (n, start, stop,
    height) with row i's plateaus in ``start[i, :n[i]]`` etc."""
    phot: np.ndarray
    ck: np.ndarray
    refit: tuple
    t_filtered: tuple


def stepfit_arrays(photometries, mirror_start=0, chung_kennedy=0,
                   p_threshold=0.01, window_radius=6, chunk=None,
                   device="cuda", n_threads=None):
    """Batched Trace.stepfit_photometries chain (flexlibrary.py:1380-1469)
    over an (N, T) array of trace photometries, as arrays: a
    :class:`StepfitArrays` of the host chain's results, mirror ->
    CK(2,4,8,16) -> sliding-t(radius<6) -> refit on raw -> drop_sort
    t-test merge -> unmirror. :func:`stepfit_batched` gives them as the
    host chain's lists.

    The mirrored traces upload as float64 in chunks of ``chunk`` rows
    (None = ``STEPFIT_CHUNK``; from pinned memory on a CUDA device), the CK
    filter and the detector run on ``device`` in float64, and the CK traces
    and masks copy back without waiting; every chunk is enqueued before
    any result is read. Results do not depend on the chunk. A device list
    or a ``_device.Mesh`` in ``device`` splits the rows of every
    chunk over its data devices (the JAX package's ``mesh=``): all window
    math is within a row, so the result is the one-device result.
    ``n_threads``: threads of the native post-pass (None = min(cpu_count,
    16)).

    With ``utils.profiling`` stages are recorded under "stepfit/upload",
    "stepfit/ck+masks" (host clock of the enqueueing), "stepfit/fetch"
    (the wait for the device and the copies), "stepfit/postpass" and
    "stepfit/unmirror"; :func:`stepfit_batched` adds "stepfit/assemble".
    While tracing is on, each dispatch's enqueueing
    is also the span "api/stepfit/ck_masks" (device time on a CUDA
    device) and the native pass the host span "api/stepfit/postpass".
    """
    from ..native import stepchain

    if chunk is None:
        chunk = STEPFIT_CHUNK
    phot = np.asarray(photometries, dtype=np.float64)
    N, _ = phot.shape
    if N == 0:
        empty = (np.zeros(0, np.int32), np.zeros((0, 1), np.int32),
                 np.zeros((0, 1), np.int32), np.zeros((0, 1)))
        return StepfitArrays(phot, phot, empty, empty)
    mirrored = np.ascontiguousarray(np.concatenate(
        [phot[:, :mirror_start][:, ::-1], phot], axis=1))
    host = torch.from_numpy(mirrored)

    # (lo, hi, device) of every dispatch: each chunk's rows in contiguous
    # shares over the data devices, in row order.
    pieces = [(lo + a, lo + b, d)
              for lo in range(0, N, chunk)
              for a, b, d in shares(min(chunk, N - lo), device)]
    pending = []
    for lo, hi, dev in pieces:
        with profiling.stage("stepfit/upload"):
            # Each piece from pinned memory on the current stream, not
            # through ``_transfer.Uploader``: its side stream and events
            # cost ~60-110 us more a piece on an H100's host (PERF.md,
            # section 6).
            piece = host[lo:hi]
            if dev.type == "cuda":
                piece = piece.pin_memory().to(dev, non_blocking=True)
            profiling.bump("ledger/uploads")
            profiling.bump("ledger/upload_bytes",
                           piece.numel() * piece.element_size())
        with profiling.stage("stepfit/ck+masks"), torch.no_grad(), \
                profiling.span("api/stepfit/ck_masks", device=dev):
            profiling.bump("ledger/step_dispatches")
            if chung_kennedy > 0:
                # The reference re-filters the mirrored input each round
                # (flexlibrary.py:1432-1436), so repetition does not
                # compound: one pass is every pass.
                out = _ck_and_masks(piece, window_lengths=(2, 4, 8, 16),
                                    window_radius=window_radius,
                                    p_threshold=p_threshold)
            else:
                out = (sliding_t_masks(piece, window_radius=window_radius,
                                       p_threshold=p_threshold),)
            pending.append(fetch(list(out)))
    with profiling.stage("stepfit/fetch"):
        cols = [wait(p) for p in pending]
        count_fetched([a for c in cols for a in c])
        masks = np.concatenate([c[-1] for c in cols])
        ck = (np.concatenate([c[0] for c in cols]) if chung_kennedy > 0
              else mirrored)

    with profiling.stage("stepfit/postpass"), \
            profiling.span("api/stepfit/postpass"):
        (rf_n, rf_s, rf_e, rf_h, tf_n, tf_s, tf_e, tf_h) = \
            stepchain.stepfit_postpass(mirrored, masks, p_threshold,
                                       mirror_start, n_threads=n_threads)
    with profiling.stage("stepfit/unmirror"):
        return StepfitArrays(
            phot, ck[:, mirror_start:],
            _unmirror(rf_n, rf_s, rf_e, rf_h, mirror_start),
            _unmirror(tf_n, tf_s, tf_e, tf_h, mirror_start))


def stepfit_lists(arrays):
    """A :class:`StepfitArrays` as the host chain's per-trace results: N
    tuples ``(photometries, un_ck, un_plateaus, un_t)``."""
    with profiling.stage("stepfit/assemble"):
        # Bulk conversion: per-element numpy scalar access in a 4096-trace
        # loop costs more than the native pass itself.
        phot_rows = arrays.phot.tolist()
        rf_lists = _plateau_lists(*arrays.refit)
        tf_lists = _plateau_lists(*arrays.t_filtered)
        # list(ck[i]) is unmirror_photometries(list(ck[i])): a list of
        # numpy scalars, the type the host chain produces.
        return [(tuple(phot_rows[i]), list(arrays.ck[i]), rf_lists[i],
                 tf_lists[i]) for i in range(len(phot_rows))]


def stepfit_batched(photometries, mirror_start=0, chung_kennedy=0,
                    p_threshold=0.01, window_radius=6, chunk=None,
                    device="cuda", n_threads=None):
    """:func:`stepfit_arrays` as a list of N tuples ``(photometries,
    un_ck, un_plateaus, un_t)`` matching the host chain (the arguments are
    :func:`stepfit_arrays`')."""
    return stepfit_lists(stepfit_arrays(
        photometries, mirror_start=mirror_start, chung_kennedy=chung_kennedy,
        p_threshold=p_threshold, window_radius=window_radius, chunk=chunk,
        device=device, n_threads=n_threads))
