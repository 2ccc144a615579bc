"""Device-batched Kerssemakers chi-squared step fitting.

Counterpart of fluorosequencingimageanalysis_tpu/ops/chisq_batch_device.py,
in torch float64. The reference's ``chi_squared_step_fitter``
(stepfitting_library.py:342-505) is a sequential best-fit/counter-fit chain
per trace; the native C++ core (csrc/chisqfit.cpp) runs it trace by trace
and is the oracle. This engine uses the fact that the split evaluations at
every candidate position are range statistics: one [N, T] pass per growth
step evaluates every trace's every split at once (cumulative sums and
cummax/cummin segment bounds), with no read of the device inside the
chain. Plateau heights are computed on the host with the reference's exact
``np.mean`` from the fetched winning starts.

Numerics: range residuals use fp-rounded means in float64 — equal to the
host chain in exact arithmetic, not in operation order, so the two can
differ only on near-tied split decisions. The JAX program's ``vmap`` is a
batch dimension here, its ``lax.scan``s are Python loops over at most
``num_steps + 1`` plateaus, ``lax.cummax``/reverse ``cummin`` are
``torch.cummax``/``cummin`` (the latter on flipped tensors) and
``segment_max`` is ``scatter_reduce(..., "amax")``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device


def _segment_bounds(starts):
    """Per-position segment bounds from starts masks. starts: [N, T] bool
    with starts[:, 0] True. Returns (a, b) [N, T] int64: inclusive
    start/stop index of the segment containing each position."""
    N, T = starts.shape
    idx = torch.arange(T, device=starts.device).expand(N, T)
    a = torch.cummax(torch.where(starts, idx, -1), dim=1).values
    ends = torch.cat([starts[:, 1:],
                      torch.ones((N, 1), dtype=torch.bool,
                                 device=starts.device)], dim=1)
    b = torch.cummin(torch.where(ends, idx, T).flip(1), dim=1).values.flip(1)
    return a, b


def _split_step(x, cs1, cs2, starts, msl, msm, big, extra_forbidden=None):
    """One best-split growth step for every trace.

    Evaluates every split position u (a split separates u from u+1 inside
    u's current plateau), applies the reference's validity rules
    (stepfitting_library.py:113-271):

    - min_step_length: u - a < msl or b - u < msl is forbidden;
    - min_step_magnitude: |mean_left - mean_right| < msm is forbidden;
    - total residual must beat ``big`` = T * span^2 STRICTLY
      (_best_split's initial best_residuals; _split_plateau's 2*big
      initialization is subsumed);
    - ``extra_forbidden`` [N, T] masks counterfit-constrained positions.

    Winner = lexicographic min of (total, plateau_start, -u): within one
    plateau the reference's ``<=`` keeps the LAST tied split; across
    plateaus its strict ``<`` keeps the FIRST tied plateau.

    Returns (new_starts [N, T], grew [N]).
    """
    N, T = x.shape
    u = torch.arange(T, device=x.device).expand(N, T)
    a, b = _segment_bounds(starts)

    cnt_l = (u - a + 1).to(x.dtype)
    sum_l = cs1[:, 1:] - cs1.gather(1, a)
    ssq_l = cs2[:, 1:] - cs2.gather(1, a)
    cnt_r = (b - u).to(x.dtype)
    sum_r = cs1.gather(1, b + 1) - cs1[:, 1:]
    ssq_r = cs2.gather(1, b + 1) - cs2[:, 1:]

    # In-plateau split positions only: u+1 must be in the same segment.
    can_split = (u < T - 1) & (b > u)
    cnt_r_safe = torch.clamp(cnt_r, min=1.0)
    mean_l = sum_l / cnt_l
    mean_r = sum_r / cnt_r_safe
    # Residual with the fp-rounded mean substituted back (the host
    # computes sum((x - mean)**2) AFTER rounding mean; expanding that
    # square keeps the same rounded mean in every term). Clamped at 0:
    # the host's direct sum of squares is nonnegative by construction,
    # while the expanded form can cancel to a tiny NEGATIVE on constant
    # segments — which would beat a big = T*span^2 = 0 gate on a flat
    # trace and split where the host never does.
    res_l = torch.clamp(
        ssq_l - 2.0 * mean_l * sum_l + cnt_l * mean_l * mean_l, min=0.0)
    res_r = torch.clamp(
        ssq_r - 2.0 * mean_r * sum_r + cnt_r * mean_r * mean_r, min=0.0)
    tot = res_l + res_r

    # min_step_length rule (stepfitting_library.py:216-221): a split at u
    # is forbidden when u - start < msl or stop - u < msl.
    valid = can_split & (u - a >= msl) & (b - u >= msl)
    valid &= (mean_l - mean_r).abs() >= msm
    valid &= tot < big[:, None]
    if extra_forbidden is not None:
        valid &= ~extra_forbidden

    # Lexicographic (tot, a, -u) argmin over valid positions.
    tot_m = torch.where(valid, tot, torch.full_like(tot, float("inf")))
    best_tot = tot_m.amin(dim=1, keepdim=True)
    tie = valid & (tot_m == best_tot)
    best_a = torch.where(tie, a, T).amin(dim=1, keepdim=True)
    tie &= a == best_a
    best_u = torch.where(tie, u, -1).amax(dim=1, keepdim=True)
    grew = torch.isfinite(best_tot[:, 0])
    new_starts = torch.where(grew[:, None], starts | (u == best_u + 1),
                             starts)
    return new_starts, grew


def _fit_residual(x, cs1, starts):
    """Total squared residual of each trace's fit (sum over plateaus of
    sum((x - mean)^2)), with fp-rounded per-plateau means. [N]"""
    a, b = _segment_bounds(starts)
    cnt = (b - a + 1).to(x.dtype)
    s = cs1.gather(1, b + 1) - cs1.gather(1, a)
    mean = s / cnt
    return ((x - mean) ** 2).sum(dim=1)


def _counterfit_forbidden(bf_starts, cf_starts):
    """The counterfit constraint mask (stepfitting_library.py:182-211
    with bestfit_plateaus given): splits AT best-fit boundaries are
    forbidden, and every position inside a best-fit plateau that already
    contains a counterfit start is forbidden. [N, T] bool."""
    N, T = bf_starts.shape
    # (stop_i, start_{i+1}) pairs: u+1 is a best-fit start.
    boundary = torch.cat([bf_starts[:, 1:],
                          torch.zeros((N, 1), dtype=torch.bool,
                                      device=bf_starts.device)], dim=1)
    segid = torch.cumsum(bf_starts.to(torch.int64), dim=1) - 1
    seg_has_cf = torch.zeros((N, T), dtype=torch.int64,
                             device=bf_starts.device).scatter_reduce(
        1, segid, cf_starts.to(torch.int64), "amax")
    # Rule 2 forbids u in range(start, stop) of the claimed plateau —
    # every in-plateau split position; u == stop itself is never an
    # in-plateau split (can_split already excludes it), so masking the
    # whole segment is exact.
    inside_claimed = seg_has_cf.gather(1, segid) > 0
    return boundary | inside_claimed


def _chisq_device_program(traces, num_plateaus, min_step_length,
                          min_step_magnitude, ignore_counterfits):
    """The whole best-fit/counter-fit chain for an [N, T] batch. Returns
    (pick [N] int64, all_starts [N, P, T] bool, valid [N, P] bool): the
    winning entry per trace and every entry's starts mask (pick indexes
    into the P axis). Entry p's counterfit takes p growth steps (the JAX
    scan runs P and masks those beyond p)."""
    x = traces
    N, T = x.shape
    P = num_plateaus
    msl = min_step_length
    msm = float(min_step_magnitude)

    zeros = torch.zeros((N, 1), dtype=x.dtype, device=x.device)
    cs1 = torch.cat([zeros, torch.cumsum(x, dim=1)], dim=1)
    cs2 = torch.cat([zeros, torch.cumsum(x * x, dim=1)], dim=1)
    span = x.amax(dim=1) - x.amin(dim=1)
    big = T * span * span

    cf0 = torch.zeros((N, T), dtype=torch.bool, device=x.device)
    cf0[:, 0] = True
    best, alive = cf0, torch.ones(N, dtype=torch.bool, device=x.device)
    S_all, starts_all, valid = [], [], []
    for p in range(1, P + 1):
        if p > 1:
            # The 1-plateau fit always exists; the host breaks the p loop
            # when the best fit stops growing (chi_squared_step_fitter:
            # 223-224): entries after the first stall never exist.
            new_best, grew = _split_step(x, cs1, cs2, best, msl, msm, big)
            alive = alive & grew
            best = torch.where(alive[:, None], new_best, best)
        bf_res = _fit_residual(x, cs1, best)
        cf = cf0
        for _ in range(p):
            extra = _counterfit_forbidden(best, cf)
            cf, _ = _split_step(x, cs1, cs2, cf, 0, msm, big, extra)
        cf_res = _fit_residual(x, cs1, cf)
        nonzero = bf_res != 0
        S_all.append(torch.where(
            nonzero, cf_res / torch.where(nonzero, bf_res,
                                          torch.ones_like(bf_res)),
            torch.full_like(bf_res, 1e10)))
        starts_all.append(best)
        valid.append(alive)
    S_all = torch.stack(S_all, dim=1)            # [N, P]
    starts_all = torch.stack(starts_all, dim=1)  # [N, P, T]
    valid = torch.stack(valid, dim=1)            # [N, P]
    if ignore_counterfits:
        # Largest plateau count = last valid entry (stable reverse sort
        # by len == last index where valid).
        idx = torch.arange(P, device=x.device).expand(N, P)
        pick = torch.where(valid, idx, -1).amax(dim=1)
    else:
        # sorted(..., key=S, reverse=True) is stable: first max wins.
        S_masked = torch.where(valid, S_all,
                               torch.full_like(S_all, float("-inf")))
        pick = S_masked.argmax(dim=1)
    return pick, starts_all, valid


def chi_squared_fit_device(traces, num_steps=None, num_steps_multiplier=1,
                           min_step_length=2, min_step_magnitude=0.0,
                           ignore_counterfits=False, device="cuda"):
    """Device-batched chi-squared step fits for an (N, T) trace stack, on
    ``device`` ("cuda" unless the caller passes "cpu"), in float64.

    Same surface as ``stepfitting.chi_squared_fit_batch`` minus the
    ``num_steps = T - 1`` ValueError edge (that routes to the native
    engine). The winning starts are fetched once; heights are computed ON
    HOST with the reference's exact ``np.mean`` over each winning
    plateau's raw photometries, so any device/host divergence is confined
    to near-tied split POSITIONS, never to heights given the same
    positions.
    """
    traces = np.ascontiguousarray(traces, dtype=np.float64)
    N, T = traces.shape
    if N == 0:
        return []
    if not 0 < num_steps_multiplier <= 1:
        raise ValueError("num_steps_multiplier has an invalid value of " +
                         str(num_steps_multiplier))
    if num_steps is None:
        num_steps = min(int(np.ceil(num_steps_multiplier * T)), T - 2)
    if not 0 < num_steps <= T - 2:
        raise ValueError(f"chi_squared_fit_device needs 0 < num_steps <= "
                         f"T - 2 (got {num_steps} for T={T})")
    dev = resolve_device(device)
    with torch.no_grad():
        pick, starts_all, _ = _chisq_device_program(
            torch.as_tensor(traces, device=dev), num_steps + 1,
            int(min_step_length), float(min_step_magnitude),
            bool(ignore_counterfits))
        starts = starts_all.gather(
            1, pick[:, None, None].expand(N, 1, T))[:, 0].cpu().numpy()
    out = []
    for i in range(N):
        idxs = np.flatnonzero(starts[i])
        stops = np.append(idxs[1:] - 1, T - 1)
        out.append([
            (int(s), int(e), float(np.mean(traces[i, s:e + 1])))
            for s, e in zip(idxs, stops)])
    return out
