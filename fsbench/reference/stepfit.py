"""The movie's step-fit chain: mirror -> Chung-Kennedy -> sliding-t ->
refit -> drop-sort Welch-t merge -> unmirror, over an (N, T) stack of
photometry traces.

Frozen copies of the port's plain functions (Trace.stepfit_photometries,
flexlibrary.py:1380-1469): the device stage of ``ops/stepfit_batch.py``
(``chung_kennedy_batch``, ``sliding_t_masks``, ``_welch_p``) with
``ops/special.py::betainc``, in float64 torch as the port runs it; and the
host chain of ``stepfitting.py`` (plateau assembly from the step mask, the
refit on the raw mirrored trace, ``t_test_filter`` with ``drop_sort``,
``unmirror_plateaus``) in Python and numpy, one trace at a time.

Departure: the port runs the host part in its native core
(``native/stepchain.py`` over ``csrc/stepchain.cpp``, threaded over the
traces); here it is the Python chain that core is specified by, with the
two-tailed Welch p-value from scipy's Student t (``stdtr``).

``lowp`` rounds the Chung-Kennedy traces as they leave the filter (the
control of ``correct``); the reference passes the identity.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .detect import identity

BETAINC_ROUNDS = 100


def betainc(a, b, x):
    """I_x(a, b) elementwise, in the tensors' dtype: the continued fraction
    (modified Lentz) with the reflection for x > (a + 1) / (a + b + 2),
    exactly ``BETAINC_ROUNDS`` rounds."""
    tensors = [t for t in (a, b, x) if isinstance(t, torch.Tensor)]
    like = tensors[0]
    dtype = like.dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    if not dtype.is_floating_point:
        dtype = torch.get_default_dtype()
    a, b, x = (torch.as_tensor(t, dtype=dtype, device=like.device)
               for t in (a, b, x))
    a, b, x = torch.broadcast_tensors(a, b, x)
    swap = x > (a + 1.0) / (a + b + 2.0)
    a, b, x = (torch.where(swap, b, a), torch.where(swap, a, b),
               torch.where(swap, 1.0 - x, x))
    tiny = torch.finfo(dtype).tiny

    def guard(v):
        return torch.where(v.abs() < tiny, torch.full_like(v, tiny), v)

    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / guard(1.0 - qab * x / qap)
    h = d
    for m in range(1, BETAINC_ROUNDS + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / guard(1.0 + aa * d)
        c = guard(1.0 + aa / c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / guard(1.0 + aa * d)
        c = guard(1.0 + aa / c)
        h = h * d * c
    log_front = (a * torch.log(x) + b * torch.log1p(-x) + torch.lgamma(qab)
                 - torch.lgamma(a) - torch.lgamma(b))
    out = torch.exp(log_front) * h / a
    return torch.where(swap, 1.0 - out, out)


def _prefix(x):
    """Exclusive prefix sums along dim 1: out[:, i] = sum(x[:, :i])."""
    out = x.new_zeros((x.shape[0], x.shape[1] + 1))
    torch.cumsum(x, dim=1, out=out[:, 1:])
    return out


def chung_kennedy_batch(traces, window_lengths=(2, 4, 8, 16), M=10, p=2):
    """Chung-Kennedy filter over an (N, T) tensor, with the reference's
    edge truncations (stepfitting_library.py:1081-1273)."""
    lum = traces
    N, T = lum.shape
    if T <= 2:
        raise ValueError("luminosities must have len(luminosities) > 2")
    dev, dt = lum.device, lum.dtype
    L = torch.arange(T, device=dev)
    c = _prefix(lum)
    one, zero = lum.new_ones(()), lum.new_zeros(())
    first, last = L == 0, L == T - 1
    num = torch.zeros_like(lum)
    tot = torch.zeros_like(lum)
    for w in window_lengths:
        lo = (L - w - 1).clamp(min=0)
        cnt_f = (L - lo).to(dt)
        fp = torch.where(cnt_f > 0,
                         (c[:, :T] - c.index_select(1, lo)) /
                         cnt_f.clamp(min=1), zero)
        hi = (L + w + 1).clamp(max=T)
        cnt_b = (hi - (L + 1)).to(dt)
        bp = torch.where(cnt_b > 0,
                         (c.index_select(1, hi) - c[:, 1:]) /
                         cnt_b.clamp(min=1), zero)
        sqf = (lum - fp) ** 2
        sqf[:, 0] = 0
        csqf = _prefix(sqf)
        sqb = (lum - bp) ** 2
        sqb[:, T - 1] = 0
        csqb = _prefix(sqb)
        lo2 = torch.where(L >= M, L - M + 1, torch.ones_like(L))
        b_diff = csqf[:, 1:] - csqf.index_select(1, torch.minimum(lo2, L + 1))
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
        fw = torch.where(first, zero, torch.where(last, one, fw))
        bw = torch.where(first, one, torch.where(last, zero, bw))
        num = num + fw * fp + bw * bp
        tot = tot + fw + bw
    return num / tot


def _welch_p(mean_l, var_l, n_l, mean_r, var_r, n_r):
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
    p = torch.where(pos, p, torch.where(mean_l == mean_r, nan,
                                        mean_l.new_zeros(())))
    return torch.where((n_l >= 2) & (n_r >= 2), p, nan)


def sliding_t_masks(traces, window_radius=6, p_threshold=0.001):
    """Boolean (N, T) mask of step positions: p < p_threshold at every
    radius in range(5, window_radius) (stepfitting_library.py:929-1037)."""
    seq = traces
    N, T = seq.shape
    dev, dt = seq.device, seq.dtype
    f = torch.arange(T, device=dev)
    seq = seq - seq.mean(dim=1, keepdim=True)
    c = _prefix(seq)
    c2 = _prefix(seq ** 2)
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
        mask = mask & (p < p_threshold)
    return mask


# ---------------------------------------------------------------------------
# The host chain (stepfitting.py), one trace at a time.
# ---------------------------------------------------------------------------

def _pairwise(iterable):
    a, b = itertools.tee(iterable)
    next(b, None)
    return zip(a, b)


def welch_t(left, right):
    """Two-tailed Welch t-test (t, p), scipy.stats.ttest_ind(equal_var=
    False)'s arithmetic; NaN p on an empty window."""
    if len(left) == 0 or len(right) == 0:
        return float("nan"), float("nan")
    from scipy.special import stdtr
    a = np.asarray(left, dtype=np.float64)
    b = np.asarray(right, dtype=np.float64)
    n1, n2 = a.size, b.size
    with np.errstate(divide="ignore", invalid="ignore"):
        v1 = np.mean((a - a.mean()) ** 2) * \
            np.divide(np.float64(n1), np.float64(n1 - 1))
        v2 = np.mean((b - b.mean()) ** 2) * \
            np.divide(np.float64(n2), np.float64(n2 - 1))
        vn1, vn2 = v1 / n1, v2 / n2
        df = (vn1 + vn2) ** 2 / (vn1 ** 2 / (n1 - 1) + vn2 ** 2 / (n2 - 1))
        if np.isnan(df):
            df = 1.0
        t = (a.mean() - b.mean()) / np.sqrt(vn1 + vn2)
        p = 2.0 * stdtr(df, -np.abs(t))
    return float(t), float(p)


def fit_plateau(luminosities, start, stop):
    if not 0 <= start <= stop < len(luminosities):
        raise ValueError("invalid plateau " + str((start, stop)))
    return (start, stop, float(np.mean(luminosities[start:stop + 1])))


def consecutive_groups(integers):
    out = []
    for _, g in itertools.groupby(enumerate(integers),
                                  lambda t: t[0] - t[1]):
        out.append([x for _, x in g])
    return out


def plateaus_from_mask(n_frames, mask, luminosities):
    """Plateaus between the last step of each consecutive group of mask
    hits, fitted on ``luminosities``."""
    steps = [g[-1] for g in consecutive_groups(
        np.flatnonzero(mask).tolist())]
    if not steps:
        return [fit_plateau(luminosities, 0, n_frames - 1)]
    plateaus = [fit_plateau(luminosities, 0, steps[0] - 1)]
    for f1, f2 in _pairwise(steps):
        plateaus.append(fit_plateau(luminosities, f1, f2 - 1))
    plateaus.append(fit_plateau(luminosities, steps[-1], n_frames - 1))
    return plateaus


def _t_merge_pass(lum, plateaus, p_threshold, no_merge_start):
    """One drop-sort merge pass (stepfitting_library.py:1328-1438): merges
    ranked by descending p (NaN last), neighbours of an accepted merge
    vetoed."""
    if len(plateaus) < 2:
        return plateaus
    pairs = []
    for r, (a, b) in enumerate(_pairwise(plateaus)):
        _, p = welch_t(lum[a[0]:a[1] + 1], lum[b[0]:b[1] + 1])
        pairs.append([a, b, p, r])
    ranked = sorted(pairs, key=lambda x: float("-inf") if math.isnan(x[2])
                    else x[2], reverse=True)
    merge = [p >= p_threshold and a[1] >= no_merge_start
             for a, b, p, r in ranked]
    for i, (a, b, p, r) in enumerate(ranked):
        if merge[i]:
            for j in range(i + 1, len(ranked)):
                a2, b2 = ranked[j][0], ranked[j][1]
                if a == b2 or b == a2:
                    merge[j] = False
    by_rank = {r: merge[i] for i, (a, b, p, r) in enumerate(ranked)}
    out = []
    for r, (a, b) in enumerate(_pairwise(plateaus)):
        if out and a[1] == out[-1][1]:
            continue
        if by_rank[r]:
            out.append(fit_plateau(lum, a[0], b[1]))
        else:
            out.append(a)
    if plateaus[-1][1] != out[-1][1]:
        out.append(plateaus[-1])
    return out


def t_test_filter(lum, plateaus, p_threshold, no_merge_start=0):
    out = plateaus
    for _ in range(len(plateaus) - 1):
        out = _t_merge_pass(lum, out, p_threshold, no_merge_start)
    return out


def unmirror_plateaus(plateaus, mirror_size):
    out = []
    for a, o, h in [(a - mirror_size, o - mirror_size, h)
                    for a, o, h in plateaus]:
        if a < 0 and o < 0:
            continue
        out.append((0, o, h) if a < 0 <= o else (a, o, h))
    return out


def stepfit_chain(photometries, mirror_start=0, chung_kennedy=1,
                  p_threshold=0.01, window_radius=6, device="cpu",
                  lowp=identity):
    """For each row of the (N, T) float64 ``photometries``: (photometries
    tuple, unmirrored CK list, plateaus, t-filtered plateaus)."""
    phot = np.asarray(photometries, np.float64)
    N, T = phot.shape
    if N == 0:
        return []
    mirrored = np.concatenate([phot[:, :mirror_start][:, ::-1], phot],
                              axis=1)
    x = torch.from_numpy(np.ascontiguousarray(mirrored)).to(device)
    with torch.no_grad():
        if chung_kennedy > 0:
            ck_d = lowp(chung_kennedy_batch(x))
        else:
            ck_d = x
        masks = sliding_t_masks(ck_d, window_radius=window_radius,
                                p_threshold=p_threshold).cpu().numpy()
        ck = ck_d.cpu().numpy() if chung_kennedy > 0 else mirrored
    out = []
    Tm = mirrored.shape[1]
    for i in range(N):
        raw = list(mirrored[i])
        plateaus = plateaus_from_mask(Tm, masks[i], list(ck[i]))
        plateaus = [fit_plateau(raw, a, o) for a, o, _ in plateaus]
        t_filtered = t_test_filter(raw, plateaus, p_threshold,
                                   no_merge_start=mirror_start)
        out.append((tuple(phot[i].tolist()), list(ck[i, mirror_start:]),
                    unmirror_plateaus(plateaus, mirror_start),
                    unmirror_plateaus(t_filtered, mirror_start)))
    return out
