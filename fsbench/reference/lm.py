"""Batched bounded Levenberg-Marquardt for 2D Gaussian PSF fits (plain).

A frozen copy of the port's ops/lm.py (the plain twin of kernel B's fit),
with mpfit's semantics as the JAX package keeps them:

- a fixed number of iterations for the whole batch (no early exit);
- each patch normalised by its max |value| (only H and A rescale);
- parameters pegged at a bound with the gradient pushing outward get their
  Jacobian column zeroed (mpfit.py:1072-1091);
- Marquardt damping with a floor relative to the largest diagonal entry, so
  degenerate directions (theta of a round spot) keep a bounded step;
- trial steps projected onto the box, accepted only if the cost drops, with
  ``lam_up`` / ``lam_down`` damping updates;
- optional second start at theta0 = 90 with swapped sigma inits.

The layout is lane-major like the JAX version: seven (N,) parameter
vectors, (25, N) pixel quantities. On CUDA tensors this is the reference
the fused kernel (ops/fused_fit.py) is held against; it runs in the dtype of
its input, so a float64 run checks the algorithm without float32 noise.
"""

from __future__ import annotations

import math

import torch

_BIG = 1e30  # stand-in for +inf in bounds (keeps arithmetic finite)
_DEG2RAD = math.pi / 180.0
_INTENSITY = (True, True, False, False, False, False, False)


def _median(x, dim=-1):
    """numpy/jnp median: the mean of the two middle values for an even
    count (``torch.median`` returns the lower one)."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    lo = s.narrow(dim, (n - 1) // 2, 1).squeeze(dim)
    hi = s.narrow(dim, n // 2, 1).squeeze(dim)
    return (lo + hi) * 0.5


def _row_sum(x):
    """Sum over axis 0 one row at a time, in index order.

    The fused kernel (csrc/fit_quality.cu) accumulates pixel by pixel in
    this order and without FMA contraction, so on the card the two agree
    bit for bit; a library reduction pairs the terms differently, and the
    accept test below turns last-bit differences into different fits."""
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc


def default_fit_init(patches):
    """(N, 7) initial parameters ``(median, max, S/2, S/2, 1, 1, 0)``
    (pflib.py:199-206)."""
    flat = patches.reshape(patches.shape[0], -1)
    med = _median(flat)
    amax = torch.amax(flat, dim=-1)
    ones = torch.ones_like(med)
    c = (patches.shape[-1] / 2.0) * ones
    return torch.stack([med, amax, c, c, ones, ones, torch.zeros_like(med)],
                       dim=-1)


def default_fit_bounds(patches):
    """(lo, hi), each (N, 7), pflib's parinfo bounds; the amplitude floor
    is ``(max - mean) / 3`` (pflib.py:204-212)."""
    flat = patches.reshape(patches.shape[0], -1)
    amax = torch.amax(flat, dim=-1)
    # Divisors as device tensors: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal (one more rounding than the
    # kernel's and the JAX package's true division).
    amean = _row_sum(flat.T) / flat.new_tensor(flat.shape[-1])
    zeros = torch.zeros_like(amax)
    ones = torch.ones_like(amax)
    lo = torch.stack([zeros, (amax - amean) / flat.new_tensor(3.0),
                      2.0 * ones, 2.0 * ones, 0.75 * ones, 0.75 * ones,
                      zeros], dim=-1)
    big = torch.full_like(amax, _BIG)
    hi = torch.stack([big, big, 3.0 * ones, 3.0 * ones, 2.0 * ones,
                      2.0 * ones, 360.0 * ones], dim=-1)
    return lo, hi


def _model_and_jac(p, hg, wg, want_jac=True):
    """Model (25, N) and, if asked, the closed-form Jacobian as a list of
    seven (25, N) tensors. p: seven (N,) vectors; hg, wg: (25, 1)."""
    H, A, c2, c3, sh, sw, th = p
    rota = th * _DEG2RAD
    cos_r = torch.cos(rota)
    sin_r = torch.sin(rota)
    dh = c3[None, :] - hg
    dw = c2[None, :] - wg
    du = dh * cos_r[None, :] - dw * sin_r[None, :]
    dv = dh * sin_r[None, :] + dw * cos_r[None, :]
    u = du / sh[None, :]
    v = dv / sw[None, :]
    E = torch.exp(-(u * u + v * v) * 0.5)
    AE = A[None, :] * E
    model = H[None, :] + AE
    if not want_jac:
        return model, None
    us = u / sh[None, :]
    vs = v / sw[None, :]
    jH = torch.ones_like(E)
    jA = E
    jc2 = AE * (u * sin_r[None, :] / sh[None, :] -
                v * cos_r[None, :] / sw[None, :])
    jc3 = -AE * (u * cos_r[None, :] / sh[None, :] +
                 v * sin_r[None, :] / sw[None, :])
    jsh = AE * u * us
    jsw = AE * v * vs
    jth = _DEG2RAD * AE * u * v * (sw / sh - sh / sw)[None, :]
    return model, [jH, jA, jc2, jc3, jsh, jsw, jth]


def _cholesky_solve_7(Amat, g):
    """Solve A x = g for a 7x7 SPD system, unrolled over (N,) entries
    (only ``Amat[i][j]`` with j <= i is read; pivots clamp at 1e-30)."""
    n = 7
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        s = Amat[i][i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = torch.sqrt(torch.clamp_min(s, 1e-30))
        inv_d = 1.0 / L[i][i]
        for j in range(i + 1, n):
            s = Amat[j][i]
            for k in range(i):
                s = s - L[j][k] * L[i][k]
            L[j][i] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def fit_gaussians_batched(patches, p0=None, lo=None, hi=None, num_iters=60,
                          lam0=1e-3, lam_up=4.0, lam_down=0.25,
                          theta_starts=1):
    """Fit the reference 2D Gaussian to (N, S, S) patches.

    Returns ``params`` (N, 7) ``(H, A, h_0, w_0, sigma_h, sigma_w, theta)``
    in patch coordinates and raw units, and ``cost`` (N,), the final sum of
    squared residuals in raw units squared. Integer patches are fitted in
    float32.
    """
    if not torch.is_floating_point(patches):
        patches = patches.to(torch.float32)
    dt = patches.dtype
    n, S = patches.shape[0], patches.shape[-1]
    npix = S * S
    if p0 is None:
        p0 = default_fit_init(patches)
    if lo is None or hi is None:
        dlo, dhi = default_fit_bounds(patches)
        lo = dlo if lo is None else lo
        hi = dhi if hi is None else hi
    # mpfit refuses out-of-range starts; gaussfit clips them in.
    p0 = _clip(p0, lo, hi)

    scale = torch.clamp_min(
        torch.amax(torch.abs(patches.reshape(n, -1)), dim=-1), 1e-12)

    def norm(cols, i):
        return cols[:, i] / scale if _INTENSITY[i] else cols[:, i]

    data = patches.reshape(n, npix).T / scale[None, :]
    p = [norm(p0, i) for i in range(7)]
    lo_l = [norm(lo, i) for i in range(7)]
    hi_l = [norm(hi, i) for i in range(7)]

    idx = torch.arange(npix, device=patches.device)
    hg = (idx // S).to(dt)[:, None]
    wg = (idx % S).to(dt)[:, None]

    def cost_of(plist):
        m, _ = _model_and_jac(plist, hg, wg, want_jac=False)
        r = m - data
        return _row_sum(r * r)

    def step(p, lam, cost):
        m, J = _model_and_jac(p, hg, wg, want_jac=True)
        r = m - data
        g = [_row_sum(J[i] * r) for i in range(7)]
        free = []
        for i in range(7):
            eps_lo = torch.clamp_min(torch.abs(lo_l[i]), 1.0) * 1e-7
            eps_hi = torch.clamp_min(torch.abs(hi_l[i]), 1.0) * 1e-7
            pegged = (((p[i] <= lo_l[i] + eps_lo) & (g[i] > 0)) |
                      ((p[i] >= hi_l[i] - eps_hi) & (g[i] < 0)))
            free.append(~pegged)
        Jf = [torch.where(free[i][None, :], J[i], 0.0) for i in range(7)]
        gf = [torch.where(free[i], g[i], 0.0) for i in range(7)]
        A = [[None] * 7 for _ in range(7)]
        for i in range(7):
            for j in range(i + 1):
                A[i][j] = _row_sum(Jf[i] * Jf[j])
        diag = [A[i][i] for i in range(7)]
        diag_max = diag[0]
        for i in range(1, 7):
            diag_max = torch.maximum(diag_max, diag[i])
        floor = torch.clamp_min(1e-8 * diag_max, 1e-12)
        for i in range(7):
            A[i][i] = diag[i] + lam * torch.maximum(diag[i], floor) + floor
        delta = _cholesky_solve_7(A, gf)
        p_new = [_clip(p[i] - delta[i], lo_l[i], hi_l[i]) for i in range(7)]
        new_cost = cost_of(p_new)
        accept = new_cost < cost
        p = [torch.where(accept, p_new[i], p[i]) for i in range(7)]
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp_min(lam * lam_down, 1e-12),
                          torch.clamp_max(lam * lam_up, 1e12))
        return p, lam, cost

    def run(p):
        lam = torch.full((n,), lam0, dtype=dt, device=patches.device)
        cost = cost_of(p)
        for _ in range(num_iters):
            p, lam, cost = step(p, lam, cost)
        return p, cost

    p_start = p
    p, cost = run(p_start)

    if theta_starts > 1:
        # Restart from p0 at theta0 = 90 with swapped sigma inits: the model
        # satisfies (sh, sw, theta) == (sw, sh, theta + 90), so this covers
        # optima across the 0/360 wraparound. Lowest cost wins per patch.
        p90 = list(p_start)
        p90[4], p90[5] = p90[5], p90[4]
        p90[4] = _clip(p90[4], lo_l[4], hi_l[4])
        p90[5] = _clip(p90[5], lo_l[5], hi_l[5])
        p90[6] = _clip(torch.full_like(p90[6], 90.0), lo_l[6], hi_l[6])
        q, cost90 = run(p90)
        better = cost90 < cost
        p = [torch.where(better, q[i], p[i]) for i in range(7)]
        cost = torch.where(better, cost90, cost)

    params = torch.stack([p[i] * scale if _INTENSITY[i] else p[i]
                          for i in range(7)], dim=-1)
    return params, cost * scale ** 2
