"""The Monte-Carlo random-search PSF fitter's pieces, and kernel D's twin.

Counterpart of the pieces of fluorosequencingimageanalysis_tpu/models/
detect.py's Monte-Carlo path (detect.py:694-779; the reference's
pflib.py:117-177, ``fit_type='monte_carlo'``): each candidate's 5x5 patch is
min-max normalised, n_iter parameter 6-vectors (H, A, h0, w0, sh, sw) are
sampled around the patch's brightest pixel, and the sample whose circular
model (normalised by its maximum) lies nearest the patch in L2 wins.

``mc_fit_plain`` is the scan of kernel D (csrc/mc_fit.cu) in torch
operations: one round of (K, 5, 5) operations per sample, every product and
sum on its own and the pixel sum in pixel order, so that on a card it equals
the kernel bit for bit. ``ops/fused_mc_fit.py`` chooses between the two.
"""

from __future__ import annotations

import torch

SIDE = 5


def mc_model(params, h_grid, w_grid):
    """The circular Gaussian the fitter samples (pflib.py:93-115): the
    reference's model ignores sigma_w and theta. params: (..., >= 5)."""
    H = params[..., 0, None, None]
    A = params[..., 1, None, None]
    h0 = params[..., 2, None, None]
    w0 = params[..., 3, None, None]
    sh = params[..., 4, None, None]
    a = (h_grid - h0) ** 2
    b = (w_grid - w0) ** 2
    return A * torch.exp(-(a + b) / (2.0 * sh ** 2)) + H


def grids(dtype, device):
    """The 5x5 (h, w) pixel grids, h-major."""
    r = torch.arange(SIDE, dtype=dtype, device=device)
    return torch.meshgrid(r, r, indexing="ij")


def normalise_patches(raw):
    """(K, 5, 5) patches shifted by their minimum and divided by their
    maximum after the shift (at least 1e-12; pflib.py:446-447)."""
    K = raw.shape[0]
    pmin = raw.reshape(K, -1).amin(dim=-1)[:, None, None]
    shifted = raw - pmin
    pmax = shifted.reshape(K, -1).amax(dim=-1).clamp_min(1e-12)
    return shifted / pmax[:, None, None]


def sample_params(patches, z):
    """(6, n_iter, K) sampled (H, A, h0, w0, sh, sw) from (6, n_iter, K)
    standard normals ``z`` (pflib.py:125-157): the centers scatter around
    the argmax pixel of each normalised patch."""
    K = patches.shape[0]
    argmax = patches.reshape(K, -1).argmax(dim=-1)
    h0_mean = (argmax // SIDE).to(patches.dtype)[None, :]
    w0_mean = (argmax % SIDE).to(patches.dtype)[None, :]
    return torch.stack([
        (0.1 * z[0]).abs(),
        (1.0 + 0.2 * z[1]).abs(),
        (h0_mean + 0.3 * z[2]).clamp(0.01, 4.99),
        (w0_mean + 0.3 * z[3]).clamp(0.01, 4.99),
        (1.2 + 0.3 * z[4]).abs(),
        (1.0 + 0.3 * z[5]).abs(),
    ])


def mc_fit_plain(patches, samples, exp=torch.exp):
    """The best sample of every candidate, in torch operations.

    patches: (K, 5, 5) normalised; samples: (6, n_iter, K). Returns
    (best_p (K, 6), best_norm (K,)): the first sample whose norm
    ``sqrt(sum((patch - model / max(model))^2))`` (summed in pixel order)
    is strictly below the running best, which starts at +inf with a zero
    6-vector; a NaN norm never wins. ``exp``: the exponential (the tests
    pass one that matches the g++ build of kernel D's body)."""
    K = patches.shape[0]
    n_iter = samples.shape[1]
    grid = torch.arange(SIDE, dtype=patches.dtype, device=patches.device)
    flat = patches.reshape(K, -1)
    best_norm = torch.full((K,), float("inf"), dtype=patches.dtype,
                           device=patches.device)
    best_p = torch.zeros((K, 6), dtype=patches.dtype, device=patches.device)
    for s in range(n_iter):
        H, A, h0, w0, sh, _ = samples[:, s]
        dh = grid[None, :] - h0[:, None]
        dw = grid[None, :] - w0[:, None]
        t = -(dh * dh)[:, :, None] - (dw * dw)[:, None, :]
        den = 2.0 * (sh * sh)
        g = A[:, None, None] * exp(t / den[:, None, None]) + H[:, None, None]
        g = g.reshape(K, -1)
        g = g / g.amax(dim=-1, keepdim=True)
        d = flat - g
        d2 = d * d
        acc = d2[:, 0]
        for p in range(1, SIDE * SIDE):
            acc = acc + d2[:, p]
        norm = torch.sqrt(acc)
        better = norm < best_norm
        best_norm = torch.where(better, norm, best_norm)
        best_p = torch.where(better[:, None], samples[:, s].T, best_p)
    return best_p, best_norm
