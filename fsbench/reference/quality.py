"""Fit-quality metrics over batches of patches: R^2, RMSE, Illumina S/N.

A frozen copy of the port's ops/quality.py. Standard
deviations are population ones (``correction=0``), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch


def r_squared(sub_imgs, fit_imgs):
    """(N,) coefficient of determination per patch (NaN for a flat patch
    that the fit matches exactly)."""
    sub = sub_imgs.reshape(sub_imgs.shape[0], -1)
    fit = fit_imgs.reshape(fit_imgs.shape[0], -1)
    ss_res = torch.sum((sub - fit) ** 2, dim=-1)
    mean = torch.mean(sub, dim=-1, keepdim=True)
    ss_tot = torch.sum((sub - mean) ** 2, dim=-1)
    return 1.0 - ss_res / ss_tot


def rmse(sub_imgs, fit_imgs):
    """(N,) root-mean-square error per patch."""
    sub = sub_imgs.reshape(sub_imgs.shape[0], -1)
    fit = fit_imgs.reshape(fit_imgs.shape[0], -1)
    return torch.sqrt(torch.mean((sub - fit) ** 2, dim=-1))


def edge_ring_indices(size: int) -> np.ndarray:
    """Flat indices of the one-pixel boundary ring of a size^2 patch."""
    m = np.zeros((size, size), dtype=bool)
    m[0, :] = m[-1, :] = True
    m[:, 0] = m[:, -1] = True
    return np.nonzero(m.reshape(-1))[0]


def illumina_s_n(sub_imgs):
    """(N,) ``(max(patch) - mean(ring)) / std(ring)``; NaN for a flat patch."""
    n, size = sub_imgs.shape[0], sub_imgs.shape[-1]
    ring = torch.as_tensor(edge_ring_indices(size), device=sub_imgs.device)
    flat = sub_imgs.reshape(n, -1)
    ring_vals = flat[:, ring]
    edge_mean = torch.mean(ring_vals, dim=-1)
    edge_std = torch.std(ring_vals, dim=-1, correction=0)
    return (torch.amax(flat, dim=-1) - edge_mean) / edge_std
