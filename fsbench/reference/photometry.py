"""Batched spot photometry over square windows.

A frozen copy of the port's ops/photometry.py for the mexican hat (sum of
the crown minus n_crown times the median of the brim; 19x19 window, 7x7
crown, 312 brim pixels by default). Windows are gathered with
``lax.dynamic_slice`` semantics; callers keep centers ``radius`` from every
edge.
"""

from __future__ import annotations

import numpy as np
import torch

from .candidates import gather_patches_dynslice
from .lm import _median


def crown_flat_indices(radius: int, brim_size: int) -> np.ndarray:
    """Flat indices of the crown box inside a (2r+1)^2 patch."""
    d = 2 * radius + 1
    m = np.zeros((d, d), dtype=bool)
    m[brim_size:d - brim_size, brim_size:d - brim_size] = True
    return np.nonzero(m.reshape(-1))[0]


def brim_flat_indices(radius: int, brim_size: int) -> np.ndarray:
    d = 2 * radius + 1
    m = np.ones((d, d), dtype=bool)
    m[brim_size:d - brim_size, brim_size:d - brim_size] = False
    return np.nonzero(m.reshape(-1))[0]


def patch_reduction(method, radius, brim_size=6, top=1):
    """The metric's reduction over flattened (..., (2r+1)^2) patch rows."""
    if method == "mexican_hat":
        crown_idx = torch.as_tensor(crown_flat_indices(radius, brim_size))
        brim_idx = torch.as_tensor(brim_flat_indices(radius, brim_size))

        def reduce(flat):
            crown_sum = torch.sum(flat[..., crown_idx.to(flat.device)],
                                  dim=-1)
            # Even brim count: the mean of the two middle values, as
            # jnp.median (torch.median would return the lower one).
            brim_median = _median(flat[..., brim_idx.to(flat.device)])
            return crown_sum - crown_idx.numel() * brim_median
    elif method == "simple":
        def reduce(flat):
            return torch.sum(flat, dim=-1)
    elif method == "maximum":
        def reduce(flat):
            return torch.sum(torch.topk(flat, top, dim=-1).values, dim=-1)
    else:
        raise ValueError("unknown patch metric: " + repr(method))
    return reduce


def _flat_windows(image, hs, ws, radius):
    patches = gather_patches_dynslice(image, hs, ws, radius=radius)
    return patches.reshape(*patches.shape[:-2], -1)


def mexican_hat_batch(image, hs, ws, brim_size=6, radius=9):
    """(N,) mexican-hat photometries of one (H, W) image at (hs, ws), or
    (B, N) for a (B, H, W) batch with (B, N) centers."""
    return patch_reduction("mexican_hat", radius, brim_size=brim_size)(
        _flat_windows(image, hs, ws, radius))


# ---------------------------------------------------------------------------
# Host functions with the reference's edge truncation (Spot.photometry with
# return_invalid=True): the square is clipped at the frame, and crown/brim
# membership is taken by position within the clipped slice.
# ---------------------------------------------------------------------------


