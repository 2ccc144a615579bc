"""Batched spot photometry over square windows.

Counterpart of fluorosequencingimageanalysis_tpu/ops/photometry.py (device
kernels): mexican hat (sum of the crown minus n_crown times the median of
the brim; 19x19 window, 7x7 crown, 312 brim pixels by default), simple (sum
of the square) and maximum (sum of the top-k pixels). Windows are gathered
with ``lax.dynamic_slice`` semantics; callers keep centers ``radius`` from
every edge. ``luminosity_centroid_batch`` is the movie tracker's centroid
measurement. The ``*_host`` functions measure one numpy image at one center
with the reference's clipped-slice semantics at the edges.
"""

from __future__ import annotations

import numpy as np
import torch

from .candidates import gather_patches_dynslice
from .lm import _median
from .quality import illumina_s_n


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


def simple_batch(image, hs, ws, radius=2):
    return patch_reduction("simple", radius)(
        _flat_windows(image, hs, ws, radius))


def maximum_batch(image, hs, ws, radius=5, top=1):
    """Sum of the top-k pixels in each square."""
    return patch_reduction("maximum", radius, top=top)(
        _flat_windows(image, hs, ws, radius))


def luminosity_centroid_batch(image, hs, ws, radius=3, with_sn=True):
    """Centroid of pixel mass and Illumina S/N in squares around (hs, ws).

    The timetrace tracker's measurement (flexlibrary.py:1172-1259):
    returns (centroid_h, centroid_w) in absolute image coordinates and the
    S/N of the (2*radius+1)^2 slice, in the image's dtype. Interior spots
    only.

    with_sn=False skips the S/N reduction and returns None in its slot:
    the tracker's gate measures S/N at the rounded centroid on the spot's
    own slice (flexlibrary.py:1247), not on this window.
    """
    patches = gather_patches_dynslice(image, hs, ws, radius=radius)
    d = 2 * radius + 1
    dt = patches.dtype
    total = torch.sum(patches.reshape(-1, d * d), dim=-1)
    idx = torch.arange(d, dtype=dt, device=patches.device)
    ch = torch.sum(patches * idx[None, :, None], dim=(-2, -1)) / total
    cw = torch.sum(patches * idx[None, None, :], dim=(-2, -1)) / total
    sn = illumina_s_n(patches) if with_sn else None
    abs_h = ch + hs.to(dt) - radius
    abs_w = cw + ws.to(dt) - radius
    return abs_h, abs_w, sn


# ---------------------------------------------------------------------------
# Host functions with the reference's edge truncation (Spot.photometry with
# return_invalid=True): the square is clipped at the frame, and crown/brim
# membership is taken by position within the clipped slice.
# ---------------------------------------------------------------------------

def _clipped_square(image, h, w, radius):
    image = np.asarray(image)
    return image[max(0, h - radius):min(image.shape[0], h + radius + 1),
                 max(0, w - radius):min(image.shape[1], w + radius + 1)]


def mexican_hat_host(image, h, w, brim_size=6, radius=9):
    sl = _clipped_square(image, h, w, radius)
    d = 2 * radius + 1
    hh, ww = np.indices(sl.shape)
    crown = ((brim_size <= hh) & (hh < d - brim_size) &
             (brim_size <= ww) & (ww < d - brim_size))
    crown_pixels = sl[crown]
    return float(crown_pixels.sum() - crown_pixels.size *
                 np.median(sl[~crown]))


def simple_host(image, h, w, radius=2):
    return float(_clipped_square(image, h, w, radius).sum())


def maximum_host(image, h, w, radius=5, top=1):
    r = np.sort(_clipped_square(image, h, w, radius).ravel())
    return float(np.sum(r[-top:]))
