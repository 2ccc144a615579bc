"""Synthetic experiment stacks with planted Gaussian spots.

The recipe of the repo's benchmark stack (bench.py::make_stack): background
N(400, 8), ``spots_per_field`` spots per field at integer pixel centers at
least 8 px from the border, amplitudes U(1500, 4000), sigma 1.3, each
spot drawn on a 13x13 support and repeated in every cycle of its field.
"""

from __future__ import annotations

import numpy as np


def make_stack(F, C, H=512, W=512, spots_per_field=200, seed=0):
    """Returns (stack [F, C, H, W] float32, spots [F, n, 2] int64 centers)."""
    rng = np.random.default_rng(seed)
    stack = rng.normal(400.0, 8.0, (F, C, H, W)).astype(np.float32)
    hh, ww = np.indices((H, W)).astype(np.float32)
    spots = np.zeros((F, spots_per_field, 2), np.int64)
    for f in range(F):
        coords = rng.integers(8, H - 8, (spots_per_field, 2))
        spots[f] = coords
        amps = rng.uniform(1500, 4000, spots_per_field)
        field = np.zeros((H, W), np.float32)
        for (h, w), a in zip(coords, amps):
            lo_h, hi_h = max(0, h - 6), min(H, h + 7)
            lo_w, hi_w = max(0, w - 6), min(W, w + 7)
            field[lo_h:hi_h, lo_w:hi_w] += a * np.exp(
                -(((hh[lo_h:hi_h, lo_w:hi_w] - h) ** 2) +
                  ((ww[lo_h:hi_h, lo_w:hi_w] - w) ** 2)) / (2 * 1.3 ** 2))
        for c in range(C):
            stack[f, c] += field
    return stack, spots


def model_peaks(out):
    """Image coordinates (row, col) of each bucket spot's fitted PSF peak.

    The schema's spot_h/spot_w keep the reference's conventions: agpy's
    axis quirk (the "h_0" slot p2 is the model's column center, p3 its row
    center) and the ``p + h - 2.5`` half-pixel shift. The model's peak is
    at patch (p3, p2) whatever theta, and the patch center pixel is the
    candidate (h, w) = (spot_h - p2 + 2.5, spot_w - p3 + 2.5), so the peak
    is at (h + p3 - 2, w + p2 - 2). Returns two [F, C, S] float64 arrays.
    """
    idx = out["spot_cand_idx"].astype(np.int64)
    p = np.take_along_axis(out["params"], idx[..., None], axis=2)
    p2 = p[..., 2].astype(np.float64)
    p3 = p[..., 3].astype(np.float64)
    rows = out["spot_h"].astype(np.float64) - p2 + p3 + 0.5
    cols = out["spot_w"].astype(np.float64) - p3 + p2 + 0.5
    return rows, cols


def recall(spots, out, tol=1.0):
    """Share of (planted spot, cycle) pairs with a kept spot whose fitted
    PSF peak (:func:`model_peaks`) lies within ``tol`` px in that cycle's
    image. spots: [F, n, 2]; out: a run_stack dict of host numpy arrays."""
    rows, cols = model_peaks(out)
    F, C = out["spot_valid"].shape[:2]
    found = 0
    for f in range(F):
        for c in range(C):
            v = out["spot_valid"][f, c]
            if not v.any():
                continue
            d2 = ((spots[f, :, 0, None] - rows[f, c][v][None, :]) ** 2 +
                  (spots[f, :, 1, None] - cols[f, c][v][None, :]) ** 2)
            found += int(np.sum(d2.min(axis=1) <= tol * tol))
    return found / float(F * C * spots.shape[1])
