"""The movie's first-frame starts, luminosity-centroid tracking and
per-frame mexican-hat photometry, in plain torch and numpy.

Frozen copies of the port's plain functions on ``run_timetrace``'s path:

- ``start_keys``: the Python-2-rounded first-occurrence dedupe of the kept
  fits in candidate order (``models/detect.py::_center_keys``,
  pflib.py:513-519);
- ``track``: the tracking recursion (``pipeline/fast_timetrace.py::
  _lc_track_scan`` and ``_initial_centers``): per frame, each live spot's
  centroid window at its truncated prior position, the Illumina S/N of the
  5x5 slice at the rounded centroid, the fallback to the prior rounded
  position, and the walk that goes on from the last accepted spot
  (flexlibrary.py:1172-1317);
- ``photometries``: the mexican hat at every tracked position, on the
  device for windows inside the frame (``lc_track_and_photometry``) and
  with the reference's clipped-slice semantics on the host at the edges
  (``ops/photometry.py::mexican_hat_host``); absent frames read 0.

Departures: the windows are gathered with the reference's
``gather_patches_dynslice`` on the clamped centers (the same pixels as the
port's direct index there), and all frames' windows in one batch.
"""

from __future__ import annotations

import numpy as np
import torch

from .candidates import gather_patches_dynslice
from .detect import identity
from .photometry import patch_reduction
from .quality import edge_ring_indices
from .rounding import py2_round_array, py2_round_device_i32


def start_keys(keep, center_h, center_w):
    """(h0, w0) int64 arrays: the rounded centers of the kept fits of one
    image (host arrays), first occurrence of each key in candidate
    order."""
    idx = np.nonzero(np.asarray(keep))[0]
    kh = py2_round_array(np.asarray(center_h, np.float64)[idx])
    kw = py2_round_array(np.asarray(center_w, np.float64)[idx])
    seen = set()
    h0, w0 = [], []
    for a, b in zip(kh.tolist(), kw.tolist()):
        if (a, b) in seen:
            continue
        seen.add((a, b))
        h0.append(a)
        w0.append(b)
    return np.asarray(h0, np.int64), np.asarray(w0, np.int64)


def track(movie, h0, w0, search_radius=3, s_n_cutoff=3.0):
    """Tracks of the integer starts (h0, w0) through ``movie`` ([T, H, W]
    float32 tensor): (rec_h, rec_w, present), [T, N] host int32, int32 and
    bool arrays; frame 0 holds the starts, absent frames -1."""
    T, H, W = movie.shape
    dev = movie.device
    r = search_radius
    d = 2 * r + 1
    dd = torch.arange(-r, r + 1, device=dev)
    d5 = torch.arange(-2, 3, device=dev)
    # Centered index weights keep both moments exact in float32.
    idx = torch.arange(d, dtype=torch.float32, device=dev) - r
    ring = torch.as_tensor(edge_ring_indices(5), device=dev)

    def gather(flat, hs, ws, offs):
        return flat[(hs[:, None, None] + offs[:, None]) * W +
                    (ws[:, None, None] + offs[None, :])]

    start_h = torch.as_tensor(np.asarray(h0, np.int64), device=dev)
    start_w = torch.as_tensor(np.asarray(w0, np.int64), device=dev)
    trunc_h, trunc_w = start_h.clone(), start_w.clone()
    round_h, round_w = start_h.clone(), start_w.clone()
    minus1 = torch.full_like(trunc_h, -1)
    recs_h, recs_w, presents = [start_h], [start_w], [
        torch.ones_like(start_h, dtype=torch.bool)]
    for t in range(1, T):
        flat = movie[t].reshape(-1)
        in_bounds = ((r <= trunc_h) & (trunc_h < H - r) &
                     (r <= trunc_w) & (trunc_w < W - r))
        th = trunc_h.clamp(r, H - r - 1)
        tw = trunc_w.clamp(r, W - r - 1)
        patches = gather(flat, th, tw, dd)
        total = torch.sum(patches.reshape(-1, d * d), dim=-1)
        ch = torch.sum(patches * idx[None, :, None], dim=(-2, -1)) / total
        cw = torch.sum(patches * idx[None, None, :], dim=(-2, -1)) / total
        rc_h = py2_round_device_i32(ch + th.to(torch.float32)).long()
        rc_w = py2_round_device_i32(cw + tw.to(torch.float32)).long()
        cand_fits = ((2 <= rc_h) & (rc_h < H - 2) &
                     (2 <= rc_w) & (rc_w < W - 2))
        sl = gather(flat, rc_h.clamp(2, H - 3), rc_w.clamp(2, W - 3),
                    d5).reshape(-1, 25)
        edge = sl[:, ring]
        e_mean = torch.mean(edge, dim=-1)
        e_std = torch.std(edge, dim=-1, correction=0)
        sn = (torch.amax(sl, dim=-1) - e_mean) / e_std
        # A NaN S/N (a flat slice) keeps the candidate: the gate is "fall
        # back if s_n < cutoff".
        sn_fails = sn < s_n_cutoff
        good = in_bounds & cand_fits & ~sn_fails
        fb_fits = ((2 <= round_h) & (round_h < H - 2) &
                   (2 <= round_w) & (round_w < W - 2))
        fallback = in_bounds & cand_fits & sn_fails & fb_fits
        present = good | fallback
        rec_h = torch.where(good, rc_h, torch.where(fallback, round_h,
                                                    minus1))
        rec_w = torch.where(good, rc_w, torch.where(fallback, round_w,
                                                    minus1))
        trunc_h = torch.where(present, rec_h, trunc_h)
        trunc_w = torch.where(present, rec_w, trunc_w)
        round_h = torch.where(present, rec_h, round_h)
        round_w = torch.where(present, rec_w, round_w)
        recs_h.append(rec_h)
        recs_w.append(rec_w)
        presents.append(present)
    return (torch.stack(recs_h).to(torch.int32).cpu().numpy(),
            torch.stack(recs_w).to(torch.int32).cpu().numpy(),
            torch.stack(presents).cpu().numpy())


def mexican_hat_host(image, h, w, brim_size=6, radius=9):
    """One mexican hat on a host frame, the square clipped at the frame and
    crown and brim taken by position within the clipped slice."""
    sl = image[max(0, h - radius):min(image.shape[0], h + radius + 1),
               max(0, w - radius):min(image.shape[1], w + radius + 1)]
    d = 2 * radius + 1
    hh, ww = np.indices(sl.shape)
    crown = ((brim_size <= hh) & (hh < d - brim_size) &
             (brim_size <= ww) & (ww < d - brim_size))
    crown_pixels = sl[crown]
    return float(crown_pixels.sum() - crown_pixels.size *
                 np.median(sl[~crown]))


def photometries(movie, rec_h, rec_w, present, radius=9, brim_size=6,
                 lowp=identity):
    """(N, T) float64 mexican hats at the tracked positions of ``movie``
    ([T, H, W] float32 tensor); 0 where a track is absent. ``lowp``
    rounds the device's window values."""
    T, H, W = movie.shape
    N = rec_h.shape[1]
    dev = movie.device
    hc = torch.as_tensor(rec_h.astype(np.int64), device=dev).clamp(
        radius, H - 1 - radius)
    wc = torch.as_tensor(rec_w.astype(np.int64), device=dev).clamp(
        radius, W - 1 - radius)
    windows = gather_patches_dynslice(movie, hc, wc, radius)
    vals = lowp(patch_reduction("mexican_hat", radius, brim_size)(
        windows.reshape(T, N, -1)))
    vals = vals.cpu().numpy().astype(np.float64)
    interior = ((rec_h >= radius) & (rec_h < H - radius) &
                (rec_w >= radius) & (rec_w < W - radius))
    out = np.where((present & interior).T, vals.T, 0.0)
    edge = present & ~interior
    frames = {}
    for f, n in zip(*np.nonzero(edge)):
        if f not in frames:
            frames[f] = movie[int(f)].cpu().numpy()
        value = mexican_hat_host(frames[f], int(rec_h[f, n]),
                                 int(rec_w[f, n]), brim_size, radius)
        out[n, f] = float(lowp(torch.tensor([value], dtype=torch.float64))[0])
    return out
