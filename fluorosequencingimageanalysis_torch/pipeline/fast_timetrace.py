"""Array-native timetrace workflow (the movie front door).

Counterpart of fluorosequencingimageanalysis_tpu/pipeline/fast_timetrace.py.
The reference's movie flow (basic_timetrace_script.py -> flexlibrary
TimetraceExperiment, flexlibrary.py:3266-3713) is: detect spots on the
first frame, follow each spot frame to frame by luminosity centroid with an
S/N gate (flexlibrary.py:1172-1317), measure a photometry trace per track,
and step-fit every trace.

Here the tracking recursion runs in plain torch on one device, or on each
device of a device list over its share of the tracks (``lc_track``): per
frame,
all live spots' centroid windows, S/N windows and gating decisions are
batched tensor operations with no host read, so the T - 1 frames enqueue
back to back and the results are fetched once. Photometry reuses the
experiment path's window gathers (fast_experiment.gather_windows) and step
fitting the batched chain of ops/stepfit_batch.py.

Semantics (those of the JAX package's scan, which its tests hold against
the class path):
- window origins truncate the (possibly float) prior center like the
  reference's ``int()`` casts (flexlibrary.py:1216-1222),
- candidate acceptance is Spot.__init__'s 5x5 fit,
- the S/N gate measures Illumina S/N on the 5x5 slice at the rounded
  centroid; failures fall back to a spot at the prior center's
  Py2-rounded position when that fits, else None,
- a None frame does not kill the track: the walk continues from the last
  accepted spot (flexlibrary.py:1303-1310).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import is_device_list, shares
from .._transfer import Uploader, count_fetched, fetch, wait
from ..models.detect import _as_images
from ..ops import photometry as phot_ops
from ..ops.background import widen
from ..ops.quality import edge_ring_indices
from ..utils import profiling
from ..utils.rounding import py2_round, py2_round_device_i32
from .fast_experiment import _dispatch_photometry, gather_windows

# Square radius of each window metric (mexican_hat takes the config's).
_WINDOW_RADIUS = {"simple": 2, "maximum": 5}


def _window_radius(method, photometry_radius):
    return (photometry_radius if method == "mexican_hat"
            else _WINDOW_RADIUS[method])


def _lc_track_scan(movie, trunc0_h, trunc0_w, round0_h, round0_w,
                   search_radius=3, s_n_cutoff=3.0):
    """The tracking recursion over frames 1..T-1 of ``movie`` ([T, H, W]
    tensor, cast to float32 on its device) from integer start states
    ([N] integer tensors on that device). Returns (rec_h, rec_w, present):
    [T-1, N] int32, int32 and bool tensors; absent frames record -1.
    Nothing is read back inside the loop."""
    T, H, W = movie.shape
    r = search_radius
    d = 2 * r + 1
    dev = movie.device
    movie_f = widen(movie)
    dd = torch.arange(-r, r + 1, device=dev)
    d5 = torch.arange(-2, 3, device=dev)
    # Centered index weights: with raw offsets 0..d-1 the float32 moment
    # sum of a bright uint16 window exceeds 2^24 (65535 * 49 * 6 ~ 1.9e7)
    # and rounds, so a symmetric blob whose exact centroid is x.5 can flip
    # the Py2 rounding below against the host's float64 center of mass.
    # Centered (idx - r in [-r, r]), every partial sum of an integer-valued
    # movie stays under 2^24 at the default search radius: both moments
    # are then exact in float32.
    idx = torch.arange(d, dtype=torch.float32, device=dev) - r
    ring = torch.as_tensor(edge_ring_indices(5), device=dev)

    def gather(flat, hs, ws, offs):
        return flat[(hs[:, None, None] + offs[:, None]) * W +
                    (ws[:, None, None] + offs[None, :])]

    trunc_h, trunc_w = trunc0_h.long(), trunc0_w.long()
    round_h, round_w = round0_h.long(), round0_w.long()
    minus1 = torch.full_like(trunc_h, -1)
    recs_h, recs_w, presents = [], [], []
    for t in range(1, T):
        flat = movie_f[t].reshape(-1)
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
        # Illumina S/N of the 5x5 slice at the rounded centroid
        # (Spot.illumina_s_n; ops/quality.py's arithmetic).
        sl = gather(flat, rc_h.clamp(2, H - 3), rc_w.clamp(2, W - 3),
                    d5).reshape(-1, 25)
        edge = sl[:, ring]
        e_mean = torch.mean(edge, dim=-1)
        e_std = torch.std(edge, dim=-1, correction=0)
        sn = (torch.amax(sl, dim=-1) - e_mean) / e_std
        # A NaN S/N (flat slice: e_std == 0 and max == mean, as in a
        # saturated uint16 region) keeps the candidate: the host gate is
        # "fall back if s_n < cutoff" (flexlibrary.py:1247) and NaN < x is
        # False, so the gate is ~(sn < cutoff), not (sn >= cutoff).
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
    N = trunc_h.shape[0]
    if not recs_h:
        empty = torch.zeros((0, N), dtype=torch.int32, device=dev)
        return empty, empty.clone(), empty.to(torch.bool)
    return (torch.stack(recs_h).to(torch.int32),
            torch.stack(recs_w).to(torch.int32), torch.stack(presents))


def _initial_centers(h0, w0):
    """Host prep of the float initial centers shared by lc_track and
    lc_track_and_photometry: ``int()`` truncation (reference:
    ``int(spot.h - offset)``) and Py2 rounding happen on the host in
    float64, exactly. Returns int32 (trunc_h, trunc_w, round_h, round_w)."""
    h0 = np.asarray(h0, np.float64)
    w0 = np.asarray(w0, np.float64)
    trunc_h = np.trunc(h0).astype(np.int32)
    trunc_w = np.trunc(w0).astype(np.int32)
    round_h = np.asarray([py2_round(v) for v in h0], np.int32)
    round_w = np.asarray([py2_round(v) for v in w0], np.int32)
    return trunc_h, trunc_w, round_h, round_w


def _start_states(h0, w0, device):
    """(host int32 arrays, their tensors on ``device``) of the four start
    states, uploaded as one array."""
    states = _initial_centers(h0, w0)
    dev_states = Uploader(torch.from_numpy(np.stack(states)),
                          [(0, len(states), device)]).take(0)
    return states, tuple(dev_states)


def lc_track(movie, h0, w0, search_radius=3, s_n_cutoff=3.0, device=None):
    """Batched LC tracking over a [T, H, W] movie from float initial
    centers (h0, w0). Returns (rec_h, rec_w, present): [T, N] host arrays
    (int32, int32, bool); frame 0 records the truncated initial centers
    (the positions the class path's photometry batching uses for the
    float-centered initial Spots).

    ``movie``: a tensor (tracked where it lies unless ``device`` is given)
    or an array (uploaded to ``device``, default "cuda"). A device list or
    a ``_device.Mesh`` in ``device`` splits the tracks over its data
    devices (the JAX package's ``mesh=``): the movie goes once to each
    device, each device walks its contiguous share of the tracks, every
    share is enqueued before any result is fetched, and the shares return
    in track order. Tracks are independent walks, so no filler walks are
    needed and the result is the one-device result."""
    states = np.stack(_initial_centers(h0, w0))
    N = states.shape[1]
    if is_device_list(device):
        spans = shares(N, device)
        movies = {}
        for _, _, d in spans:
            if d not in movies:
                movies[d] = _as_images(movie, d)
    else:
        movie_dev = _as_images(movie, device)
        spans = [(0, N, movie_dev.device)]
        movies = {movie_dev.device: movie_dev}
    # Track-major, so that each share of the tracks is a piece of rows.
    uploader = Uploader(torch.from_numpy(np.ascontiguousarray(states.T)),
                        spans)
    pending = []
    with torch.no_grad():
        for i, (_, _, d) in enumerate(spans):
            pending.append(fetch(list(_lc_track_scan(
                movies[d], *uploader.take(i).T,
                search_radius=search_radius,
                s_n_cutoff=float(s_n_cutoff)))))
    parts = [wait(p) for p in pending]
    rec_h, rec_w, present = (np.concatenate(col, axis=1)
                             for col in zip(*parts))
    rec_h = np.concatenate([states[0][None], rec_h])
    rec_w = np.concatenate([states[1][None], rec_w])
    present = np.concatenate([np.ones((1, N), bool), present])
    return rec_h, rec_w, present


def _host_window_value(img, h, w, method, win_r, brim):
    """One clipped-slice window measurement on a host frame."""
    if method == "mexican_hat":
        return phot_ops.mexican_hat_host(img, h, w, brim_size=brim,
                                         radius=win_r)
    if method == "simple":
        return phot_ops.simple_host(img, h, w, radius=win_r)
    return phot_ops.maximum_host(img, h, w, radius=win_r)


def _edge_fallbacks(movie, rec_h, rec_w, where, method, win_r, brim, out):
    """Present-but-not-interior positions ``where`` ([T, N] bool): the
    exact host truncation fallbacks, written into ``out`` ([N, T]). Only
    the frames that have such a position are fetched, once each."""
    frame_cache = {}
    for f, n in zip(*np.nonzero(where)):
        if f not in frame_cache:
            frame_cache[f] = movie[int(f)].cpu().numpy()
        out[n, f] = _host_window_value(frame_cache[f], int(rec_h[f, n]),
                                       int(rec_w[f, n]), method, win_r,
                                       brim)


def lc_track_and_photometry(movie_dev, h0, w0, method, search_radius=3,
                            s_n_cutoff=3.0, photometry_radius=9,
                            photometry_brim=6, photometry_min=None,
                            photometry_top=1, chunk=65536):
    """Fused movie path: LC tracking and whole-movie photometry with no
    host round trip between them.

    The tracker's device outputs are clipped into the gather-interior box
    on the device and feed the window gathers of the experiment path
    (fast_experiment.gather_windows + ops.photometry.patch_reduction, so
    interior values equal timetrace_photometries'), ``chunk`` windows at a
    time (65,536 windows of 19 x 19 float32 are 95 MB); the four results
    copy back together. Only the window metrics (mexican_hat, simple,
    maximum) take this path.

    ``movie_dev``: [T, H, W] tensor on the device that does the work.
    Returns (rec_h, rec_w, present, photometries): the [T, N] host arrays
    of lc_track plus the (N, T) float64 photometry matrix of
    timetrace_photometries (None frames 0, exact host edge fallbacks,
    photometry_min applied).

    While tracing is on (``utils.profiling``), the enqueueing of the walk,
    the window gathers and the result copies is the span
    ``api/timetrace/track``, with device time on a CUDA device.
    """
    T, H, W = movie_dev.shape
    win_r = _window_radius(method, photometry_radius)
    dev = movie_dev.device
    _, (t0h, t0w, r0h, r0w) = _start_states(h0, w0, dev)
    N = t0h.shape[0]
    reduce = phot_ops.patch_reduction(method, win_r,
                                      brim_size=photometry_brim,
                                      top=photometry_top)
    with torch.no_grad(), profiling.span("api/timetrace/track", device=dev):
        movie_f = widen(movie_dev)
        rec_h_d, rec_w_d, present_d = _lc_track_scan(
            movie_f, t0h, t0w, r0h, r0w, search_radius=search_radius,
            s_n_cutoff=float(s_n_cutoff))
        full_h = torch.cat([t0h[None], rec_h_d])
        full_w = torch.cat([t0w[None], rec_w_d])
        present_full = torch.cat([
            torch.ones((1, N), dtype=torch.bool, device=dev), present_d])
        # Clipped, out-of-window and absent positions are overridden on
        # the host afterwards (edge fallbacks, zeros): the clip only keeps
        # the gather in bounds.
        hc = full_h.long().clamp(win_r, H - 1 - win_r).reshape(-1)
        wc = full_w.long().clamp(win_r, W - 1 - win_r).reshape(-1)
        img_id = torch.arange(T, device=dev).repeat_interleave(N)
        chunks = [reduce(gather_windows(movie_f, img_id[lo:lo + chunk],
                                        hc[lo:lo + chunk], wc[lo:lo + chunk],
                                        win_r))
                  for lo in range(0, T * N, chunk)]
        phot_d = torch.cat(chunks) if chunks else movie_f.new_zeros(0)
        profiling.bump("ledger/photometry_dispatches", len(chunks))
        pending = fetch([full_h, full_w, present_full, phot_d])
    profiling.bump("ledger/step_dispatches")
    fetched = wait(pending)
    count_fetched(fetched)
    rec_h, rec_w, present, vals = fetched
    vals = vals.astype(np.float64).reshape(T, N)

    interior = ((rec_h >= win_r) & (rec_h < H - win_r) &
                (rec_w >= win_r) & (rec_w < W - win_r))
    out = np.where((present & interior).T, vals.T, 0.0)
    _edge_fallbacks(movie_f, rec_h, rec_w, present & ~interior, method,
                    win_r, photometry_brim, out)
    if photometry_min is not None:
        out = np.maximum(out, photometry_min)
    return rec_h, rec_w, present, out


def timetrace_photometries(movie, rec_h, rec_w, present, method,
                           initial_fits=None, photometry_radius=9,
                           photometry_brim=6, photometry_min=None,
                           aperture_radius=3, box_size=10, filter_size=10,
                           chunk=65536):
    """(N, T) photometry traces at the tracked positions.

    ``movie``: [T, H, W] float tensor on the device that measures. None
    frames are 0 (Trace.photometries, flexlibrary.py:1339-1346); interior
    positions are gathered on the device; edge positions use the exact
    host truncation fallbacks; the fit-product metrics take the initial
    frame's fit values and the fit-less defaults afterwards (tracked Spots
    carry gaussian_fit=None); sextractor measures every position on the
    host (pipeline/spots.py). photometry_min rounds everything up
    afterwards, like Trace.photometries.
    """
    T, N = rec_h.shape
    H, W = movie.shape[1:]
    out = np.zeros((N, T), np.float64)
    if method in ("gaussian_volume", "sigmas"):
        default = 0.0 if method == "gaussian_volume" else -1e9
        out[:, :] = np.where(present.T, default, 0.0)
        if initial_fits is not None:
            for i, gf in enumerate(initial_fits):
                if gf is None:
                    out[i, 0] = default
                elif method == "gaussian_volume":
                    out[i, 0] = 1e6 * gf[3] * gf[4] * gf[5]
                else:
                    out[i, 0] = 1e6 * gf[4] * gf[5]
    elif method == "sextractor":
        from .spots import sextractor_aperture_sums

        movie_np = movie.cpu().numpy()
        for f in range(T):
            idx = np.nonzero(present[f])[0]
            if idx.size == 0:
                continue
            out[idx, f] = sextractor_aperture_sums(
                movie_np[f], rec_h[f, idx], rec_w[f, idx],
                aperture_radius, box_size, filter_size)
    else:
        win_r = _window_radius(method, photometry_radius)
        f_idx, n_idx = np.nonzero(present)
        hs = rec_h[f_idx, n_idx]
        ws = rec_w[f_idx, n_idx]
        interior = ((hs >= win_r) & (hs < H - win_r) &
                    (ws >= win_r) & (ws < W - win_r))
        if interior.any():
            # [T, H, W] -> [T, 1, H, W]: one "cycle" per frame, so the
            # whole-stack gather's image index is the frame index.
            out[n_idx[interior], f_idx[interior]] = _dispatch_photometry(
                movie.reshape(T, 1, H, W), f_idx[interior], hs[interior],
                ws[interior], method, win_r, photometry_brim, chunk)
        edge = np.zeros(present.shape, bool)
        edge[f_idx[~interior], n_idx[~interior]] = True
        _edge_fallbacks(movie, rec_h, rec_w, edge, method, win_r,
                        photometry_brim, out)
    if photometry_min is not None:
        out = np.maximum(out, photometry_min)
    return out
