"""Array-native experiment path: tracking, fill-in, hole photometry, rows.

Counterpart of fluorosequencingimageanalysis_tpu/pipeline/fast_experiment.py,
the reference's basic_experiment_script flow without Spot/Image objects:

    experiment-step spot buckets (parallel/mesh.py)
      -> per-field native greedy linking (csrc/tracklink.cpp)
      -> trace assembly (pointer-jumping roots, one scatter)
      -> hole fill-in (closed forms of the reference's interpolate_spots)
      -> invalid-trace discarding (one mask)
      -> photometry: detected frames reuse the step's per-spot bucket; the
         interpolated holes are gathered on the device from the group the
         step already holds
      -> binary categories + track-photometries CSV rows

The host half is numpy, line for line with the JAX package: the float
operation order of the offset and interpolation arithmetic is the
specification (a knife-edge position one ulp off rounds to another pixel).
The hole gathers are plain torch: a (2r+1)^2 window gather per position
and ``ops.photometry.patch_reduction``, queued on the stream and copied
into pinned host memory behind an event, so that nothing waits for them
until ``flush_hole_queue``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._transfer import fetch, wait
from ..native.tracklink import greedy_link
from ..ops import photometry as photometry_ops
from ..utils import profiling
from ..utils.rounding import py2_round_array
from .tracking import accumulate_offsets

# Composite (image, rh, rw) -> collision-free int64 key. The shift keeps
# quirk-kept negative or out-of-frame coordinates positive (|rh|, |rw| <
# 2^20) and img * M * M stays below 2^63. _spot_lists and
# _lookup_spot_values must pack identically, hence one helper.
_KEY_SHIFT = np.int64(1 << 20)
_KEY_M = np.int64(1 << 21)

# Photometry methods of this path. The image metrics measure a square of
# their own radius; gaussian_volume and sigmas are fit products the step
# computed per detected spot, and interpolated spots take the reference's
# fit-less defaults. sextractor measures circular-aperture sums on
# background-subtracted images (flexlibrary.py:243-262), on the host, one
# vectorised pass per image (pipeline/spots.py).
FAST_PHOTOMETRY_METHODS = ("mexican_hat", "simple", "maximum",
                           "gaussian_volume", "sigmas", "sextractor")

# Fit-less (interpolated-frame) defaults for the fit-product metrics.
_FIT_METRIC_DEFAULTS = {"gaussian_volume": 0.0, "sigmas": -1e9}


def check_photometry_method(method):
    """Raise ValueError unless this path measures ``method``."""
    if method not in FAST_PHOTOMETRY_METHODS:
        raise ValueError(f"run_experiment supports photometry methods "
                         f"{FAST_PHOTOMETRY_METHODS}; got {method!r}")


def _pack_spot_keys(img, rh, rw):
    img = np.asarray(img, np.int64)
    rh = np.asarray(rh)
    rw = np.asarray(rw)
    # Bounded LM centers stay within a pixel of their candidate, so this
    # cannot trip on real fits; it raises rather than alias keys.
    if rh.size and (max(np.abs(rh).max(), np.abs(rw).max()) >=
                    int(_KEY_SHIFT)):
        raise ValueError("spot coordinate exceeds the 2^20 key packing "
                         "range (wild fit center?)")
    return (img * _KEY_M + (rh + _KEY_SHIFT)) * _KEY_M + (rw + _KEY_SHIFT)


def _spot_lists(out, F, C):
    """Step outputs -> per-(field, cycle) integer spot arrays.

    ``out`` holds the step's compact bucket (spot_rh, spot_rw, spot_state,
    spot_cand_c) and its photometry as host arrays.
    Replicates the reference's psfs-dict construction and Spot.__init__
    filtering: kept fits in candidate order, deduplicated on the rounded
    center (first candidate wins), then the step's tri-state validity
    (0 empty, 1 valid-but-rejected, 2 tracked, 3 wild) applied to the
    winners. Returns (rh[f][c], rw[f][c]) int64 arrays and the per-spot
    photometry (float64) aligned with them, or None where ``out`` holds no
    "photometry" (the sextractor path measures on the host and does not
    fetch it).
    """
    state = np.asarray(out["spot_state"])
    if (state == 3).any():
        # A kept fit whose center is non-finite or beyond int16; the
        # reference's int(py2_round(h)) raises on the same input.
        raise ValueError(
            "non-finite or wild fitted center on a kept spot "
            "(spot_state == 3); the reference would raise here")
    fi, ci, si = np.nonzero(state)
    rh = np.asarray(out["spot_rh"])[fi, ci, si].astype(np.int64)
    rw = np.asarray(out["spot_rw"])[fi, ci, si].astype(np.int64)
    cand = np.asarray(out["spot_cand_c"])[fi, ci, si]
    kept = state[fi, ci, si] == 2
    with_values = "photometry" in out
    val = (np.asarray(out["photometry"], np.float64)[fi, ci, si]
           if with_values else np.zeros(len(fi)))
    img = fi.astype(np.int64) * C + ci
    # Global (image, cand_idx) order == per-image candidate order.
    order = np.lexsort((cand, img))
    img, rh, rw, kept, val = (img[order], rh[order], rw[order], kept[order],
                              val[order])
    # np.unique(return_index) gives each key's first occurrence, which is
    # the first in candidate order within its image (dict setdefault).
    _, first = np.unique(_pack_spot_keys(img, rh, rw), return_index=True)
    first.sort()
    # Validity applies to the dict winners only: an invalid winner
    # shadows a valid loser at the same key.
    first = first[kept[first]]
    img, rh, rw = img[first], rh[first], rw[first]
    bounds = np.searchsorted(img, np.arange(F * C + 1))

    def split(a):
        return [[a[bounds[f * C + c]:bounds[f * C + c + 1]]
                 for c in range(C)] for f in range(F)]

    return (split(rh), split(rw),
            split(val[first]) if with_values else None)


def _link_field(rh_by_cycle, rw_by_cycle, frame_shape, cum,
                candidate_radius=2):
    """Native greedy linking + vectorised trace assembly for one field.

    ``cum``: (C, 2) float64 cumulative offsets (accumulate_offsets).
    Returns (pos (T, C, 2) int64, present (T, C) bool) with traces ordered
    like the reference's extraction walk (head frame, then bin raster).
    """
    C = len(rh_by_cycle)
    H, W = frame_shape
    # Discard dropouts before linking (the reference's discard_dropouts):
    # a spot whose offset position leaves any frame is not tracked. This
    # also keeps every position handed to the C++ core inside the grid.
    rh_by_cycle = list(rh_by_cycle)
    rw_by_cycle = list(rw_by_cycle)
    for c in range(C):
        rh, rw = rh_by_cycle[c], rw_by_cycle[c]
        if len(rh) == 0:
            continue
        # Float order is the spec: (h + spot_offset) first, then each
        # frame offset subtracted (apply_offset -> unapply_offset).
        gh = (rh[:, None] + cum[c, 0]) - cum[:, 0][None, :]   # (n, C)
        gw = (rw[:, None] + cum[c, 1]) - cum[:, 1][None, :]
        ok = ((gh >= 0) & (gh < H - 0.5) &
              (gw >= 0) & (gw < W - 0.5)).all(axis=1)
        if not ok.all():
            rh_by_cycle[c] = rh[ok]
            rw_by_cycle[c] = rw[ok]
    counts = np.array([len(rh_by_cycle[c]) for c in range(C)], np.int32)
    frame_start = np.zeros(C + 1, np.int32)
    np.cumsum(counts, out=frame_start[1:])
    N = int(frame_start[-1])
    if N == 0:
        return (np.zeros((0, C, 2), np.int64), np.zeros((0, C), bool))
    ih = np.concatenate([rh_by_cycle[c] for c in range(C)])
    iw = np.concatenate([rw_by_cycle[c] for c in range(C)])
    frame_of = np.repeat(np.arange(C), counts)
    h = ih + cum[frame_of, 0]
    w = iw + cum[frame_of, 1]
    anc, _desc = greedy_link(h, w, frame_start, frame_shape,
                             candidate_radius)
    anc = anc.astype(np.int64)

    # Root of every spot's chain by pointer jumping (chains are <= C long).
    root = np.where(anc >= 0, anc, np.arange(N))
    while True:
        nxt = np.where(anc[root] >= 0, anc[root], root)
        if (nxt == root).all():
            break
        root = nxt
    # Trace ranks: heads ordered by (frame, bin raster), the reference's
    # extraction walk.
    rast_bin = py2_round_array(h) * int(frame_shape[1]) + py2_round_array(w)
    heads = np.nonzero(anc == -1)[0]
    heads = heads[np.lexsort((rast_bin[heads], frame_of[heads]))]
    T = len(heads)
    rank_of_head = np.empty(N, np.int64)
    rank_of_head[heads] = np.arange(T)
    trace_of = rank_of_head[root]
    pos = np.zeros((T, C, 2), np.int64)
    present = np.zeros((T, C), bool)
    pos[trace_of, frame_of, 0] = ih
    pos[trace_of, frame_of, 1] = iw
    present[trace_of, frame_of] = True
    return pos, present


def _fill_traces(pos, present, cum, frame_shape, spot_radius=2,
                 photometry_radius=9):
    """Vectorised interpolate_spots/fill_in_trace + validity over all
    traces at once.

    pos: (T, C, 2) int64 positions at present frames; present: (T, C);
    cum: (C, 2) cumulative offsets. Returns (filled (T, C, 2) int64,
    valid (T,) bool, hole_ok (T, C), win_ok (T, C)): hole_ok is False
    exactly where the reference emits a None Spot (an out-of-5x5-box
    hole), win_ok is the photometry window's fit, and
    valid == hole_ok.all & win_ok.all.
    """
    T, C = present.shape
    H, W = frame_shape
    if T == 0:
        empty = np.zeros((0, C), bool)
        return pos, np.zeros((0,), bool), empty, empty
    f_idx = np.arange(C)[None, :]
    # prev[t, f]: last present frame <= f (-1 if none); nxt[t, f]: first
    # present frame >= f (C if none).
    prev = np.where(present, f_idx, -1)
    np.maximum.accumulate(prev, axis=1, out=prev)
    nxt = np.where(present, f_idx, C)
    nxt = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]

    t_idx = np.arange(T)[:, None]
    prev_c = np.clip(prev, 0, C - 1)
    next_c = np.clip(nxt, 0, C - 1)
    pos_p = pos[t_idx, prev_c].astype(np.float64)          # (T, C, 2)
    pos_n = pos[t_idx, next_c].astype(np.float64)
    cum_f = cum[None, :, :]
    cum_p = cum[prev_c]
    cum_n = cum[next_c]

    has_p = prev >= 0
    has_n = nxt < C
    # Interior gaps: inc = (stop - start)/n once, then start + inc*i plus
    # the frame's offset re-application, in the reference's order; the
    # offset difference is taken first, then one add.
    n_span = np.maximum((nxt - prev), 1).astype(np.float64)[:, :, None]
    i_span = (f_idx - prev)[:, :, None].astype(np.float64)
    start = pos_p
    stop = pos_n + (cum_p - cum_n)
    inc = (stop - start) / n_span
    val_interior = start + inc * i_span + (cum_f - cum_p)
    # Head holes: constant at the next spot's frame-0-mapped position,
    # re-offset per frame.
    val_head = pos_n + (cum[0][None, None, :] - cum_n) + \
        (cum_f - cum[0][None, None, :])
    # Tail holes: constant at the previous spot's position, re-offset.
    val_tail = pos_p + (cum_f - cum_p)

    val = np.where(has_p[:, :, None],
                   np.where(has_n[:, :, None], val_interior, val_tail),
                   val_head)
    filled = np.where(present[:, :, None], pos, py2_round_array(val))

    # Interpolated positions must fit the 5x5 spot box, and every position
    # the photometry window (trace_to_photometry(return_invalid=False)).
    box_ok = ((filled[:, :, 0] >= spot_radius) &
              (filled[:, :, 0] < H - spot_radius) &
              (filled[:, :, 1] >= spot_radius) &
              (filled[:, :, 1] < W - spot_radius))
    r = photometry_radius
    win_ok = ((filled[:, :, 0] >= r) & (filled[:, :, 0] < H - r) &
              (filled[:, :, 1] >= r) & (filled[:, :, 1] < W - r))
    hole_ok = box_ok | present
    valid = hole_ok.all(axis=1) & win_ok.all(axis=1)
    return filled, valid, hole_ok, win_ok


def _photometry_window_radius(method, mexican_hat_radius,
                              aperture_radius=3):
    """The metric's square radius, which is also the validity radius of
    trace_to_photometry(return_invalid=False) for that metric.
    gaussian_volume checks the spot box; sigmas imposes none; sextractor
    checks its aperture radius (flexlibrary.py:250-251), and the aperture
    itself is cut at the frame's edges."""
    if method == "sextractor":
        return int(np.ceil(aperture_radius))
    return {"mexican_hat": mexican_hat_radius, "simple": 2,
            "maximum": 5, "gaussian_volume": 2, "sigmas": 0}[method]


def _lookup_spot_values(rhs, rws, vals, C, field_of, pos, cats, default):
    """Present-frame values by vectorised key matching: every present
    (trace, cycle) position is some detected spot's (rh, rw) key, unique
    within its image, so one searchsorted over composite (image, rh, rw)
    keys resolves all of them."""
    F = len(rhs)
    skeys, svals = [], []
    for f in range(F):
        for c in range(C):
            rh = rhs[f][c]
            if len(rh) == 0:
                continue
            skeys.append(_pack_spot_keys(f * C + c, rh, rws[f][c]))
            svals.append(np.asarray(vals[f][c], np.float64))
    out = np.full(pos.shape[:2], default, np.float64)
    if not skeys:
        return out
    skeys = np.concatenate(skeys)
    svals = np.concatenate(svals)
    order = np.argsort(skeys)
    skeys, svals = skeys[order], svals[order]
    img_of = (field_of[:, None] * C + np.arange(C)[None, :]).astype(np.int64)
    qkey = _pack_spot_keys(img_of, pos[:, :, 0], pos[:, :, 1])
    qi = np.clip(np.searchsorted(skeys, qkey), 0, len(skeys) - 1)
    hit = cats & (skeys[qi] == qkey)
    if not np.array_equal(hit, cats):
        raise RuntimeError("present trace position missing from the spot "
                           "bucket: spot_values misaligned with "
                           "spot_arrays")
    out[hit] = svals[qi][hit]
    return out


def gather_windows(imgs, img_id, hs, ws, radius):
    """(B, (2r+1)^2) float32 windows of ``imgs`` (M, H, W) centred at
    (img_id, hs, ws) (int64 tensors on imgs' device; every window inside
    the image). Gathers in the storage dtype; uint16 is read through an
    int16 view and widened with ``& 0xFFFF`` (bit-exact), because indexing
    covers few uint16 operations."""
    _, H, W = imgs.shape
    d = torch.arange(-radius, radius + 1, device=imgs.device)
    rows = (hs[:, None] + d)[:, :, None]
    cols = (ws[:, None] + d)[:, None, :]
    wide = imgs.dtype == torch.uint16
    src = imgs.view(torch.int16) if wide else imgs
    patches = src.reshape(-1)[(img_id[:, None, None] * H + rows) * W + cols]
    if wide:
        patches = patches.to(torch.int32) & 0xFFFF
    return patches.reshape(patches.shape[0], -1).to(torch.float32)


def _queue_photometry(stack, img_id, hs, ws, method, window_radius, brim,
                      chunk):
    """Enqueue chunked window photometry at (img_id, hs, ws) over the
    (F, C, H, W) ``stack`` tensor on its device. On a CUDA device each
    chunk's indices upload from pinned memory on the current stream (not
    through ``_transfer.Uploader``, whose side stream and events cost
    ~50 us more a chunk on an H100's host: PERF.md, section 6) and its
    result copies back through ``_transfer.fetch``, so nothing here waits
    for the device. Returns the pending list for
    ``_resolve_photometry``."""
    Fp, C, H, W = stack.shape
    imgs = stack.reshape(Fp * C, H, W)
    reduce = photometry_ops.patch_reduction(method, window_radius,
                                            brim_size=brim)
    on_card = imgs.device.type == "cuda"
    pending = []
    for lo in range(0, hs.shape[0], chunk):
        hi = min(lo + chunk, hs.shape[0])
        idx = torch.from_numpy(np.stack(
            [img_id[lo:hi], hs[lo:hi], ws[lo:hi]]).astype(np.int64))
        if on_card:
            idx = idx.pin_memory().to(imgs.device, non_blocking=True)
        vals = reduce(gather_windows(imgs, idx[0], idx[1], idx[2],
                                     window_radius))
        profiling.bump("ledger/photometry_dispatches")
        pending.append((lo, hi, fetch([vals])))
    return pending


def _resolve_photometry(pending, out):
    """Wait for queued photometry chunks and write them into ``out``."""
    for lo, hi, chunk in pending:
        out[lo:hi] = wait(chunk)[0]


def _dispatch_photometry(stack, img_id, hs, ws, method, window_radius,
                         brim, chunk):
    """Window photometry at (img_id, hs, ws); returns (B,) float64."""
    phot = np.empty(hs.shape[0], np.float64)
    _resolve_photometry(
        _queue_photometry(stack, img_id, hs, ws, method, window_radius,
                          brim, chunk), phot)
    return phot


def flush_hole_queue(queue):
    """Resolve every deferred hole-gather request.

    Each entry is ``(pending, phot, hole_t, hole_c)`` appended by
    run_experiment_stack(hole_queue=...): the gathers were enqueued at
    group time and only the wait is deferred to here. The (Ttot, C)
    ``phot`` buffers are filled in place: the rows run_experiment_stack
    already returned alias rows of those buffers, so their NaN holes
    become values. Flush before reading any hole photometry.
    """
    for pending, phot, hole_t, hole_c in queue:
        vals = np.empty(hole_t.shape[0], np.float64)
        _resolve_photometry(pending, vals)
        phot[hole_t, hole_c] = vals
    queue.clear()


def run_experiment_stack(stack, offsets_h, offsets_w, spot_arrays,
                         spot_values, photometry_method="mexican_hat",
                         photometry_radius=9, photometry_brim=6,
                         candidate_radius=2, chunk=65536,
                         aperture_radius=3, box_size=10, filter_size=10,
                         hole_queue=None, skip_hole_gathers=False,
                         keep_invalid=False, host_images=None,
                         field_arrays=None):
    """All fields: tracking -> fill-in -> validity -> photometry -> rows.

    stack: (F, C, H, W) tensor on the device that measures the holes (the
    step's group, in its storage dtype); offsets_h/w: (F, C) host arrays;
    spot_arrays: (rhs, rws) from ``_spot_lists``; spot_values: the step's
    per-spot photometry aligned with spot_arrays. Detected frames take
    those values; only interpolated holes are gathered from ``stack`` (the
    fit-product metrics gaussian_volume and sigmas gather nothing: holes
    take the reference's fit-less defaults). For sextractor ``stack`` is
    the host stack (numpy array or CPU tensor), ``spot_values`` is unused
    and every position is measured on the host: per image the mesh
    background (``box_size``, ``filter_size``) is subtracted and all of
    its trace positions are summed over the exact circular aperture of
    ``aperture_radius``.

    hole_queue: if a list is given, the hole gathers are enqueued now and
    a request is appended for a later ``flush_hole_queue``; the returned
    rows carry NaN at holes until then. skip_hole_gathers: never measure
    holes (they stay NaN); the save_averages surface averages detected
    frames only. keep_invalid: every trace emits a row; out-of-5x5-box
    holes (the reference's None Spots) carry NaN, and positions whose
    window is clipped at a frame edge are measured on the host with the
    reference's clipped-slice semantics from ``host_images`` ((F, C, H, W)
    numpy array or tensor of these fields), which is then required,
    except for sextractor, whose zero-padded aperture sum is the clipped
    measurement already.

    field_arrays: if a list is given, one ``FieldArrays`` a field is
    appended to it, the arrays behind that field's rows (none where no
    field has a trace).

    Returns a list of per-field row lists, each row (category, h0, w0,
    photometries (C,)) in the reference's order.

    Traced spans (``utils.profiling.span``, host clock), one after another:
    "api/track/link" (offsets, ``_link_field``) and "api/track/fill"
    (``_fill_traces`` and the validity selection) once a field, then
    "api/track/lookup" (concatenation, the step's per-spot values, the
    hole mask; sextractor's host measurement), "api/track/hole_enqueue"
    (the device gathers enqueued, or dispatched where no queue is given)
    and "api/track/rows" (``_rows_by_field``). While tracing is on,
    counters "experiment/traces" (traces linked, before the validity
    filter) and "experiment/holes" (positions handed to the gathers).
    """
    check_photometry_method(photometry_method)
    host_phot = photometry_method == "sextractor"
    if spot_values is None and not host_phot:
        raise ValueError("run_experiment_stack needs spot_values (the "
                         "step's per-spot photometry bucket)")
    if keep_invalid and host_images is None and not host_phot:
        raise ValueError("keep_invalid needs host_images for the "
                         "reference's clipped-slice edge measurements")
    window_radius = _photometry_window_radius(photometry_method,
                                              photometry_radius,
                                              aperture_radius)
    rhs, rws = spot_arrays
    F = len(rhs)
    C = len(rhs[0]) if F else 0
    H, W = stack.shape[2], stack.shape[3]
    all_pos, all_cats, field_sizes = [], [], []
    all_hole_ok, all_win_ok = [], []
    n_traces = 0
    for f in range(F):
        with profiling.span("api/track/link"):
            offs = [(float(offsets_h[f, c]), float(offsets_w[f, c]))
                    for c in range(C)]
            cum = np.asarray(accumulate_offsets(offs), dtype=np.float64)
            pos, present = _link_field(rhs[f], rws[f], (H, W), cum,
                                       candidate_radius)
        n_traces += pos.shape[0]
        with profiling.span("api/track/fill"):
            filled, valid, hole_ok, win_ok = _fill_traces(
                pos, present, cum, (H, W), photometry_radius=window_radius)
            sel = slice(None) if keep_invalid else valid
            all_pos.append(filled[sel])
            all_cats.append(present[sel])
            field_sizes.append(filled.shape[0] if keep_invalid
                               else int(valid.sum()))
            if keep_invalid:
                all_hole_ok.append(hole_ok)
                all_win_ok.append(win_ok)
    if profiling.enabled():
        profiling.bump("experiment/traces", n_traces)
    if sum(field_sizes) == 0:
        return [[] for _ in range(F)]
    # Only the intensity methods gather holes from the device: the fit
    # metrics give holes the fit-less defaults, and sextractor measures
    # every position on the host.
    gathers = not host_phot and photometry_method not in _FIT_METRIC_DEFAULTS
    with profiling.span("api/track/lookup"):
        pos = np.concatenate(all_pos)          # (Ttot, C, 2)
        cats = np.concatenate(all_cats)        # (Ttot, C)
        field_of = np.repeat(np.arange(F), field_sizes)
        if keep_invalid:
            hole_ok = np.concatenate(all_hole_ok)  # False = None Spot (NaN)
            win_ok = np.concatenate(all_win_ok)    # False = clipped window
        if host_phot:
            phot = _sextractor_photometry(
                stack, pos, field_sizes, hole_ok if keep_invalid else None,
                aperture_radius, box_size, filter_size)
        elif not gathers:
            phot = _lookup_spot_values(
                rhs, rws, spot_values, C, field_of, pos, cats,
                _FIT_METRIC_DEFAULTS[photometry_method])
            if keep_invalid:
                phot[~hole_ok] = np.nan  # the reference's None Spots
        else:
            phot = _lookup_spot_values(rhs, rws, spot_values, C, field_of,
                                       pos, cats, np.nan)
            hole_mask = ~cats
            if keep_invalid:
                # Full-window in-box holes go to the device; clipped
                # windows are measured on the host below and None Spots
                # stay NaN.
                hole_mask &= win_ok & hole_ok
            hole_t, hole_c = np.nonzero(hole_mask)
    if gathers:
        if hole_t.size and not skip_hole_gathers:
            if profiling.enabled():
                profiling.bump("experiment/holes", hole_t.size)
            with profiling.span("api/track/hole_enqueue"):
                args = (stack, field_of[hole_t] * C + hole_c,
                        pos[hole_t, hole_c, 0], pos[hole_t, hole_c, 1],
                        photometry_method, window_radius, photometry_brim,
                        chunk)
                if hole_queue is not None:
                    hole_queue.append((_queue_photometry(*args), phot,
                                       hole_t, hole_c))
                else:
                    phot[hole_t, hole_c] = _dispatch_photometry(*args)
        if keep_invalid:
            _host_clipped_photometry(host_images, field_of, pos,
                                     ~win_ok & hole_ok, photometry_method,
                                     window_radius, photometry_brim, phot)
    with profiling.span("api/track/rows"):
        return _rows_by_field(pos, cats, phot, field_sizes, F,
                              field_arrays)


def _sextractor_photometry(stack, pos, field_sizes, hole_ok, aperture_radius,
                           box_size, filter_size):
    """Every trace position measured on the host (sextractor): per image
    the mesh background is subtracted and the exact circular aperture
    summed. Zero padding is the clipped-slice edge semantics of an
    aperture sum (outside pixels contribute nothing either way), so
    keep_invalid needs no separate edge pass: only the None-Spot positions
    (``hole_ok`` False, where given) stay NaN."""
    from .spots import sextractor_aperture_sums

    stack_np = (stack.cpu().numpy() if isinstance(stack, torch.Tensor)
                else np.asarray(stack))
    C = pos.shape[1]
    phot = np.full((pos.shape[0], C), np.nan, np.float64)
    start = 0
    for f, size in enumerate(field_sizes):
        stop = start + size
        if stop == start:
            continue
        p = pos[start:stop]                       # (n, C, 2)
        for c in range(C):
            if hole_ok is None:
                phot[start:stop, c] = sextractor_aperture_sums(
                    stack_np[f, c], p[:, c, 0], p[:, c, 1],
                    aperture_radius, box_size, filter_size)
                continue
            ok = hole_ok[start:stop, c]
            if ok.any():
                phot[start:stop, c][ok] = sextractor_aperture_sums(
                    stack_np[f, c], p[ok, c, 0], p[ok, c, 1],
                    aperture_radius, box_size, filter_size)
        start = stop
    return phot


def _host_clipped_photometry(host_images, field_of, pos, trunc, method,
                             window_radius, brim, out):
    """The reference's clipped-slice photometry (Spot.photometry with
    return_invalid=True) at the window-truncated positions ``trunc``
    (keep_invalid only), written into ``out`` in place. The images are
    fetched to the host only when there is such a position."""
    tt, tc = np.nonzero(trunc)
    if not tt.size:
        return
    imgs = (host_images.cpu().numpy() if isinstance(host_images,
                                                     torch.Tensor)
            else np.asarray(host_images))
    for t, c in zip(tt.tolist(), tc.tolist()):
        im = imgs[int(field_of[t]), c]
        h, w = int(pos[t, c, 0]), int(pos[t, c, 1])
        if method == "mexican_hat":
            v = photometry_ops.mexican_hat_host(im, h, w, brim_size=brim,
                                                radius=window_radius)
        elif method == "simple":
            v = photometry_ops.simple_host(im, h, w, radius=window_radius)
        else:  # maximum, the only other image metric
            v = photometry_ops.maximum_host(im, h, w, radius=window_radius)
        out[t, c] = v


class FieldArrays(NamedTuple):
    """The arrays behind one field's rows from ``_rows_by_field``: row k
    is (cat_tuples[category[k]], int(h0[k]), int(w0[k]), phot[index[k]]).
    ``phot`` is the array the rows' photometries are views of, so that
    the hole photometry ``flush_hole_queue`` writes later shows here too."""
    category: np.ndarray      # (n,) index into cat_tuples
    cat_tuples: list
    h0: np.ndarray            # (n,) float64 positions, as pos holds them
    w0: np.ndarray
    phot: np.ndarray          # (traces, C) float64
    index: np.ndarray         # (n,) rows of phot


def _rows_by_field(pos, cats, phot, field_sizes, F, field_arrays=None):
    """Rows per field: categories in first-appearance order, then trace
    order (binary_trace_categories -> btc_photometries iteration); with
    ``field_arrays`` a list, each field's ``FieldArrays`` is appended.

    Categories pack into uint64 bitmask words (one per 64 cycles); one
    np.unique per field recovers the groups and a stable argsort on the
    first-appearance rank reproduces the reference's dict order."""
    C = cats.shape[1] if cats.ndim == 2 else 0
    nw = (C + 63) // 64 or 1  # bitmask words per trace
    padded = np.zeros((cats.shape[0], nw * 64), np.uint64)
    padded[:, :C] = cats
    codes_all = padded.reshape(-1, nw, 64) @ (
        np.uint64(1) << np.arange(64, dtype=np.uint64))
    if nw == 1:
        codes_all = codes_all[:, 0]  # 1-D unique is much faster
    h0_all, w0_all = pos[:, 0, 0], pos[:, 0, 1]
    out = []
    start = 0
    for f in range(F):
        stop = start + field_sizes[f]
        codes = codes_all[start:stop]
        uniq, first_idx, inv = np.unique(
            codes, axis=0 if nw > 1 else None,
            return_index=True, return_inverse=True)
        inv = inv.reshape(-1)  # numpy>=2.0 keeps the axis-0 shape
        rank = np.empty(len(uniq), np.int64)
        rank[np.argsort(first_idx, kind="stable")] = np.arange(len(uniq))
        order = np.argsort(rank[inv], kind="stable")
        cat_tuples = [tuple(bool(x) for x in cats[start + i])
                      for i in first_idx]
        rows = [(cat_tuples[inv[j]], int(h0_all[start + j]),
                 int(w0_all[start + j]), phot[start + j]) for j in order]
        out.append(rows)
        if field_arrays is not None:
            index = start + order
            field_arrays.append(FieldArrays(inv[order], cat_tuples,
                                            h0_all[index], w0_all[index],
                                            phot, index))
        start = stop
    return out


def filter_monotone_categories(category_counts):
    """One-drop monotone category filter over {channel: {field: {cat:
    n}}}: tuple(sorted(cat, reverse=True)) == cat, the reference's
    count_binary_trace_categories_filtered rule."""
    return {ch: {f: {cat: n for cat, n in d.items()
                     if tuple(sorted(cat, reverse=True)) == cat}
                 for f, d in by_f.items()}
            for ch, by_f in category_counts.items()}


def write_track_rows_csv(rows, n_cycles, csv_path, save_averages=False):
    """The track-photometries CSV over assembled rows (channel, field, h,
    w, category, photometries-or-mean): the reference's
    CHANNEL,FIELD,H,W,CATEGORY[,FRAME i...] schema (or AVERAGE_INTENSITY
    with ``save_averages``); None photometries write '0'.

    The native writer (native/trackrows_csv.py) writes the file wherever
    every row is of the shapes run_experiment makes
    (``trackrows_csv.as_arrays``); any other row, such as an
    ``adjustment_function``'s ints, sends the whole file to the Python
    writer, whose bytes the native writer's equal. While tracing is on,
    the counter "experiment/csv_rows_native" counts the rows the native
    writer wrote."""
    from ..native import trackrows_csv

    arrays = trackrows_csv.as_arrays(rows, save_averages)
    if arrays is None:
        _write_track_rows_csv_python(rows, n_cycles, csv_path,
                                     save_averages)
        return
    _write_native_csv(arrays, n_cycles, csv_path, save_averages)


def write_track_fields_csv(fields, n_cycles, csv_path):
    """``write_track_rows_csv`` of rows that are still the rows
    ``_rows_by_field`` made, straight from the arrays behind them, with
    no pass over the rows: ``fields`` holds (channel, field,
    ``FieldArrays``) in the rows' order."""
    from ..native import trackrows_csv

    channels, categories = {}, {}
    parts = []
    for channel, f, a in fields:
        if a.phot.dtype != np.float64:
            raise TypeError("the photometries must be float64")
        c = channels.setdefault(id(channel), (len(channels), channel))[0]
        # A category is a tuple of bools, whose str() its value fixes.
        text = np.fromiter(
            (categories.setdefault(t, len(categories))
             for t in a.cat_tuples), np.int32, len(a.cat_tuples))
        parts.append((np.full(len(a.index), c, np.int32),
                      np.full(len(a.index), f, np.int64),
                      a.h0.astype(np.int64), a.w0.astype(np.int64),
                      text[a.category], a.phot[a.index]))
    if parts:
        ch, field, h, w, cat, values = (np.concatenate(x)
                                        for x in zip(*parts))
    else:
        ch, cat = np.zeros(0, np.int32), np.zeros(0, np.int32)
        field = h = w = np.zeros(0, np.int64)
        values = np.zeros((0, n_cycles))
    flags = np.zeros(len(field), bool)
    arrays = trackrows_csv.TrackRows(
        ch, [str(o) for _, o in channels.values()], field, h, w, flags,
        flags, cat, [str(t) for t in categories], values,
        np.zeros(values.shape, bool))
    _write_native_csv(arrays, n_cycles, csv_path, False)


def _write_native_csv(arrays, n_cycles, csv_path, save_averages):
    """The CSV of ``trackrows_csv.TrackRows`` by the native writer, under
    the Python writer's header; counts the rows while tracing is on."""
    from ..native import trackrows_csv

    header = trackrows_csv.HEADER + (
        ["AVERAGE_INTENSITY"] if save_averages
        else ["FRAME " + str(i) for i in range(n_cycles)])
    n = trackrows_csv.write(csv_path, header, arrays)
    if profiling.enabled():
        profiling.bump("experiment/csv_rows_native", n)


def _write_track_rows_csv_python(rows, n_cycles, csv_path,
                                 save_averages=False):
    """The track-photometries CSV by csv.writer over ``str()`` of every
    cell: the fallback of ``write_track_rows_csv`` and the native writer's
    oracle."""
    import csv as csv_module

    with open(csv_path, "w", newline="") as fh:
        writer = csv_module.writer(fh, dialect="excel")
        if save_averages:
            writer.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY",
                             "AVERAGE_INTENSITY"])
            for (channel, f, h0, w0, cat, mean) in rows:
                writer.writerow([str(channel), str(f), str(h0), str(w0),
                                 str(cat), str(mean)])
            return
        writer.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                        ["FRAME " + str(i) for i in range(n_cycles)])
        for (channel, f, h0, w0, cat, ph) in rows:
            writer.writerow([str(channel), str(f), str(h0), str(w0),
                             str(cat)] +
                            [str(v) if v is not None else "0"
                             for v in ph])
