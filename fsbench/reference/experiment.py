"""The experiment's host half, in numpy and plain torch.

Frozen copy of the port's ``pipeline/fast_experiment.py`` for the
mexican-hat photometry (spot lists, linking, fill-in, hole photometry,
rows, categories, both CSVs), with the greedy linker of
``csrc/tracklink.cpp`` (the reference's
Experiment.greedy_particle_tracking) written again in numpy and Python:
Python-2 rounding into per-frame pixel bins, a persistent ancestor cache
that newer frames overwrite, candidate pairs ancestor-raster-major and
window-cell-raster-minor, a stable sort by Euclidean distance, and greedy
acceptance.
"""

from __future__ import annotations

import csv
import io

import numpy as np
import torch

from .photometry import patch_reduction
from .rounding import py2_round_array

_KEY_SHIFT = np.int64(1 << 20)
_KEY_M = np.int64(1 << 21)


def accumulate_offsets(offsets):
    """Cumulative (h, w) offsets with respect to frame 0, summed in frame
    order."""
    out = []
    ch = cw = 0.0
    for dh, dw in offsets:
        ch += dh
        cw += dw
        out.append((ch, cw))
    return out


def _pack_spot_keys(img, rh, rw):
    img = np.asarray(img, np.int64)
    return ((img * _KEY_M + (np.asarray(rh) + _KEY_SHIFT)) * _KEY_M +
            (np.asarray(rw) + _KEY_SHIFT))


def spot_lists(out, F, C):
    """Step outputs -> per-(field, cycle) rounded spot arrays and their
    photometry: kept fits in candidate order, first candidate of each
    rounded center, then the tri-state validity of the winners."""
    state = np.asarray(out["spot_state"])
    if (state == 3).any():
        raise ValueError("non-finite or wild fitted center on a kept spot")
    fi, ci, si = np.nonzero(state)
    rh = np.asarray(out["spot_rh"])[fi, ci, si].astype(np.int64)
    rw = np.asarray(out["spot_rw"])[fi, ci, si].astype(np.int64)
    cand = np.asarray(out["spot_cand_c"])[fi, ci, si]
    kept = state[fi, ci, si] == 2
    val = np.asarray(out["photometry"], np.float64)[fi, ci, si]
    img = fi.astype(np.int64) * C + ci
    order = np.lexsort((cand, img))
    img, rh, rw, kept, val = (img[order], rh[order], rw[order], kept[order],
                              val[order])
    _, first = np.unique(_pack_spot_keys(img, rh, rw), return_index=True)
    first.sort()
    first = first[kept[first]]
    img, rh, rw, val = img[first], rh[first], rw[first], val[first]
    bounds = np.searchsorted(img, np.arange(F * C + 1))

    def split(a):
        return [[a[bounds[f * C + c]:bounds[f * C + c + 1]]
                 for c in range(C)] for f in range(F)]

    return split(rh), split(rw), split(val)


def greedy_link(h, w, frame_start, frame_shape, radius):
    """Per-spot ancestor links (-1 for none) of frame-major positions."""
    H, W = frame_shape
    n = len(h)
    bh, bw = py2_round_array(h), py2_round_array(w)
    if n and ((bh < 0).any() or (bh >= H).any() or (bw < 0).any()
              or (bw >= W).any()):
        raise ValueError("a spot rounds outside the frame")
    bins = bh * W + bw
    anc = np.full(n, -1, np.int64)
    cache = np.full(H * W, -1, np.int64)
    dgrid = np.full(H * W, -1, np.int64)
    pad = int(radius) + 2
    win = 2 * pad + 1
    ci = np.arange(win * win)
    off_h, off_w = ci // win - pad, ci % win - pad
    for f in range(len(frame_start) - 1):
        lo, hi = frame_start[f], frame_start[f + 1]
        if np.unique(bins[lo:hi]).size != hi - lo:
            raise AssertionError(f"two spots of frame {f} share a bin")
    for f in range(1, len(frame_start) - 1):
        prev = np.arange(frame_start[f - 1], frame_start[f])
        cache[bins[prev]] = prev
        d_spots = np.arange(frame_start[f], frame_start[f + 1])
        if d_spots.size == 0:
            continue
        dgrid[bins[d_spots]] = d_spots
        cells = np.nonzero(cache >= 0)[0]          # raster order
        a = cache[cells]
        dh = (cells // W)[:, None] + off_h[None, :]
        dw = (cells % W)[:, None] + off_w[None, :]
        inside = (dh >= 0) & (dh < H) & (dw >= 0) & (dw < W)
        d = np.where(inside, dgrid[np.clip(dh, 0, H - 1) * W +
                                   np.clip(dw, 0, W - 1)], -1)
        ar, cr = np.nonzero(d >= 0)
        aa, dd = a[ar], d[ar, cr]
        ddh = h[aa] - h[dd]
        ddw = w[aa] - w[dd]
        dist = np.sqrt(ddh * ddh + ddw * ddw)
        near = dist < radius
        ar, cr, aa, dd, dist = ar[near], cr[near], aa[near], dd[near], \
            dist[near]
        order = np.lexsort((cr, ar, dist))
        a_cell = cells[ar]
        for k in order.tolist():
            if cache[a_cell[k]] != aa[k] or anc[dd[k]] != -1:
                continue
            anc[dd[k]] = aa[k]
            cache[a_cell[k]] = -1
        dgrid[bins[d_spots]] = -1
    return anc


def link_field(rh_by_cycle, rw_by_cycle, frame_shape, cum, radius):
    """Linking + trace assembly of one field: (pos (T, C, 2) int64,
    present (T, C) bool), traces in the reference's extraction order."""
    C = len(rh_by_cycle)
    H, W = frame_shape
    rh_by_cycle, rw_by_cycle = list(rh_by_cycle), list(rw_by_cycle)
    for c in range(C):
        rh, rw = rh_by_cycle[c], rw_by_cycle[c]
        if len(rh) == 0:
            continue
        gh = (rh[:, None] + cum[c, 0]) - cum[:, 0][None, :]
        gw = (rw[:, None] + cum[c, 1]) - cum[:, 1][None, :]
        ok = ((gh >= 0) & (gh < H - 0.5) &
              (gw >= 0) & (gw < W - 0.5)).all(axis=1)
        rh_by_cycle[c], rw_by_cycle[c] = rh[ok], rw[ok]
    counts = np.array([len(x) for x in rh_by_cycle], np.int64)
    frame_start = np.zeros(C + 1, np.int64)
    np.cumsum(counts, out=frame_start[1:])
    N = int(frame_start[-1])
    if N == 0:
        return np.zeros((0, C, 2), np.int64), np.zeros((0, C), bool)
    ih = np.concatenate(rh_by_cycle)
    iw = np.concatenate(rw_by_cycle)
    frame_of = np.repeat(np.arange(C), counts)
    h = ih + cum[frame_of, 0]
    w = iw + cum[frame_of, 1]
    anc = greedy_link(h, w, frame_start, frame_shape, radius)
    root = np.where(anc >= 0, anc, np.arange(N))
    while True:
        nxt = np.where(anc[root] >= 0, anc[root], root)
        if (nxt == root).all():
            break
        root = nxt
    rast_bin = py2_round_array(h) * W + py2_round_array(w)
    heads = np.nonzero(anc == -1)[0]
    heads = heads[np.lexsort((rast_bin[heads], frame_of[heads]))]
    rank_of_head = np.empty(N, np.int64)
    rank_of_head[heads] = np.arange(len(heads))
    trace_of = rank_of_head[root]
    pos = np.zeros((len(heads), C, 2), np.int64)
    present = np.zeros((len(heads), C), bool)
    pos[trace_of, frame_of, 0] = ih
    pos[trace_of, frame_of, 1] = iw
    present[trace_of, frame_of] = True
    return pos, present


def fill_traces(pos, present, cum, frame_shape, window_radius,
                spot_radius=2):
    """Interpolated hole positions and trace validity:
    (filled (T, C, 2) int64, valid (T,) bool)."""
    T, C = present.shape
    H, W = frame_shape
    if T == 0:
        return pos, np.zeros((0,), bool)
    f_idx = np.arange(C)[None, :]
    prev = np.where(present, f_idx, -1)
    np.maximum.accumulate(prev, axis=1, out=prev)
    nxt = np.where(present, f_idx, C)
    nxt = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]
    t_idx = np.arange(T)[:, None]
    prev_c = np.clip(prev, 0, C - 1)
    next_c = np.clip(nxt, 0, C - 1)
    pos_p = pos[t_idx, prev_c].astype(np.float64)
    pos_n = pos[t_idx, next_c].astype(np.float64)
    cum_f = cum[None, :, :]
    cum_p = cum[prev_c]
    cum_n = cum[next_c]
    has_p = prev >= 0
    has_n = nxt < C
    n_span = np.maximum((nxt - prev), 1).astype(np.float64)[:, :, None]
    i_span = (f_idx - prev)[:, :, None].astype(np.float64)
    start = pos_p
    stop = pos_n + (cum_p - cum_n)
    inc = (stop - start) / n_span
    val_interior = start + inc * i_span + (cum_f - cum_p)
    val_head = pos_n + (cum[0][None, None, :] - cum_n) + \
        (cum_f - cum[0][None, None, :])
    val_tail = pos_p + (cum_f - cum_p)
    val = np.where(has_p[:, :, None],
                   np.where(has_n[:, :, None], val_interior, val_tail),
                   val_head)
    filled = np.where(present[:, :, None], pos, py2_round_array(val))
    box_ok = ((filled[:, :, 0] >= spot_radius) &
              (filled[:, :, 0] < H - spot_radius) &
              (filled[:, :, 1] >= spot_radius) &
              (filled[:, :, 1] < W - spot_radius))
    r = window_radius
    win_ok = ((filled[:, :, 0] >= r) & (filled[:, :, 0] < H - r) &
              (filled[:, :, 1] >= r) & (filled[:, :, 1] < W - r))
    valid = (box_ok | present).all(axis=1) & win_ok.all(axis=1)
    return filled, valid


def lookup_spot_values(rhs, rws, vals, C, field_of, pos, cats):
    """Present-frame values by matching (image, rh, rw) keys; NaN at
    holes."""
    skeys, svals = [], []
    for f in range(len(rhs)):
        for c in range(C):
            if len(rhs[f][c]):
                skeys.append(_pack_spot_keys(f * C + c, rhs[f][c],
                                             rws[f][c]))
                svals.append(np.asarray(vals[f][c], np.float64))
    out = np.full(pos.shape[:2], np.nan, np.float64)
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
        raise RuntimeError("a present trace position is missing from the "
                           "spot bucket")
    out[hit] = svals[qi][hit]
    return out


def hole_photometry(images, img_id, hs, ws, radius, brim, lowp):
    """Mexican-hat photometry of (M, H, W) float32 device images at the
    given host positions, as float64."""
    if len(hs) == 0:
        return np.zeros(0)
    _, H, W = images.shape
    dev = images.device
    idx = torch.from_numpy(np.stack([img_id, hs, ws]).astype(np.int64)).to(
        dev)
    d = torch.arange(-radius, radius + 1, device=dev)
    rows = (idx[1][:, None] + d)[:, :, None]
    cols = (idx[2][:, None] + d)[:, None, :]
    patches = images.reshape(-1)[(idx[0][:, None, None] * H + rows) * W +
                                 cols]
    reduce = patch_reduction("mexican_hat", radius, brim_size=brim)
    vals = lowp(reduce(patches.reshape(patches.shape[0], -1)))
    return vals.cpu().numpy().astype(np.float64)


def rows_by_field(pos, cats, phot, field_sizes):
    """Rows per field: categories in first-appearance order, then trace
    order; each row (category, h0, w0, photometries (C,))."""
    out = []
    start = 0
    for size in field_sizes:
        stop = start + size
        groups = {}
        for j in range(start, stop):
            cat = tuple(bool(x) for x in cats[j])
            groups.setdefault(cat, []).append(j)
        out.append([(cat, int(pos[j, 0, 0]), int(pos[j, 0, 1]), phot[j])
                    for cat, js in groups.items() for j in js])
        start = stop
    return out


def experiment_host_half(step_out, images, F, C, frame_shape, settings,
                         candidate_radius, lowp):
    """Per-field rows from one group's step outputs and its (F*C, H, W)
    float32 device images."""
    phot = settings["photometry"]
    r = phot["radius"]
    rhs, rws, vals = spot_lists(step_out, F, C)
    all_pos, all_cats, sizes = [], [], []
    for f in range(F):
        offs = [(float(step_out["offsets_h"][f, c]),
                 float(step_out["offsets_w"][f, c])) for c in range(C)]
        cum = np.asarray(accumulate_offsets(offs), np.float64)
        pos, present = link_field(rhs[f], rws[f], frame_shape, cum,
                                  candidate_radius)
        filled, valid = fill_traces(pos, present, cum, frame_shape, r)
        all_pos.append(filled[valid])
        all_cats.append(present[valid])
        sizes.append(int(valid.sum()))
    n_spots = sum(len(x) for per_c in rhs for x in per_c)
    if sum(sizes) == 0:
        return [[] for _ in range(F)], n_spots
    pos = np.concatenate(all_pos)
    cats = np.concatenate(all_cats)
    field_of = np.repeat(np.arange(F), sizes)
    values = lookup_spot_values(rhs, rws, vals, C, field_of, pos, cats)
    hole_t, hole_c = np.nonzero(~cats)
    values[hole_t, hole_c] = hole_photometry(
        images, field_of[hole_t] * C + hole_c, pos[hole_t, hole_c, 0],
        pos[hole_t, hole_c, 1], r, phot["brim_size"], lowp)
    return rows_by_field(pos, cats, values, sizes), n_spots


def onoff(pattern):
    return " ".join(["[ON] " if p else "[OFF]" for p in pattern])


def track_csv_text(rows, n_cycles):
    """The CHANNEL,FIELD,H,W,CATEGORY,FRAME i... CSV as text."""
    buf = io.StringIO(newline="")
    writer = csv.writer(buf, dialect="excel")
    writer.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                    ["FRAME " + str(i) for i in range(n_cycles)])
    for (channel, f, h0, w0, cat, ph) in rows:
        writer.writerow([str(channel), str(f), str(h0), str(w0), str(cat)] +
                        [str(v) for v in ph])
    return buf.getvalue()


def filter_monotone(category_counts):
    """The one-drop monotone category filter: sorted(cat, reverse) ==
    cat."""
    return {ch: {f: {cat: n for cat, n in d.items()
                     if tuple(sorted(cat, reverse=True)) == cat}
                 for f, d in by_f.items()}
            for ch, by_f in category_counts.items()}


def category_csv_text(counts):
    """The Pattern,Channel,Count CSV of {channel: {field: {cat: n}}}
    summed over fields, as text."""
    buf = io.StringIO(newline="")
    writer = csv.writer(buf, dialect="excel")
    writer.writerow(["Pattern", "Channel", "Count"])
    patterns = sorted({p for fields in counts.values()
                       for pats in fields.values() for p in pats})
    for pattern in patterns:
        for chan in sorted(counts):
            writer.writerow([onoff(pattern), str(chan),
                             str(sum(ex.get(pattern, 0)
                                     for ex in counts[chan].values()))])
    return buf.getvalue()
