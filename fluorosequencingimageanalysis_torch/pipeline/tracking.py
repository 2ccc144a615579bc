"""Particle tracking across frames.

Counterpart of fluorosequencingimageanalysis_tpu/pipeline/tracking.py, a
host copy (tests/test_torch_import.py holds it equal to that module, the
native default of ``greedy_particle_tracking`` apart): the offset algebra,
``discard_dropouts``, the greedy nearest-pair tracker over the native
linker (native/tracklink.py) and the luminosity-centroid tracker of the
movie classes. Greedy tracking reproduces the reference's
Experiment.greedy_particle_tracking (flexlibrary.py:679-1027):

- spots are binned to their offset-adjusted rounded pixel per frame,
- unmatched ancestors persist in a cache across frames (spots may skip
  frames), with newer spots overwriting older cache entries at the same bin,
- per frame, all (ancestor, descendant) pairs within candidate_radius are
  sorted by Euclidean distance (stable: ties keep raster generation order)
  and accepted greedily if neither end is already matched,
- traces are emitted head-first with None gaps.
"""

from __future__ import annotations

import math

import numpy as np


def accumulate_offsets(offsets):
    """Cumulative offsets with respect to frame 0: a list of (h, w)
    running sums, added in frame order (the float order is the reference's).
    """
    if tuple(offsets[0]) != (0, 0):
        raise ValueError("The first image's offset must be (0, 0) by "
                         "definition.")
    out = []
    ch = cw = 0.0
    for dh, dw in offsets:
        ch += dh
        cw += dw
        out.append((ch, cw))
    return out


def get_cumulative_offset(offsets, f, g=0):
    c = accumulate_offsets(offsets)
    return (c[f][0] - c[g][0], c[f][1] - c[g][1])


def apply_offset(coordinates, offset):
    return (coordinates[0] + offset[0], coordinates[1] + offset[1])


def unapply_offset(coordinates, offset):
    return (coordinates[0] - offset[0], coordinates[1] - offset[1])


def offset_frame_coordinates(offsets, coordinate, f, g):
    return apply_offset(coordinate, get_cumulative_offset(offsets, f, g))


def round_coordinates(h, w):
    return int(_py2_round(h)), int(_py2_round(w))


from ..utils.rounding import py2_round as _py2_round  # noqa: E402


def discard_dropouts(spots, spot_cumulative_offsets, frame_cumulative_offsets,
                     image_shape, spot_radius=0):
    """Drop spots that drift out of any frame (flexlibrary.py:625-677).

    Vectorized: one (num_spots, num_frames) bounds check instead of the
    reference's per-spot per-frame Python loop.
    """
    spots = list(spots)
    if not spots:
        return [], 0
    hw = np.array([(s.h, s.w) for s in spots], dtype=np.float64)
    so = np.asarray(spot_cumulative_offsets, dtype=np.float64)
    fo = np.asarray(frame_cumulative_offsets, dtype=np.float64)
    gh = hw[:, 0, None] + so[:, 0, None] - fo[None, :, 0]  # (S, F)
    gw = hw[:, 1, None] + so[:, 1, None] - fo[None, :, 1]
    ok = ((gh >= spot_radius) & (gh < image_shape[0] - 0.5 - spot_radius) &
          (gw >= spot_radius) &
          (gw < image_shape[1] - 0.5 - spot_radius)).all(axis=1)
    filtered = [s for s, k in zip(spots, ok) if k]
    return filtered, int((~ok).sum())


def _py2_round_array(x):
    """Vectorized Python-2 rounding (halves away from zero).

    Always computes in float64, and decides with an EXACT fraction
    comparison rather than `x + 0.5` — the addition form has the same
    knife-edge hazard in f64 that its old docstring called out for f32
    (floor(0.49999999999999994 + 0.5) == 1; Python 2 round() returns 0).
    Mirrors utils.rounding.py2_round exactly."""
    x = np.asarray(x, np.float64)
    ax = np.abs(x)
    f = np.floor(ax)
    r = (f + (ax - f >= 0.5)).astype(np.int64)
    return np.where(x < 0, -r, r)


def greedy_particle_tracking(frame_spots, frame_shape, candidate_radius=2,
                             offsets=None, spot_radius=0, use_native=None):
    """Track spots across frames. Returns (traces, num_discarded).

    traces: list of per-spot lists (len == num frames) of Spot-or-None.

    The linking core runs in C++ (csrc/tracklink.cpp, built with g++ at
    first use; a failed build raises). ``use_native=False`` runs the NumPy
    linker below instead: it is the explicit oracle path, never taken on
    its own. Both reproduce the reference semantics exactly
    (tests/test_torch_objects.py holds each against the JAX package's).
    """
    num_frames = len(frame_spots)
    if offsets is None:
        offsets = [(0, 0)] * num_frames
    cum = accumulate_offsets(offsets)

    filtered = []
    total_discarded = 0
    for f, frame in enumerate(frame_spots):
        frame = list(frame)  # bind once: frames may be one-shot iterators
        fs, nd = discard_dropouts(
            spots=frame,
            spot_cumulative_offsets=[cum[f]] * len(frame),
            frame_cumulative_offsets=cum,
            image_shape=frame_shape, spot_radius=spot_radius)
        filtered.append(fs)
        total_discarded += nd
    frame_spots = filtered

    if use_native is None:
        use_native = True  # the native core; a failed build raises
    if use_native:
        traces = _native_link_and_extract(frame_spots, frame_shape,
                                          candidate_radius, cum)
        return traces, total_discarded

    # Per-frame bins: {(rh, rw): record}; record = dict with spt / links.
    # s_L/a_L/d_L are (frame, rh, rw) triples as in the reference. The
    # positions and bins are also kept as arrays for the vectorized pair
    # generation below.
    cum_arr = np.asarray(cum, dtype=np.float64)
    frame_bins = [dict() for _ in range(num_frames)]
    frame_pos, frame_bin_arr = [], []
    for f, frame in enumerate(frame_spots):
        if frame:
            hw = (np.array([(s.h, s.w) for s in frame], dtype=np.float64) +
                  cum_arr[f])
            bins = np.stack([_py2_round_array(hw[:, 0]),
                             _py2_round_array(hw[:, 1])], axis=1)
        else:
            hw = np.zeros((0, 2))
            bins = np.zeros((0, 2), dtype=np.int64)
        frame_pos.append(hw)
        frame_bin_arr.append(bins)
        for i, spt in enumerate(frame):
            rh, rw = int(bins[i, 0]), int(bins[i, 1])
            assert (rh, rw) not in frame_bins[f], \
                (str((rh, rw)) + " is already filled in frame_bins[" +
                 str(f) + "]")
            frame_bins[f][(rh, rw)] = {"spt": spt, "s_L": (f, rh, rw),
                                       "a_L": None, "d_L": None}

    # Window-cell offsets in raster order; pad the descendant index grid so
    # edge windows need no clipping logic (clipping only removes cells, it
    # never reorders the survivors, so unclipped cell ranks reproduce the
    # reference's raster walk ordering exactly).
    # int() matches the C++ core's truncation; integer grid offsets within
    # a float radius r satisfy |dh| <= int(r) anyway.
    pad = int(candidate_radius) + 2
    cell_offsets = [(i, j) for i in range(-pad, pad + 1)
                    for j in range(-pad, pad + 1)]
    H, W = int(frame_shape[0]), int(frame_shape[1])

    # ancestor_cache: {(rh, rw): record}; unmatched ancestors persist and
    # newer frames overwrite older entries at the same bin.
    ancestor_cache = {}
    for f in range(1, num_frames):
        for (rh, rw), rec in frame_bins[f - 1].items():
            ancestor_cache[(rh, rw)] = {"spt": rec["spt"],
                                        "s_L": (f - 1, rh, rw),
                                        "a_L": None, "d_L": None}
        d_bin = frame_bin_arr[f]
        if not ancestor_cache or len(d_bin) == 0:
            continue
        # Vectorized candidate-pair generation. Reference semantics
        # (flexlibrary.py:906-953): ancestors in raster order over the
        # cache grid, window cells in raster order, Euclidean distance on
        # offset-adjusted float positions, distance < candidate_radius.
        a_keys = sorted(ancestor_cache.keys())
        a_bin = np.asarray(a_keys, dtype=np.int64)
        a_frames = np.fromiter(
            (ancestor_cache[k]["s_L"][0] for k in a_keys),
            dtype=np.int64, count=len(a_keys))
        a_pos = np.array([(ancestor_cache[k]["spt"].h,
                           ancestor_cache[k]["spt"].w) for k in a_keys],
                         dtype=np.float64) + cum_arr[a_frames]
        d_pos = frame_pos[f]
        grid = np.full((H + 2 * pad, W + 2 * pad), -1, dtype=np.int64)
        grid[d_bin[:, 0] + pad, d_bin[:, 1] + pad] = np.arange(len(d_bin))

        parts = []
        for cell_rank, (di, dj) in enumerate(cell_offsets):
            didx = grid[a_bin[:, 0] + di + pad, a_bin[:, 1] + dj + pad]
            ai = np.nonzero(didx >= 0)[0]
            if ai.size == 0:
                continue
            dv = didx[ai]
            # sqrt(dh^2 + dw^2) with separate roundings, NOT np.hypot:
            # the reference's scipy euclidean computes sqrt(((u-v)**2)
            # .sum()) (flexlibrary.py:52, :906), and hypot's compensated
            # algorithm bit-differs on ~17% of pairs — enough to flip a
            # dist < candidate_radius gate or the distance-sorted greedy
            # order on knife-edge pairs.
            ddh = a_pos[ai, 0] - d_pos[dv, 0]
            ddw = a_pos[ai, 1] - d_pos[dv, 1]
            dist = np.sqrt(ddh * ddh + ddw * ddw)
            m = dist < candidate_radius
            if m.any():
                parts.append((ai[m], dv[m], dist[m],
                              np.full(int(m.sum()), cell_rank,
                                      dtype=np.int64)))
        if not parts:
            continue
        aa = np.concatenate([p[0] for p in parts])
        dd = np.concatenate([p[1] for p in parts])
        dists = np.concatenate([p[2] for p in parts])
        cells = np.concatenate([p[3] for p in parts])
        # Stable sort by distance with ties resolved by generation order
        # (ancestor rank, then window-cell rank) — identical to Python's
        # stable sort over the reference's generation sequence.
        order = np.lexsort((cells, aa, dists))

        for t in order:
            ai = int(aa[t])
            akey = a_keys[ai]
            if akey not in ancestor_cache:
                continue  # ancestor already paired this frame
            dkey = (int(d_bin[dd[t], 0]), int(d_bin[dd[t], 1]))
            drec = frame_bins[f][dkey]
            if drec["a_L"] is not None:
                continue  # descendant already paired
            aaf = int(a_frames[ai])
            drec["a_L"] = (aaf, akey[0], akey[1])
            assert frame_bins[aaf][akey]["d_L"] is None, \
                "Ancestor being paired more than once."
            frame_bins[aaf][akey]["d_L"] = (f, dkey[0], dkey[1])
            del ancestor_cache[akey]

    # Extract traces by walking descendant links from head spots.
    traces = []
    for f in range(num_frames):
        for (rh, rw) in sorted(frame_bins[f].keys()):
            rec = frame_bins[f][(rh, rw)]
            if rec["spt"] is None or rec["a_L"] is not None:
                continue
            s_L, d_L = rec["s_L"], rec["d_L"]
            trace = [None] * s_L[0] + [rec["spt"]]
            if d_L is None:
                trace += [None] * (num_frames - s_L[0] - 1)
                traces.append(trace)
                continue
            df, dh, dw = d_L
            while True:
                dbin = frame_bins[df][(dh, dw)]
                ds_L, dd_L = dbin["s_L"], dbin["d_L"]
                trace += [None] * (ds_L[0] - s_L[0] - 1)
                trace.append(dbin["spt"])
                if dd_L is None:
                    break
                s_L = ds_L
                df, dh, dw = dd_L
            trace += [None] * (num_frames - ds_L[0] - 1)
            traces.append(trace)
    return traces, total_discarded


def _native_link_and_extract(frame_spots, frame_shape, candidate_radius,
                             cum):
    """Flatten spots -> C++ linker -> trace assembly.

    Head order matches the reference's extraction walk: frames in order,
    raster order over the frame's bin grid within each frame
    (flexlibrary.py:989-996).
    """
    from ..native.tracklink import greedy_link

    num_frames = len(frame_spots)
    cum_arr = np.asarray(cum, dtype=np.float64)
    spots_flat, h_parts, w_parts = [], [], []
    frame_start = np.zeros(num_frames + 1, dtype=np.int32)
    for f, frame in enumerate(frame_spots):
        frame_start[f + 1] = frame_start[f] + len(frame)
        spots_flat.extend(frame)
        if frame:
            hw = (np.array([(s.h, s.w) for s in frame], dtype=np.float64) +
                  cum_arr[f])
            h_parts.append(hw[:, 0])
            w_parts.append(hw[:, 1])
    if not spots_flat:
        return []
    h = np.concatenate(h_parts)
    w = np.concatenate(w_parts)
    anc, desc = greedy_link(h, w, frame_start, frame_shape, candidate_radius)

    frame_of = np.repeat(np.arange(num_frames),
                         np.diff(frame_start)).astype(np.int64)
    raster = (_py2_round_array(h) * int(frame_shape[1]) +
              _py2_round_array(w))
    heads = np.nonzero(anc == -1)[0]
    heads = heads[np.lexsort((raster[heads], frame_of[heads]))]
    traces = []
    for s in heads:
        s = int(s)
        trace = [None] * int(frame_of[s]) + [spots_flat[s]]
        prev = s
        d = int(desc[s])
        while d != -1:
            trace += [None] * int(frame_of[d] - frame_of[prev] - 1)
            trace.append(spots_flat[d])
            prev = d
            d = int(desc[d])
        trace += [None] * (num_frames - int(frame_of[prev]) - 1)
        traces.append(trace)
    return traces


def luminosity_centroid_particle_tracking(frames, initial_spots,
                                          search_radius=3, s_n_cutoff=3.0,
                                          offsets=None):
    """Fast centroid-following tracking for timetrace movies.

    Parity: flexlibrary.py:1172-1317. Vectorized per frame:
    all live spot windows are gathered and their float64 centroids computed
    in one host pass (bit-identical to scipy center_of_mass per window);
    the per-spot gating logic stays on host.
    """
    from .spots import Spot

    if not all(spot.parent_Image is frames[0] for spot in initial_spots):
        raise ValueError("All initial_spots must be in frames[0].")
    spot_tracks = [[spot] for spot in initial_spots]
    prior = list(initial_spots)
    for f, frame in enumerate(frames):
        if f == 0:
            continue
        offset = offsets[f] if offsets is not None else (0, 0)
        H, W = frame.image.shape[:2]
        d = 2 * search_radius + 1
        # Offset-adjusted window origins per live spot.
        centers = [(int(s.h - offset[0]), int(s.w - offset[1]))
                   for s in prior]
        in_bounds = [(search_radius <= oh < H - search_radius and
                      search_radius <= ow < W - search_radius)
                     for (oh, ow) in centers]
        idx = [i for i, ok in enumerate(in_bounds) if ok]
        if idx:
            # Host float64 centroids, vectorized over the live spots —
            # bit-identical to the reference's per-window
            # scipy.ndimage.center_of_mass (flexlibrary.py:1232-1235):
            # sum(window * grid) / sum(window) with numpy's pairwise
            # reduction per contiguous window, then the reference's
            # (c + o) - search_radius grouping. A device f32 batch here
            # rounded the moment sums of bright uint16 windows (> 2^24)
            # and carried ~6e-5 ulp at image coordinates — enough to
            # flip half-case Py2 rounding on this oracle-faithful compat
            # path. (The flagship movie path is the lax.scan tracker in
            # pipeline/fast_timetrace.py.)
            hs = np.asarray([centers[i][0] for i in idx])
            ws = np.asarray([centers[i][1] for i in idx])
            dd = np.arange(-search_radius, search_radius + 1)
            img64 = np.asarray(frame.image, dtype=np.float64)
            wins = img64[hs[:, None, None] + dd[None, :, None],
                         ws[:, None, None] + dd[None, None, :]]
            grid = np.arange(d, dtype=np.float64)
            m = len(idx)
            tot = wins.reshape(m, -1).sum(axis=1)
            gh = (wins * grid[None, :, None]).reshape(m, -1).sum(axis=1) / tot
            gw = (wins * grid[None, None, :]).reshape(m, -1).sum(axis=1) / tot
            ch = (gh + hs) - search_radius
            cw = (gw + ws) - search_radius
        lookup = {i: j for j, i in enumerate(idx)}
        grid1 = np.arange(d, dtype=np.float64)
        new_prior = []
        for i, spot in enumerate(prior):
            next_spot = None
            rc = None
            if in_bounds[i]:
                j = lookup[i]
                rc = (int(_py2_round(ch[j])), int(_py2_round(cw[j])))
            else:
                # Reference parity for the out-of-precheck cases: the
                # reference gates on the SLICE SHAPE, not the origin
                # (flexlibrary.py:1224-1229) — and numpy slicing returns
                # a full-size window WRAPPED from the opposite edge when
                # the origin is far enough negative (o <= -(r+1)), which
                # that shape check passes. Replicate by doing the exact
                # slice; partial/empty shapes mean None like the
                # reference.
                oh, ow = centers[i]
                sl = frame.image[oh - search_radius:oh + search_radius + 1,
                                 ow - search_radius:ow + search_radius + 1]
                if sl.shape == (d, d):
                    w64 = np.asarray(sl, dtype=np.float64)
                    tot = w64.sum()
                    gh1 = (w64 * grid1[:, None]).sum() / tot
                    gw1 = (w64 * grid1[None, :]).sum() / tot
                    rc = (int(_py2_round((gh1 + oh) - search_radius)),
                          int(_py2_round((gw1 + ow) - search_radius)))
            if rc is not None:
                r_c_h, r_c_w = rc
                try:
                    cand = Spot(frame, r_c_h, r_c_w, spot.size,
                                gaussian_fit=None)
                except AttributeError:
                    cand = None
                else:
                    # S/N computed at the rounded centroid, on the spot's
                    # own slice (flexlibrary.py:1247).
                    if cand.illumina_s_n() < s_n_cutoff:
                        try:
                            cand = Spot(frame, int(_py2_round(spot.h)),
                                        int(_py2_round(spot.w)), spot.size,
                                        gaussian_fit=None)
                        except AttributeError:
                            cand = None
                next_spot = cand
            spot_tracks[i].append(next_spot)
            new_prior.append(next_spot if next_spot is not None else spot)
        prior = new_prior
    return spot_tracks
