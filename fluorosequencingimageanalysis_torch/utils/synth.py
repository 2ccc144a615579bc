"""Synthetic experiment stacks with planted Gaussian spots.

Seven recipes of the repo's benchmark (bench.py):

- ``make_stack`` (bench.py::make_stack, the headline step): background
  N(400, 8), ``spots_per_field`` spots per field at integer pixel centers
  at least 8 px from the border, amplitudes U(1500, 4000), sigma 1.3, each
  spot drawn on a 13x13 support and repeated in every cycle of its field;
- ``make_experiment_stack`` (bench.py::make_experiment_stack, config 4,
  the full experiment): background N(400, 6), persistent spots at
  subpixel centers at least 16 px from the border, amplitudes
  U(2000, 5000), present in each later cycle with probability 0.85, and an
  integer stage drift of -2..2 px per cycle shared by every field;
- ``make_zstack`` (bench.py::make_zstack, config 2, the z/time stack): one
  field of persistent spots at subpixel centers, amplitudes U(1500, 4000),
  on a sloped background with a broad bump that breathes by 5% over the
  frames, noise N(0, 6), emitted as raw uint16 camera frames;
- ``make_step_traces`` (bench.py::make_step_traces, config 3, batched step
  fitting): photometry traces with 1-4 planted photobleaching steps of
  ``beta`` under N(0, noise);
- ``make_chisq_traces`` (the traces of bench.py::bench_chisq): 0-3 planted
  steps of 2500 under N(0, 300);
- ``make_movie`` (bench.py::make_movie, the timetrace movie): spots that
  bleach to the background in 1-3 steps of ``beta`` while wandering by a
  subpixel random walk, on N(400, 6), emitted as raw uint16 frames;
- ``make_v8_workload`` (bench.py::make_v8_workload, config 5, fluor
  counting): lognormal intensity ladders that lose a fluor with
  probability 0.25 per cycle.

Each returns its bench.py arrays, drawn with the same random calls in the
same order, and on request the planted truth beside them.
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


def make_experiment_stack(F, C, H=512, W=512, spots_per_field=2000, seed=0,
                          return_truth=False):
    """Multi-cycle experiment: persistent spots with per-cycle dropouts and
    integer stage drift (the config-4 workload). Returns the [F, C, H, W]
    float32 stack; with ``return_truth`` also the planted positions
    [F, n, 2] (float32, in cycle 0's frame), their presence [F, n, C]
    (bool) and the cumulative drift [C, 2] (cycle c shows a spot planted
    at p at p - drift[c])."""
    rng = np.random.default_rng(seed)
    hh, ww = np.indices((H, W)).astype(np.float32)
    drift = np.cumsum([[0, 0]] + [[int(rng.integers(-2, 3)),
                                   int(rng.integers(-2, 3))]
                                  for _ in range(C - 1)], axis=0)
    stack = rng.normal(400.0, 6.0, (F, C, H, W)).astype(np.float32)
    positions = np.zeros((F, spots_per_field, 2), np.float32)
    presence = np.zeros((F, spots_per_field, C), bool)
    for f in range(F):
        pos = rng.uniform(16, H - 16, (spots_per_field, 2)).astype(np.float32)
        amp = rng.uniform(2000, 5000, spots_per_field).astype(np.float32)
        present = rng.random((spots_per_field, C)) < 0.85
        present[:, 0] = True
        positions[f], presence[f] = pos, present
        for c in range(C):
            hp = pos[present[:, c], 0] - drift[c, 0]
            wp = pos[present[:, c], 1] - drift[c, 1]
            ap = amp[present[:, c]]
            field = np.zeros((H, W), np.float32)
            for h, w, a in zip(hp, wp, ap):
                lo_h, hi_h = max(0, int(h) - 6), min(H, int(h) + 7)
                lo_w, hi_w = max(0, int(w) - 6), min(W, int(w) + 7)
                field[lo_h:hi_h, lo_w:hi_w] += a * np.exp(
                    -(((hh[lo_h:hi_h, lo_w:hi_w] - h) ** 2) +
                      ((ww[lo_h:hi_h, lo_w:hi_w] - w) ** 2)) / (2 * 1.3 ** 2))
            stack[f, c] += field
    if return_truth:
        return stack, positions, presence, drift
    return stack


def make_zstack(T=32, H=512, W=512, n_spots=800, seed=4, return_truth=False):
    """The config-2 workload: [T, H, W] uint16 frames of one field; with
    ``return_truth`` also the planted centers [n_spots, 2] (float32)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.indices((H, W)).astype(np.float32)
    base = (600 + 0.4 * yy + 0.25 * xx
            + 120 * np.exp(-(((yy - 200) ** 2 + (xx - 300) ** 2)
                             / (2 * 150.0 ** 2))))
    pos = rng.uniform(16, H - 16, (n_spots, 2)).astype(np.float32)
    amp = rng.uniform(1500, 4000, n_spots).astype(np.float32)
    field = np.zeros((H, W), np.float32)
    for h, w, a in zip(pos[:, 0], pos[:, 1], amp):
        lo_h, hi_h = max(0, int(h) - 6), min(H, int(h) + 7)
        lo_w, hi_w = max(0, int(w) - 6), min(W, int(w) + 7)
        field[lo_h:hi_h, lo_w:hi_w] += a * np.exp(
            -(((yy[lo_h:hi_h, lo_w:hi_w] - h) ** 2) +
              ((xx[lo_h:hi_h, lo_w:hi_w] - w) ** 2)) / (2 * 1.3 ** 2))
    stack = np.empty((T, H, W), np.float32)
    for t in range(T):
        stack[t] = (base * (1.0 + 0.05 * np.sin(t / 4.0)) + field
                    + rng.normal(0, 6, (H, W)))
    stack = np.clip(stack, 0, 65535).astype(np.uint16)
    return (stack, pos) if return_truth else stack


def make_step_traces(N, T, seed=0, beta=30000.0, noise=800.0,
                     return_truth=False):
    """N timetrace photometry traces of length T with 1-4 planted
    photobleaching steps (the basic_timetrace_script workload): an (N, T)
    float64 array; with ``return_truth`` also the list of each trace's
    sorted drop frames."""
    rng = np.random.default_rng(seed)
    levels = rng.integers(1, 5, N)
    traces = np.empty((N, T))
    truth = []
    for i in range(N):
        drops = np.sort(rng.choice(np.arange(5, T - 5), levels[i],
                                   replace=False))
        truth.append(drops.tolist())
        value = beta * (levels[i] + 1)
        trace = np.full(T, value)
        for d in drops:
            value -= beta
            trace[d:] = value
        traces[i] = trace + rng.normal(0, noise, T)
    return (traces, truth) if return_truth else traces


def make_chisq_traces(N, T, seed=0):
    """(N, T) float64 traces with 0-3 planted downward steps of 2500 under
    N(0, 300): the chi-squared fitter's benchmark input."""
    rng = np.random.default_rng(seed)
    traces = np.zeros((N, T))
    for i in range(N):
        nsteps = int(rng.integers(0, 4))
        drops = np.sort(rng.choice(np.arange(4, T - 4), nsteps,
                                   replace=False))
        level = float(nsteps + 1)
        tr = np.full(T, level)
        for d in drops:
            level -= 1.0
            tr[d:] = level
        traces[i] = tr * 2500 + rng.normal(0, 300, T)
    return traces


def make_movie(T=24, H=512, W=512, n_spots=800, seed=0, beta=2500.0,
               return_truth=False):
    """A timetrace movie: n_spots bleaching spots with subpixel wander (the
    basic_timetrace_script workload), as [T, H, W] raw uint16 camera
    frames. With ``return_truth`` also a dict: "positions" [n_spots, T, 2]
    (float64 planted centers, NaN once the spot has bleached out),
    "levels" [n_spots, T] (dye count per frame, 0 once bleached out) and
    "drops" (each spot's sorted drop frames)."""
    rng = np.random.default_rng(seed)
    movie = rng.normal(400.0, 6.0, (T, H, W)).astype(np.float32)
    pos = rng.uniform(12, H - 12, (n_spots, 2))
    steps = rng.integers(1, 4, n_spots)
    hh, ww = np.indices((25, 25)).astype(np.float32)
    positions = np.full((n_spots, T, 2), np.nan)
    levels = np.zeros((n_spots, T))
    all_drops = []
    for s in range(n_spots):
        drops = np.sort(rng.choice(np.arange(4, T - 2), steps[s],
                                   replace=False)).tolist()
        all_drops.append(list(drops))
        level = float(steps[s])
        wander = rng.normal(0, 0.08, (T, 2)).cumsum(axis=0)
        for f in range(T):
            if drops and f >= drops[0]:
                level -= 1.0
                drops = drops[1:]
            if level <= 0:
                break
            h = pos[s, 0] + wander[f, 0]
            w = pos[s, 1] + wander[f, 1]
            positions[s, f] = h, w
            levels[s, f] = level
            ih = min(max(int(h) - 12, 0), H - 25)
            iw = min(max(int(w) - 12, 0), W - 25)
            movie[f, ih:ih + 25, iw:iw + 25] += level * beta * np.exp(
                -(((hh - (h - ih)) ** 2) + ((ww - (w - iw)) ** 2)) /
                (2 * 1.3 ** 2))
    movie = np.clip(movie, 0, 65535).astype(np.uint16)
    if return_truth:
        return movie, {"positions": positions, "levels": levels,
                       "drops": all_drops}
    return movie


def zstack_peaks(out):
    """Image coordinates (row, col) of every slot's fitted PSF peak in a
    run_zstack result (full or lean schema): [T, K] float64 arrays. The
    conventions are :func:`model_peaks`'s: the peak is at
    (cand_h + p3 - 2, cand_w + p2 - 2)."""
    p = out["params"].astype(np.float64)
    return (out["cand_h"] + p[..., 3] - 2.0, out["cand_w"] + p[..., 2] - 2.0)


def zstack_recall(pos, out, tol=1.0):
    """Per frame, the share of planted centers ``pos`` [n, 2] with a kept
    fit whose PSF peak lies within ``tol`` px: a [T] float array."""
    rows, cols = zstack_peaks(out)
    shares = np.zeros(len(rows))
    for t in range(len(rows)):
        k = out["keep"][t]
        kept = np.stack([rows[t][k], cols[t][k]], 1)
        shares[t] = np.mean(_nearest(pos.astype(np.float64), kept) <= tol)
    return shares


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


def _nearest(a, b):
    """Distance from each point of a [n, 2] to its nearest point of b."""
    if len(b) == 0:
        return np.full(len(a), np.inf)
    out = np.empty(len(a))
    for lo in range(0, len(a), 512):
        d2 = ((a[lo:lo + 512, None, :] - b[None, :, :]) ** 2).sum(-1)
        out[lo:lo + 512] = np.sqrt(d2.min(axis=1))
    return out


def experiment_recovery(rows, step_out, positions, presence, drift,
                        tol=1.0):
    """How much of ``make_experiment_stack``'s truth a run_experiment
    recovers, for one channel.

    Reported positions (row H/W, spot_rh/spot_rw) keep the reference's
    ``p + h - 2.5`` half-pixel shift, so a spot planted at (r, c) is
    reported within about a pixel of (r - 0.5, c - 0.5) in its cycle's
    frame. ``step_out`` holds the step's spot_rh, spot_rw and spot_state
    [F, C, S] for the same stack (run_stack). Returns:

    - planted_every_cycle: spots present in every cycle;
    - recovered: the share of those with an all-ones row within ``tol``;
    - detected_every_cycle: those the step kept within ``tol`` in every
      cycle (after undoing the drift);
    - recovered_of_detected: the share of those with an all-ones row
      within ``tol`` (what tracking and fill-in owe the detector);
    - image_recall: the share of (planted, cycle) pairs the step kept
      within ``tol``.
    """
    F, n, C = presence.shape
    ref = positions.astype(np.float64) - 0.5
    planted = detected = recovered = recovered_det = 0
    pairs = pairs_hit = 0
    for f in range(F):
        every = presence[f].all(axis=1)
        det_every = every.copy()
        for c in range(C):
            st = step_out["spot_state"][f, c] == 2
            kept = np.stack([step_out["spot_rh"][f, c][st],
                             step_out["spot_rw"][f, c][st]], 1)
            near = _nearest(ref[f] - drift[c], kept.astype(np.float64)) <= tol
            det_every &= near
            pairs += int(presence[f][:, c].sum())
            pairs_hit += int((near & presence[f][:, c]).sum())
        ones = np.array([(r[2], r[3]) for r in rows
                         if r[1] == f and all(r[4])], np.float64)
        hit = _nearest(ref[f], ones.reshape(-1, 2)) <= tol
        planted += int(every.sum())
        recovered += int((hit & every).sum())
        detected += int(det_every.sum())
        recovered_det += int((hit & det_every).sum())
    return {"planted_every_cycle": planted,
            "recovered": recovered / max(planted, 1),
            "detected_every_cycle": detected,
            "recovered_of_detected": recovered_det / max(detected, 1),
            "image_recall": pairs_hit / max(pairs, 1)}


def make_v8_workload(T, F=12, K=5, beta=30000.0, beta_sigma=0.2, seed=0):
    """T synthetic traces at the reference's cost-warning shape
    (n_cycles=12, max_fluors=5 -> C(17, 12) = 6188 sequences/trace,
    MCsimlib.py:5426-5466). Returns (intensities (T, F) float64,
    categories (T, F) bool, log_fluor_means (K,))."""
    rng = np.random.default_rng(seed)
    start = rng.integers(1, K + 1, T)
    counts = np.zeros((T, F), np.int64)
    counts[:, 0] = start
    for c in range(1, F):
        drop = rng.random(T) < 0.25
        counts[:, c] = np.maximum(counts[:, c - 1] - drop, 0)
    z = rng.normal(0, 1, (T, F))
    intensities = np.where(
        counts > 0, np.exp(np.log(beta * np.maximum(counts, 1)) +
                           beta_sigma * z), 0.0)
    categories = counts > 0
    lfm = np.log(beta * np.arange(1, K + 1))
    return intensities, categories, lfm


def make_gmm_photometries(T, F=12, K=5, off_mean=2000.0, off_sigma=300.0,
                          rows_per_field=1000, seed=0):
    """A photometries dict {"ch1": {field: {(h, w): (categories,
    intensities, row)}}} of T traces of F cycles: ``make_v8_workload``'s
    fluor-count ladders, each OFF frame drawn from N(off_mean,
    off_sigma^2) instead of an exact 0 (exact zeros would collapse a
    mixture component onto the variance floor), ``rows_per_field`` traces
    a field. The per-cycle mixture fit's input (``Pipeline.per_cycle_gmm``);
    the OFF draws come from one generator seeded with ``seed``."""
    intensities, categories, _ = make_v8_workload(T, F=F, K=K, seed=seed)
    rng = np.random.default_rng(seed)
    off = rng.normal(off_mean, off_sigma, (T, F))
    intensities = np.where(categories, intensities, off)
    photometries = {"ch1": {}}
    for t in range(T):
        field, row = divmod(t, rows_per_field)
        photometries["ch1"].setdefault(field, {})[(row, field)] = (
            tuple(categories[t].tolist()), tuple(intensities[t].tolist()),
            t)
    return photometries
