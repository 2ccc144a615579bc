"""Inputs of the NMS (ops/consolidate.py) that exercise each corner of
kernel F's spatial bins and fixpoint (csrc/consolidate.cu), as numpy
arrays: ``case(name)`` returns ``(center_h, center_w, r2, valid, radius,
cand)`` with (B, N) arrays and ``cand`` None or the (cand_h, cand_w) pair
of the Monte-Carlo detector's window gate. The CPU tests run them through
the header built with g++, the card tests through the kernel, both against
the plain twin. ``HOST_NAMES`` are cases too large for the twin's O(N^2)
adjacency; the tests hold them to ``consolidate_host``.
"""

import numpy as np

F32 = np.float32


def _chains_nan_and_ties(radius):
    """tests/test_torch_ops.py's case: a rival chain under the radius, an
    exact boundary pair, NaN and tied R^2 values, invalid slots."""
    rng = np.random.default_rng(9)
    n = 96
    ch = rng.uniform(0, 30, n).astype(F32)
    cw = rng.uniform(0, 30, n).astype(F32)
    ch[:6] = F32(50.0)
    cw[:6] = np.arange(6, dtype=F32) * 3.5
    ch[6:8], cw[6:8] = F32(70.0), np.array([0.0, 4.0], F32)
    r2 = rng.uniform(0.5, 1.0, n).astype(F32)
    r2[[1, 3, 10]] = np.nan
    r2[[20, 21, 22]] = F32(0.9)
    valid = rng.uniform(size=n) > 0.15
    valid[:8] = True
    return ch[None], cw[None], r2[None], valid[None], radius, None


def _random(rng, b, n, side, nan_share=0.05, valid_share=0.85):
    ch = rng.uniform(0, side, (b, n)).astype(F32)
    cw = rng.uniform(0, side, (b, n)).astype(F32)
    r2 = rng.uniform(0.5, 1.0, (b, n)).astype(F32)
    r2[rng.uniform(size=(b, n)) < nan_share] = np.nan
    # Ties: a few R^2 levels shared by many fits.
    tie = rng.uniform(size=(b, n)) < 0.2
    r2[tie] = F32(0.75)
    valid = rng.uniform(size=(b, n)) < valid_share
    return ch, cw, r2, valid


def _uncapped_frames(rng):
    """Two dense 512x512 frames as the uncapped detection hands them to its
    NMS: 12,288 slots, three chunks of 4,096, holding 11,700 and 10,000
    candidates, the rest invalid padding (with centers and high R^2 that
    would count if the mask were ignored). Most candidates lie around
    2,000 spots a frame (~4 fits a spot), the others anywhere; the mask is
    the R^2 gate's (~6,600 fits past it in the first frame), with NaN R^2
    passing, tied scores, non-finite centers and pairs exactly the radius
    (4) apart on integer and half-integer coordinates."""
    chunk, n_chunks, radius = 4096, 3, 4.0
    n = chunk * n_chunks
    side = 512.0
    ch = rng.uniform(0, side, (2, n)).astype(F32)
    cw = rng.uniform(0, side, (2, n)).astype(F32)
    r2 = rng.uniform(0.7, 1.0, (2, n)).astype(F32)
    cand_valid = np.zeros((2, n), bool)
    for b, n_cand in enumerate((11_700, 10_000)):
        spots = rng.uniform(16, side - 16, (2000, 2))
        near = 8_000 * n_cand // 11_700
        which = rng.integers(0, 2000, near)
        pos = spots[which] + rng.normal(0, 0.4, (near, 2))
        q = np.concatenate([rng.uniform(0.6, 1.0, near),
                            rng.uniform(0.0, 0.8, n_cand - near)])
        # Extraction takes the strongest candidates first: mostly the
        # spots' in the first chunks, noise in the last.
        order = np.argsort(rng.uniform(size=n_cand) +
                           (np.arange(n_cand) >= near))
        ch[b, :near] = pos[:, 0]
        cw[b, :near] = pos[:, 1]
        ch[b, :n_cand] = ch[b, :n_cand][order]
        cw[b, :n_cand] = cw[b, :n_cand][order]
        r2[b, :n_cand] = q[order]
        cand_valid[b, :n_cand] = True
        # Tied scores: a fifth of the R^2 rounded to two places.
        tie = rng.uniform(size=n_cand) < 0.2
        r2[b, :n_cand][tie] = np.round(r2[b, :n_cand][tie], 2)
        r2[b, rng.choice(n_cand, 60, replace=False)] = np.nan
        bad = rng.choice(n_cand, 12, replace=False)
        ch[b, bad[:4]] = [np.nan, np.inf, -np.inf, np.nan]
        cw[b, bad[4:8]] = [np.inf, np.nan, -np.inf, np.inf]
        ch[b, bad[8:]] = F32(1e30)
        # Pairs exactly the radius apart, along either axis, both past
        # the gate: the lower-ranked one is suppressed only by <=.
        at = 2 * rng.choice((n_cand - 1) // 2, 40, replace=False)
        for k, i in enumerate(at):
            h0 = F32(rng.integers(20, 490) + 0.5 * (k % 2))
            w0 = F32(rng.integers(20, 490))
            dh, dw = (radius, 0.0) if k % 2 else (0.0, radius)
            ch[b, i], cw[b, i] = h0, w0
            ch[b, i + 1], cw[b, i + 1] = h0 + F32(dh), w0 + F32(dw)
            r2[b, i], r2[b, i + 1] = F32(0.95), F32(0.9)
    valid = cand_valid & ~(r2 < F32(0.7))   # the R^2 gate
    return ch, cw, r2, valid, radius, None


def case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "uncapped_frames":
        return _uncapped_frames(rng)
    if name == "chains_r4":
        return _chains_nan_and_ties(4.0)
    if name == "chains_r2.5":
        return _chains_nan_and_ties(2.5)
    if name == "dense":       # ~0.2 fits a px^2: long rival chains
        return (*_random(rng, 3, 700, 60.0), 4.0, None)
    if name == "sparse_wide":   # the box is wider than 128 cells of 4 px
        return (*_random(rng, 2, 2000, 4000.0), 4.0, None)
    if name == "strip":      # 1 px high, 3000 px wide
        ch, cw, r2, valid = _random(rng, 2, 900, 1.0)
        cw = rng.uniform(-1500, 1500, cw.shape).astype(F32)
        return ch, cw, r2, valid, 4.0, None
    if name == "one_cell":   # every fit within 2 px of every other
        return (*_random(rng, 2, 300, 2.0), 4.0, None)
    if name == "no_valid":
        ch, cw, r2, valid = _random(rng, 3, 64, 30.0)
        return ch, cw, r2, np.zeros_like(valid), 4.0, None
    if name == "no_fits":    # N == 0: images without a candidate slot
        ch, cw, r2, valid = _random(rng, 3, 0, 30.0)
        return ch, cw, r2, valid, 4.0, None
    if name == "odd_n":      # N not a multiple of the 32-thread warp
        return (*_random(rng, 5, 37, 15.0), 4.0, None)
    if name == "boundary":
        # d2 == radius^2 exactly (a 0-4 pair), one float32 step beyond,
        # and a chain of fits exactly 4 px apart, each on a cell edge.
        h = [0, 0, 10, 13, 20, 24, 40, 41.5, 60, 60, 80, 80]
        w = [0, 4, 10, 14, 20, np.nextafter(F32(0), F32(1)), 40, 42, 0,
             np.nextafter(F32(4), F32(5)), 3.99999, 8.0]
        h += list(np.arange(100, 140, 4.0))
        w += [0.0] * 10
        # 8 - (4 - 2^-22) rounds to 4.0 in float32: rivals 2 px-cells
        # apart if the cells were exactly 4 px (the grid starts at h = 0).
        h += [4 - 2.0 ** -22, 8.0]
        w += [200.0, 200.0]
        ch = np.array(h, F32)[None]
        cw = np.array(w, F32)[None]
        n = ch.shape[1]
        r2 = (0.99 - 0.01 * np.arange(n)).astype(F32)[None]
        valid = np.ones((1, n), bool)
        return ch, cw, r2, valid, 4.0, None
    if name == "boundary_r2.5":
        ch = np.array([[0, 1.5, 3.0, 10, 11.5]], F32)
        cw = np.array([[0, 2.0, 4.0, 10, 12.0]], F32)
        r2 = np.array([[0.9, 0.8, 0.95, 0.7, 0.7]], F32)
        return ch, cw, r2, np.ones((1, 5), bool), 2.5, None
    if name == "outside_and_nonfinite":
        ch, cw, r2, valid = _random(rng, 2, 200, 40.0)
        special = [-1e6, 1e6, -1e30, 1e30, 3.4e38, -3.4e38, np.inf, -np.inf,
                   np.nan, -5.0, 600.0]
        for b in range(2):
            k = len(special)
            ch[b, :k] = special
            cw[b, :k] = special[::-1]
            ch[b, k:2 * k] = special
            cw[b, k:2 * k] = F32(5.0)
            ch[b, 2 * k:3 * k] = F32(1e30)   # near-coincident far fits
            cw[b, 2 * k:3 * k] = np.arange(k, dtype=F32)
            valid[b, :3 * k] = True
        return ch, cw, r2, valid, 4.0, None
    if name == "gate":       # the Monte-Carlo detector's window gate
        n = 400
        cand_h = rng.integers(2, 40, (2, n)).astype(F32)
        cand_w = rng.integers(2, 40, (2, n)).astype(F32)
        ch = (cand_h + rng.uniform(-2.5, 2.5, (2, n))).astype(F32)
        cw = (cand_w + rng.uniform(-2.5, 2.5, (2, n))).astype(F32)
        r2 = rng.uniform(0.5, 1.0, (2, n)).astype(F32)
        valid = rng.uniform(size=(2, n)) < 0.9
        return ch, cw, r2, valid, 4.0, (cand_h, cand_w)
    if name == "tiny_cluster":
        # radius^2 underflows to 0, and so does every d2 under ~2.6e-23:
        # fits 1e-24 apart all rival, across a box 128 cells of its
        # extent / 128 would split.
        n = 30
        ch = (np.arange(n) * 1e-24).astype(F32)[None]
        cw = np.zeros((1, n), F32)
        r2 = rng.uniform(0.5, 1.0, (1, n)).astype(F32)
        return ch, cw, r2, np.ones((1, n), bool), 1e-30, None
    if name.startswith("radius_"):
        radius = float(name[len("radius_"):])
        ch, cw, r2, valid = _random(rng, 2, 150, 20.0)
        ch[:, :10] = F32(7.0)            # coincident fits
        cw[:, :10] = F32(7.0)
        ch[:, 10:20] = F32(1e30)
        cw[:, 10:20] = np.linspace(-1e30, 1e30, 10, dtype=F32)
        ch[:, 20] = np.inf
        cw[:, 21] = -np.inf
        return ch, cw, r2, valid, radius, None
    raise KeyError(name)


NAMES = ("chains_r4", "chains_r2.5", "dense", "sparse_wide", "strip",
         "one_cell", "no_valid", "odd_n", "boundary", "boundary_r2.5",
         "outside_and_nonfinite", "gate", "radius_0", "radius_1e-30",
         "radius_1e-20", "radius_nan", "radius_-4", "radius_3e19",
         "radius_1e20", "radius_1e19", "radius_1e-19", "tiny_cluster",
         "no_fits")

# Too large for the plain twin: held to consolidate_host.
HOST_NAMES = ("uncapped_frames",)
