"""Inputs of the NMS (ops/consolidate.py) that exercise each corner of
kernel F's spatial bins and fixpoint (csrc/consolidate.cu), as numpy
arrays: ``case(name)`` returns ``(center_h, center_w, r2, valid, radius,
cand)`` with (B, N) arrays and ``cand`` None or the (cand_h, cand_w) pair
of the Monte-Carlo detector's window gate. The CPU tests run them through
the header built with g++, the card tests through the kernel, both against
the plain twin.
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


def case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
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
