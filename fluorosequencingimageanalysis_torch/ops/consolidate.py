"""Quality-ranked non-max suppression of competing PSF fits.

Counterpart of fluorosequencingimageanalysis_tpu/ops/consolidate.py
(``_score`` and ``consolidate``): fits whose centers lie within ``radius``
of each other are rivals, and the greedy keep-best rule (descending R^2,
lower index first on ties; NaN or invalid R^2 ranks at -inf) is evaluated
as a parallel fixpoint: an undecided fit is KEPT once no higher-priority
rival is kept or undecided, and SUPPRESSED once a higher-priority rival is
kept. ``consolidate_host`` is the same rule as a spatially binned numpy
loop, for candidate sets of any size.

``consolidate`` launches csrc/consolidate.cu (kernel F: spatial bins and
the whole fixpoint on the card, one block an image, no host read) on CUDA
tensors and runs ``consolidate_plain`` on CPU tensors. The plain twin
builds the O(N^2) rival adjacency and reads the host once per fixpoint
round (whether any fit is undecided); both give the same keep mask and
the same rounds. Counters of ``utils.profiling``: the plain twin bumps
``detect/consolidate_rounds`` by its rounds once per call; the kernel
bumps ``detect/consolidate_launches`` and hands its per-image rounds to
``profiling.bump_max``, which, while tracing is on, adds the launch's
largest at ``counters()`` (the plain twin's count where all images fit
one group) and reads nothing while it is off. A call with no image or
no fit slot launches nothing and counts nothing.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..utils import profiling

# Bound on B * N * N adjacency entries the plain twin evaluates at once
# (memory of the float distance and bool matrices).
_MAX_PAIRS = 1 << 28


def _score(r2, valid):
    """Ranking score: invalid and NaN entries map to -inf."""
    return torch.where(valid & ~torch.isnan(r2), r2,
                       torch.full_like(r2, -torch.inf))


def _consolidate_group(ch, cw, r2, v, radius, cand_h=None, cand_w=None):
    """The keep mask of one group of images, and the fixpoint rounds it
    took."""
    n = ch.shape[-1]
    idx = torch.arange(n, device=ch.device)
    d2 = ((ch[..., :, None] - ch[..., None, :]) ** 2 +
          (cw[..., :, None] - cw[..., None, :]) ** 2)
    rad2 = torch.tensor(radius, dtype=ch.dtype, device=ch.device) ** 2
    score = _score(r2, v)
    higher = ((score[..., None, :] > score[..., :, None]) |
              ((score[..., None, :] == score[..., :, None]) &
               (idx[None, :] < idx[:, None])))
    adj = (d2 <= rad2) & higher & v[..., None, :]
    del d2, higher
    if cand_h is not None:
        cheb = torch.maximum(
            (cand_h[..., :, None] - cand_h[..., None, :]).abs(),
            (cand_w[..., :, None] - cand_w[..., None, :]).abs())
        adj &= cheb <= radius + 2
        del cheb
    kept = torch.zeros_like(v)
    undecided = v.clone()
    rounds = 0
    while bool(undecided.any()):
        rounds += 1
        blocked = (adj & (kept | undecided)[..., None, :]).any(dim=-1)
        new_kept = undecided & ~blocked
        suppressed = undecided & (adj & kept[..., None, :]).any(dim=-1)
        kept = kept | new_kept
        undecided = undecided & ~new_kept & ~suppressed
    return kept, rounds


def consolidate_plain(centers_h, centers_w, r2, valid, radius=4.0,
                      cand_h=None, cand_w=None):
    """The plain PyTorch twin of :func:`consolidate`, on any device:
    leading axes are processed in groups that bound the adjacency's
    memory, and the rounds summed over the groups are bumped once a call
    under ``detect/consolidate_rounds``."""
    lead = centers_h.shape[:-1]
    n = centers_h.shape[-1]
    arrays = (centers_h, centers_w, r2, valid)
    if cand_h is not None:
        arrays += (cand_h, cand_w)
    B = math.prod(lead)
    flat = [a.reshape(B, n) for a in arrays]
    group = max(1, _MAX_PAIRS // max(n * n, 1))
    parts = []
    rounds = 0
    for lo in range(0, B, group):
        sl = [a[lo:lo + group] for a in flat]
        kept, r = _consolidate_group(*sl[:4], radius, *sl[4:])
        parts.append(kept)
        rounds += r
    profiling.bump("detect/consolidate_rounds", rounds)
    keep = torch.cat(parts) if parts else torch.zeros_like(flat[3])
    return keep.reshape(*lead, n)


def _launch(arrays, radius):
    from .. import _build
    fn = _build.load("consolidate").consolidate_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 +
                   [ctypes.c_double] + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    lead, n = arrays[0].shape[:-1], arrays[0].shape[-1]
    B = math.prod(lead)
    flat = [a.reshape(B, n).contiguous() for a in arrays]
    gated = len(flat) == 6
    dev = flat[0].device
    keep = torch.empty((B, n), dtype=torch.bool, device=dev)
    if B == 0 or n == 0:   # nothing to launch, and nothing counted
        return keep.reshape(*lead, n)
    rounds = torch.empty((B,), dtype=torch.int32, device=dev)
    sorted_ = torch.empty((B, 5 if gated else 3, n), dtype=torch.float32,
                          device=dev)
    order = torch.empty((B, n), dtype=torch.int32, device=dev)
    state = torch.empty((B, 2, n), dtype=torch.uint8, device=dev)
    ptrs = [a.data_ptr() for a in flat] + [None] * (6 - len(flat))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*ptrs, B, n, float(radius), sorted_.data_ptr(),
                 order.data_ptr(), state.data_ptr(), keep.data_ptr(),
                 rounds.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"consolidate kernel launch failed: CUDA error "
                           f"{err}")
    consolidate.launches += 1
    profiling.bump("detect/consolidate_launches")
    profiling.bump_max("detect/consolidate_rounds", rounds)
    return keep.reshape(*lead, n)


def consolidate(centers_h, centers_w, r2, valid, radius=4.0, cand_h=None,
                cand_w=None):
    """Greedy quality-ranked NMS over the last axis.

    centers_h, centers_w, r2: (..., N) floats; valid: (..., N) bool
    (invalid entries never compete and are never kept). Rivals are pairs at
    Euclidean distance <= radius (inclusive). cand_h, cand_w: optional
    (..., N) candidate pixel coordinates; with them, rivals must also lie
    within a Chebyshev window of radius + 2 of each other's candidate
    pixels, the only pairs the reference compares (pflib.py:491-495). The
    Monte-Carlo fitter needs the gate: its centers drift up to ~2.5 px from
    their candidates. Returns the (..., N) bool keep mask; leading axes are
    independent images. CUDA tensors go through kernel F (float32 centers,
    R^2 and candidate pixels, one launch for all images); CPU tensors
    through ``consolidate_plain``.
    """
    if (cand_h is None) != (cand_w is None):
        raise ValueError("consolidate: give both cand_h and cand_w or "
                         "neither")
    if centers_h.device.type == "cpu":
        return consolidate_plain(centers_h, centers_w, r2, valid, radius,
                                 cand_h, cand_w)
    arrays = (centers_h, centers_w, r2, valid)
    if cand_h is not None:
        arrays += (cand_h, cand_w)
    if centers_h.device.type != "cuda":
        raise ValueError(f"consolidate: unsupported device "
                         f"{centers_h.device}")
    if any(a.shape != centers_h.shape for a in arrays) or \
            centers_h.ndim == 0:
        raise ValueError(f"consolidate: inputs of one (..., N) shape "
                         f"required, got {[tuple(a.shape) for a in arrays]}")
    if any(a.device != centers_h.device for a in arrays):
        raise ValueError("consolidate: inputs must share a device")
    floats = [a for i, a in enumerate(arrays) if i != 3]
    if any(a.dtype != torch.float32 for a in floats):
        raise TypeError(f"consolidate: float32 centers, R^2 and candidate "
                        f"pixels required on the card, got "
                        f"{[a.dtype for a in floats]}")
    if valid.dtype != torch.bool:
        raise TypeError(f"consolidate: bool valid required, got "
                        f"{valid.dtype}")
    return _launch(arrays, radius)


consolidate.launches = 0


def consolidate_host(centers_h, centers_w, r2, valid, radius=4.0):
    """NumPy greedy NMS with the output of :func:`consolidate`, for
    candidate sets larger than one device bucket (the exhaustive chunked
    detect path, models/detect.detect_and_fit_exhaustive). The JAX
    package's ``consolidate_host``, line for line.

    Spatial binning (cell = radius, 3x3 neighbourhood probe of kept spots)
    makes it O(N x rivals) instead of O(N^2). Distances are computed in
    the centers' own float dtype, like :func:`consolidate` (which compares
    in ``ch.dtype``), so boundary cases (d^2 == radius^2 exactly) cannot
    diverge for float32 or float64 inputs.
    """
    dt = (np.float64 if np.asarray(centers_h).dtype == np.float64
          else np.float32)
    ch = np.asarray(centers_h, dt)
    cw = np.asarray(centers_w, dt)
    r2a = np.asarray(r2, dt)
    v = np.asarray(valid, bool)
    n = ch.shape[0]
    score = np.where(v & ~np.isnan(r2a), r2a, -np.inf)
    order = np.argsort(-score, kind="stable")
    keep = np.zeros(n, bool)
    rad2 = dt(float(radius)) ** 2
    cell = max(float(radius), 1e-6)
    grid: dict = {}
    for i in order:
        if not v[i]:
            # Invalids rank last and are never kept; stable argsort keeps
            # the remaining iteration order identical to the device rank.
            continue
        hi, wi = ch[i], cw[i]
        if not (np.isfinite(hi) and np.isfinite(wi)):
            # NaN/inf-centered fits: every distance comparison is False on
            # device (NaN <= r^2 is False), so they never rival anything —
            # kept if valid, and never suppress others.
            keep[i] = True
            continue
        bh = int(np.floor(hi / cell))
        bw = int(np.floor(wi / cell))
        rival = False
        for dh in (-1, 0, 1):
            if rival:
                break
            for dw in (-1, 0, 1):
                for j in grid.get((bh + dh, bw + dw), ()):
                    d2 = (hi - ch[j]) ** 2 + (wi - cw[j]) ** 2
                    if d2 <= rad2:
                        rival = True
                        break
                if rival:
                    break
        if not rival:
            keep[i] = True
            grid.setdefault((bh, bw), []).append(i)
    return keep
