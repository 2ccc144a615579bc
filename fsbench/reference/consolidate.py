"""Quality-ranked non-max suppression of competing PSF fits.

A frozen copy of the port's ops/consolidate.py (``_score`` and
``consolidate``): fits whose centers lie within ``radius``
of each other are rivals, and the greedy keep-best rule (descending R^2,
lower index first on ties; NaN or invalid R^2 ranks at -inf) is evaluated
as a parallel fixpoint over the rival adjacency: an undecided fit is KEPT
once no higher-priority rival is kept or undecided, and SUPPRESSED once a
higher-priority rival is kept.
"""

from __future__ import annotations

import numpy as np
import torch

# Bound on B * N * N adjacency entries evaluated at once (memory of the
# float distance and bool matrices).
_MAX_PAIRS = 1 << 28


def _score(r2, valid):
    """Ranking score: invalid and NaN entries map to -inf."""
    return torch.where(valid & ~torch.isnan(r2), r2,
                       torch.full_like(r2, -torch.inf))


def _consolidate_group(ch, cw, r2, v, radius, cand_h=None, cand_w=None):
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
    while bool(undecided.any()):
        blocked = (adj & (kept | undecided)[..., None, :]).any(dim=-1)
        new_kept = undecided & ~blocked
        suppressed = undecided & (adj & kept[..., None, :]).any(dim=-1)
        kept = kept | new_kept
        undecided = undecided & ~new_kept & ~suppressed
    return kept


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
    their candidates. Returns the (..., N) bool keep mask. Leading axes are
    independent images, processed in groups that bound the adjacency's
    memory.
    """
    lead = centers_h.shape[:-1]
    n = centers_h.shape[-1]
    arrays = (centers_h, centers_w, r2, valid)
    if cand_h is not None:
        arrays += (cand_h, cand_w)
    flat = [a.reshape(-1, n) for a in arrays]
    B = flat[0].shape[0]
    group = max(1, _MAX_PAIRS // max(n * n, 1))
    parts = []
    for lo in range(0, B, group):
        sl = [a[lo:lo + group] for a in flat]
        parts.append(_consolidate_group(*sl[:4], radius, *sl[4:]))
    keep = torch.cat(parts) if parts else torch.zeros_like(flat[3])
    return keep.reshape(*lead, n)


