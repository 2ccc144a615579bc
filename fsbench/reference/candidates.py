"""Candidate-pixel detection: median filter, template correlation, threshold.

A frozen copy of the port's plain ops/candidates.py (the batch
extraction and the patch gathers). The reference algorithm (pflib.find_peptides steps 1-2):

1. background removal ``image - min(median_filter(image, k), image)`` with
   scipy's 'reflect' boundary, which is numpy's 'symmetric' padding (the
   edge pixel repeats). ``torch.nn.functional.pad(mode="reflect")`` is
   numpy's 'reflect' and drops the edge pixel, so the padding here is built
   by index;
2. zero-padded 'same' cross-correlation with the 5x5 template, clipped at 0;
3. pixels with ``cm >= mean + c_std * std`` (population std) that lie at
   least 2 px inside the border are candidates, extracted into a static
   ``max_candidates`` bucket in descending score order with ties broken by
   the lower flat index (``lax.top_k``'s order).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Empirical 5x5 PSF correlation template (pflib.py:48-52 of the reference).
DEFAULT_CORRELATION_MATRIX = np.array(
    [[-5935, -5935, -5935, -5935, -5935],
     [-5935,  8027,  8027,  8027, -5935],
     [-5935,  8027, 30742,  8027, -5935],
     [-5935,  8027,  8027,  8027, -5935],
     [-5935, -5935, -5935, -5935, -5935]], dtype=np.float64)


def symmetric_index(n: int, lo: int, hi: int, device=None):
    """Source indices of numpy 'symmetric' padding of an axis of length n
    by ``lo`` before and ``hi`` after (the edge sample repeats; pads wider
    than the axis keep reflecting)."""
    i = torch.arange(-lo, n + hi, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def pad_symmetric(images, lo: int, hi: int):
    """Pad the last two axes of ``images`` symmetrically by (lo, hi)."""
    h, w = images.shape[-2:]
    ih = symmetric_index(h, lo, hi, images.device)
    iw = symmetric_index(w, lo, hi, images.device)
    return images[..., ih[:, None], iw[None, :]]


def median_filter_2d(images, size: int):
    """Square median filter over the last two axes, scipy conventions.

    Even sizes put the extra tap on the negative side and take the upper
    median (scipy's rank filter at rank n//2); odd sizes are the ordinary
    centered median.
    """
    r_lo = size // 2
    r_hi = (size - 1) // 2
    padded = pad_symmetric(images, r_lo, r_hi)
    h, w = images.shape[-2:]
    views = [padded[..., i:i + h, j:j + w]
             for i in range(size) for j in range(size)]
    stacked = torch.stack(views, dim=0)
    return torch.sort(stacked, dim=0).values[(size * size) // 2]


def correlate_2d_same(images, kernel):
    """Zero-padded 'same' 2D cross-correlation over the last two axes
    (scipy.signal.correlate mode='same'; XLA's SAME padding for even
    kernels puts the extra row/column after)."""
    kh, kw = kernel.shape
    lead = images.shape[:-2]
    x = images.reshape(-1, 1, *images.shape[-2:])
    x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    out = F.conv2d(x, kernel.to(images.dtype)[None, None])
    return out.reshape(*lead, *out.shape[-2:])


def correlation_maps(images, median_filter_size, kernel):
    """``max(correlate(image - min(med(image), image), kernel), 0)``."""
    med = median_filter_2d(images, median_filter_size)
    image_mf = images - torch.minimum(med, images)
    return torch.clamp_min(correlate_2d_same(image_mf, kernel), 0.0)


def _interior(h, w, device):
    hh = torch.arange(h, device=device)[:, None]
    ww = torch.arange(w, device=device)[None, :]
    return (hh >= 2) & (hh < h - 2) & (ww >= 2) & (ww < w - 2)


def _candidate_mask_batch(cms, c_std):
    """``cm >= mean + c_std * std`` per image (population std), 2-px
    border excluded."""
    _, h, w = cms.shape
    mean = torch.mean(cms, dim=(1, 2), keepdim=True)
    std = torch.std(cms, dim=(1, 2), keepdim=True, correction=0)
    return (cms >= mean + c_std * std) & _interior(h, w, cms.device)


def topk_lowest_index(scores, k):
    """``lax.top_k`` over the last axis: the k largest values, ties in
    ascending index order (a stable descending sort; ``torch.topk``
    promises no tie order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _threshold_and_extract_batch(cms, max_candidates, c_std):
    """Static-shape candidate bucket from (B, H, W) correlation maps.

    Returns (hs, ws, valid, count): (B, K) int32 coordinates (padding slots
    point at (2, 2) so patch gathers stay in bounds), (B, K) bool and (B,)
    int32 true counts (may exceed K).
    """
    B, h, w = cms.shape
    mask = _candidate_mask_batch(cms, c_std)
    flat = torch.where(mask, cms, -torch.inf).reshape(B, -1)
    count = mask.reshape(B, -1).sum(dim=1, dtype=torch.int32)
    k = min(max_candidates, flat.shape[1])
    top_scores, top_idx = topk_lowest_index(flat, k)
    short = max_candidates - k
    if short > 0:
        top_scores = F.pad(top_scores, (0, short), value=-torch.inf)
        top_idx = F.pad(top_idx, (0, short))
    valid = top_scores > -torch.inf
    hs = torch.where(valid, top_idx // w, 2).to(torch.int32)
    ws = torch.where(valid, top_idx % w, 2).to(torch.int32)
    return hs, ws, valid, count


def _jax_index(i, n, hi):
    """JAX's rule for an index into an axis of length n: a negative index
    counts from the end (numpy style), then the result is clamped to
    [0, hi]."""
    return torch.where(i < 0, i + n, i).clamp(0, hi)


def gather_patches(image, hs, ws, radius=2):
    """(..., N, 2r+1, 2r+1) patches centered at (hs, ws).

    image (H, W) with hs/ws (N,), or a batch (B, H, W) with hs/ws (B, N).
    Callers keep centers ``radius`` from every edge; an index outside the
    image follows the JAX gather (negative wraps once, then clamps).
    """
    d = torch.arange(-radius, radius + 1, device=image.device)
    h, w = image.shape[-2:]
    rows = _jax_index(hs.long()[..., None, None] + d[:, None], h, h - 1)
    cols = _jax_index(ws.long()[..., None, None] + d[None, :], w, w - 1)
    if image.ndim == 2:
        return image[rows, cols]
    b = torch.arange(image.shape[0], device=image.device)[:, None, None,
                                                          None]
    return image[b, rows, cols]


def gather_patches_dynslice(image, hs, ws, radius):
    """(..., N, 2r+1, 2r+1) windows with ``lax.dynamic_slice`` semantics:
    a negative start counts from the end, then a window that would cross
    the border is shifted inside it whole. Shapes as in
    :func:`gather_patches`."""
    size = 2 * radius + 1
    h, w = image.shape[-2:]
    d = torch.arange(size, device=image.device)
    rows = _jax_index(hs.long() - radius, h, h - size)[..., None, None] + \
        d[:, None]
    cols = _jax_index(ws.long() - radius, w, w - size)[..., None, None] + \
        d[None, :]
    if image.ndim == 2:
        return image[rows, cols]
    b = torch.arange(image.shape[0], device=image.device)[:, None, None,
                                                          None]
    return image[b, rows, cols]
