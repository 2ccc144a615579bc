"""Whole-image spot detection + PSF fitting over a batch of images.

Counterpart of fluorosequencingimageanalysis_tpu/models/detect.py
(``SpotFindResult``, ``_fit_quality_core``, ``detect_and_fit_batch``):

    candidate map (kernel A) -> static candidate bucket -> 5x5 gather + LM
    fit + quality (kernel B) -> R^2 gate -> consolidation NMS

Every array has the static bucket shape (B, max_candidates) with a
validity mask, like the JAX program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.candidates import DEFAULT_CORRELATION_MATRIX, find_candidates_batch
from ..ops.consolidate import consolidate
from ..ops.fused_fit import fit_quality


class SpotFindResult(NamedTuple):
    """Static-shape detection result; every field has leading (B, K)."""
    cand_h: torch.Tensor       # int32 candidate pixel row
    cand_w: torch.Tensor       # int32 candidate pixel col
    params: torch.Tensor       # (B, K, 7) (H, A, p2, p3, sh, sw, theta)
    center_h: torch.Tensor     # fitted center row in image coords
    center_w: torch.Tensor     # fitted center col in image coords
    rmse: torch.Tensor
    r2: torch.Tensor
    s_n: torch.Tensor
    keep: torch.Tensor         # bool: passed R^2 gate + consolidation
    cand_valid: torch.Tensor   # bool: real candidate (not padding)
    cand_count: torch.Tensor   # (B,) int32 true count (overflow check)


def _fit_quality_core(images, hs, ws, num_iters, theta_starts):
    """5x5 gather -> LM fit -> quality -> image-coordinate centers for
    (B, K) candidates: kernel B on CUDA tensors, its plain twin on CPU."""
    return fit_quality(images, hs, ws, num_iters, theta_starts)


def detect_and_fit_batch(images, median_filter_size=5,
                         correlation_matrix=None, c_std=2.0,
                         r_2_threshold=0.7, consolidation_radius=4.0,
                         max_candidates=4096, num_iters=60, theta_starts=1):
    """Batched detection + fit of (B, H, W) float32 images."""
    if correlation_matrix is None:
        correlation_matrix = DEFAULT_CORRELATION_MATRIX
    hs, ws, valid, count = find_candidates_batch(
        images, median_filter_size=median_filter_size,
        correlation_matrix=np.asarray(correlation_matrix), c_std=c_std,
        max_candidates=max_candidates)
    params, center_h, center_w, rm, r2, sn = _fit_quality_core(
        images, hs, ws, num_iters, theta_starts)
    # ~(r2 < thr), not (r2 >= thr): the reference discards a fit only if
    # r_2 < threshold, so a NaN R^2 (flat saturated patch) is kept.
    passed = valid & ~(r2 < r_2_threshold)
    keep = consolidate(center_h, center_w, r2, passed,
                       radius=consolidation_radius)
    return SpotFindResult(hs, ws, params, center_h, center_w, rm, r2, sn,
                          keep, valid, count)
