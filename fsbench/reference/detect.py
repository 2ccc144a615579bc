"""Batched detection and fit of (B, H, W) float32 images, in plain torch.

Frozen copy of the plain path of the port's detection: the candidate
bucket (``candidates._threshold_and_extract_batch``), the 5x5 gather, LM fit and
fit quality (the plain twin of kernel B), the R^2 gate and the NMS
(``consolidate``); and ``pack_spot_buckets``, the keep-first compaction of
``run_zstack(lean=True)``.

``lowp`` rounds the float tensors that leave a stage (the candidate maps
and every fitted value); the reference passes the identity, the control of
``correct`` a rounding to bfloat16.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .candidates import (DEFAULT_CORRELATION_MATRIX,
                         _threshold_and_extract_batch, correlation_maps,
                         gather_patches)
from .consolidate import consolidate
from .gaussian import gauss2d_image
from .lm import fit_gaussians_batched
from .quality import illumina_s_n, r_squared, rmse


def identity(x):
    return x


class SpotFindResult(NamedTuple):
    cand_h: torch.Tensor
    cand_w: torch.Tensor
    params: torch.Tensor
    center_h: torch.Tensor
    center_w: torch.Tensor
    rmse: torch.Tensor
    r2: torch.Tensor
    s_n: torch.Tensor
    keep: torch.Tensor
    cand_valid: torch.Tensor
    cand_count: torch.Tensor


def candidate_maps(images, median_filter_size=5, lowp=identity):
    kernel = torch.as_tensor(DEFAULT_CORRELATION_MATRIX, dtype=images.dtype,
                             device=images.device)
    return lowp(correlation_maps(images, median_filter_size, kernel))


def fit_quality_plain(images, hs, ws, num_iters, theta_starts=1):
    """(params (B, K, 7), center_h, center_w, rmse, r2, s_n (B, K))."""
    B, K = hs.shape
    flat = gather_patches(images, hs, ws, radius=2).reshape(B * K, 5, 5)
    params, _cost = fit_gaussians_batched(flat, num_iters=num_iters,
                                          theta_starts=theta_starts)
    fit_imgs = gauss2d_image(params, (5, 5), dtype=images.dtype)
    r2 = r_squared(flat, fit_imgs).reshape(B, K)
    rm = rmse(flat, fit_imgs).reshape(B, K)
    sn = illumina_s_n(flat).reshape(B, K)
    params = params.reshape(B, K, 7)
    center_h = params[:, :, 2] + hs.to(params.dtype) - 2.5
    center_w = params[:, :, 3] + ws.to(params.dtype) - 2.5
    return params, center_h, center_w, rm, r2, sn


def detect_and_fit_batch(images, median_filter_size=5, c_std=2.0,
                         r_2_threshold=0.7, consolidation_radius=4.0,
                         max_candidates=4096, num_iters=60, theta_starts=1,
                         lowp=identity):
    """Batched detection + fit of (B, H, W) float32 images."""
    cms = candidate_maps(images, median_filter_size, lowp)
    hs, ws, valid, count = _threshold_and_extract_batch(
        cms, max_candidates, float(c_std))
    del cms
    params, center_h, center_w, rm, r2, sn = (
        lowp(t) for t in fit_quality_plain(images, hs, ws, num_iters,
                                           theta_starts))
    # A NaN R^2 (flat saturated patch) passes the gate, as in the
    # reference, which discards a fit only if r_2 < threshold.
    passed = valid & ~(r2 < r_2_threshold)
    keep = consolidate(center_h, center_w, r2, passed,
                       radius=consolidation_radius)
    return SpotFindResult(hs, ws, params, center_h, center_w, rm, r2, sn,
                          keep, valid, count)


def candidate_counts(images, median_filter_size=5, c_std=2.0):
    """(B,) int64 number of above-threshold candidate pixels per image."""
    cms = candidate_maps(images, median_filter_size)
    _, _, _, count = _threshold_and_extract_batch(cms, 1, float(c_std))
    return count.to(torch.int64)


def pack_spot_buckets(res: SpotFindResult, max_spots: int):
    """Keep-first compaction: each image's slots ordered kept-first
    (stable, so kept spots keep candidate order) and cut to
    ``max_spots``. Returns the SpotFindResult field dict of host numpy
    arrays, spot-major, plus ``spot_count`` (exact keep totals) and
    ``cand_count``."""
    order = torch.argsort((~res.keep).to(torch.int8), dim=1,
                          stable=True)[:, :max_spots]

    def take(a):
        return torch.gather(a, 1, order).cpu().numpy()

    out = {name: take(getattr(res, name)) for name in (
        "cand_h", "cand_w", "center_h", "center_w", "rmse", "r2", "s_n",
        "keep", "cand_valid")}
    out["params"] = torch.gather(
        res.params, 1, order[..., None].expand(-1, -1, 7)).cpu().numpy()
    out["spot_count"] = res.keep.sum(dim=1, dtype=torch.int32).cpu().numpy()
    out["cand_count"] = res.cand_count.cpu().numpy()
    return out


def bf16(x):
    """``x`` rounded to bfloat16 and back, for float tensors (the
    control's precision); other tensors pass."""
    if torch.is_tensor(x) and x.dtype in (torch.float32, torch.float64):
        return x.to(torch.bfloat16).to(x.dtype)
    return x
