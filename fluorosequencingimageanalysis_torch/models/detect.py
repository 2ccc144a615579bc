"""Whole-image spot detection + PSF fitting.

Counterpart of fluorosequencingimageanalysis_tpu/models/detect.py:

    candidate map (kernel A) -> candidate bucket -> 5x5 gather + LM fit +
    quality (kernel B) -> R^2 gate -> consolidation NMS

``detect_and_fit_batch`` is the device program over a static
(B, max_candidates) bucket with a validity mask; ``detect_and_fit_
exhaustive`` fits every above-threshold candidate in chunks of one bucket
and consolidates on the host; ``find_peptides`` and its batch and lean
forms return the reference's psfs contract ({(rounded h, rounded w):
12-tuple}, pflib.py:395-428). The host-facing entry points take ``device=``
and run on the card unless the caller names the CPU; tensors they are
handed stay where they are.

``fit_type="monte_carlo"`` takes ``_detect_and_fit_monte_carlo``: kernel A's
candidates, the normalised patches, and kernel D's random search over
sampled circular models (ops/fused_mc_fit.py), drawn from a
``torch.Generator`` seeded with ``rng_seed``.

Not ported: the JAX package's float packs for its device link
(``_fit_chunk_packed``'s 15 columns, ``_lean_pack``, the power-of-two
fit-image bucket): the port fetches the fields as they are.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from .._device import default_device, resolve_device
from ..ops.candidates import (DEFAULT_CORRELATION_MATRIX,
                              candidate_maps_batch, extract_candidates_chunk,
                              find_candidates, find_candidates_batch,
                              gather_patches)
from ..ops.consolidate import consolidate, consolidate_host
from ..ops.fused_fit import fit_quality
from ..ops.fused_mc_fit import mc_fit
from ..ops.gaussian import gauss2d_image
from ..ops.mc_fit import grids, mc_model, normalise_patches, sample_params
from ..ops.quality import illumina_s_n, r_squared, rmse
from ..utils.rounding import py2_round

logger = logging.getLogger(__name__)

# Candidates per chunk of the exhaustive path (the JAX package probes
# its compiler for 2048 or 4096; results do not depend on it).
EXHAUSTIVE_CHUNK = 4096


class SpotFindResult(NamedTuple):
    """Static-shape detection result; every field has leading (B, K)
    (tensors from the device program, numpy arrays from the exhaustive
    path; a single image's result drops the B axis)."""
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


def pack_spot_buckets(res: SpotFindResult, max_spots: int,
                      coord_dtype=torch.int16):
    """Keep-first compaction of a batched SpotFindResult on its device.

    Each image's slots are ordered kept-first (stable within each class,
    so kept spots keep candidate order) and cut to ``max_spots``:

      f32 [B, S, 12]: center_h, center_w, rmse, r2, s_n, params[0..6]
      ints [B, S, 2]: cand_h, cand_w (``coord_dtype``; int16 is exact for
                      images narrower than 32768 px)
      flags [B, S, 2]: keep, cand_valid (bool)

    plus spot_count [B] (exact keep totals: spot_count > max_spots means
    kept fits were cut, in candidate order) and the pass-through
    cand_count [B]. Values of every kept slot are those of the full schema
    bit for bit.
    """
    # A stable sort of the integer cast: kept (0) before the rest (1).
    order = torch.argsort((~res.keep).to(torch.int8), dim=1,
                          stable=True)[:, :max_spots]

    def take(a):
        return torch.gather(a, 1, order)

    dt = res.params.dtype
    f32 = torch.stack(
        [take(res.center_h).to(dt), take(res.center_w).to(dt),
         take(res.rmse).to(dt), take(res.r2).to(dt), take(res.s_n).to(dt)] +
        [take(res.params[:, :, i]) for i in range(7)], dim=-1)
    ints = torch.stack([take(res.cand_h).to(coord_dtype),
                        take(res.cand_w).to(coord_dtype)], dim=-1)
    flags = torch.stack([take(res.keep), take(res.cand_valid)], dim=-1)
    spot_count = res.keep.sum(dim=1, dtype=torch.int32)
    return f32, ints, flags, spot_count, res.cand_count


def unpack_spot_buckets(f32, ints, flags, spot_count, cand_count):
    """Host-side inverse of :func:`pack_spot_buckets`: the SpotFindResult
    field dict (numpy, spot-major keep-first arrays)."""
    f32 = np.asarray(f32)
    ints = np.asarray(ints)
    flags = np.asarray(flags)
    return {
        "cand_h": ints[..., 0].astype(np.int32),
        "cand_w": ints[..., 1].astype(np.int32),
        "params": f32[..., 5:12],
        "center_h": f32[..., 0],
        "center_w": f32[..., 1],
        "rmse": f32[..., 2],
        "r2": f32[..., 3],
        "s_n": f32[..., 4],
        "keep": flags[..., 0],
        "cand_valid": flags[..., 1],
        "spot_count": np.asarray(spot_count),
        "cand_count": np.asarray(cand_count),
    }


def _as_images(images, device, dtype=np.float32):
    """A float image tensor on its device: tensors stay where they are
    (``device`` None) or move; arrays are cast to ``dtype`` on the host and
    go to ``device`` (None = ``_device.default_device()``, "cuda" unless
    set otherwise). Integer tensors are cast to float32 on the device."""
    if isinstance(images, torch.Tensor):
        x = images if device is None else images.to(resolve_device(device))
        return x if x.is_floating_point() else x.to(torch.float32)
    dev = resolve_device(default_device() if device is None else device)
    host = np.ascontiguousarray(np.asarray(images).astype(dtype))
    return torch.from_numpy(host).to(dev)


def _fetch_async(tensors):
    """Start the device->host copies of ``tensors`` into pinned memory;
    returns (host tensors, event or None). On the CPU nothing is copied."""
    if not tensors or tensors[0].device.type != "cuda":
        return list(tensors), None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return host, event


def detect_and_fit_exhaustive(images, median_filter_size=5,
                              correlation_matrix=None, c_std=2.0,
                              r_2_threshold=0.7, consolidation_radius=4.0,
                              chunk=None, num_iters=60, theta_starts=1,
                              max_chunks=None, device=None):
    """Uncapped detect + fit: every above-threshold candidate is fitted,
    the reference's no-cap semantics (pflib.py:217-258).

    The correlation maps are computed once (kernel A on the card);
    ``extract_candidates_chunk`` takes ``chunk`` candidates at a time with
    a device-resident exclusion mask; each chunk's fits run through kernel
    B and copy back without waiting; the quality-ranked NMS runs on the
    host over the union (``consolidate_host``). The one host read inside
    is the candidate counts after the first extraction, which size the
    loop. Chunked equals single-bucket, whatever the chunk.

    ``images``: (B, H, W) tensor (used where it is unless ``device`` is
    given) or array (uploaded to ``device``, default "cuda"). ``chunk``:
    None = ``EXHAUSTIVE_CHUNK``. ``max_chunks``: None = unlimited; an
    integer bounds the rounds with a truncation warning.

    Returns a batch SpotFindResult as numpy arrays with
    K = n_chunks * chunk; ``cand_count`` is the per-image true count.
    """
    imgs = _as_images(images, device)
    B, H, W = imgs.shape
    if chunk is None:
        chunk = EXHAUSTIVE_CHUNK
    chunk = min(chunk, max(H * W, 1))
    with torch.no_grad():
        cms = candidate_maps_batch(
            imgs, median_filter_size=median_filter_size,
            correlation_matrix=_prep_correlation_matrix(correlation_matrix))
        excluded = torch.zeros((B, H * W), dtype=torch.bool,
                               device=imgs.device)
        hs, ws, valid, remaining, excluded = extract_candidates_chunk(
            cms, excluded, chunk, float(c_std))
        counts = remaining.cpu().numpy()        # first call: true counts
        n_chunks = max(1, -(-int(counts.max()) // chunk))
        if max_chunks is not None and n_chunks > max_chunks:
            logger.warning(
                "detect_and_fit_exhaustive: %d candidates need %d chunks; "
                "capping at max_chunks=%d (weakest-correlation candidates "
                "dropped). Raise max_chunks for exhaustive coverage.",
                int(counts.max()), n_chunks, max_chunks)
            n_chunks = max_chunks
        fetched = []
        for i in range(n_chunks):
            if i > 0:
                hs, ws, valid, _rem, excluded = extract_candidates_chunk(
                    cms, excluded, chunk, float(c_std))
            params, ch, cw, rm, r2, sn = _fit_quality_core(
                imgs, hs, ws, num_iters, theta_starts)
            fetched.append(_fetch_async(
                [hs, ws, params, ch, cw, rm, r2, sn, valid]))
    parts = []
    for host, event in fetched:
        if event is not None:
            event.synchronize()
        parts.append([t.numpy() for t in host])
    (cand_h, cand_w, params, center_h, center_w, rm, r2, sn,
     cand_valid) = (np.concatenate([p[j] for p in parts], axis=1)
                    for j in range(9))
    # A NaN R^2 is kept by the reference's discard-if-less gate, the
    # comparison detect_and_fit_batch makes.
    passed = cand_valid & ~(r2 < r_2_threshold)
    keep = np.stack([
        consolidate_host(center_h[b], center_w[b], r2[b], passed[b],
                         radius=float(consolidation_radius))
        for b in range(B)])
    return SpotFindResult(cand_h, cand_w, params, center_h, center_w,
                          rm, r2, sn, keep, cand_valid,
                          counts.astype(np.int32))


def _prep_correlation_matrix(correlation_matrix):
    """Validate the template: the reference rejects non-square and
    even-sided kernels (pflib.py:235-239); an even kernel would shift the
    'same' correlation map by half a pixel. Returns a float64 array, or
    None for the default."""
    if correlation_matrix is None:
        return None
    arr = np.asarray(correlation_matrix, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1] or \
            arr.shape[0] % 2 == 0:
        raise ValueError("correlation_matrix must be square, with an odd "
                         "number of rows and columns")
    return arr


def detect_and_fit(image, median_filter_size=5, correlation_matrix=None,
                   c_std=2.0, r_2_threshold=0.7, consolidation_radius=4.0,
                   max_candidates=4096, num_iters=60, device=None):
    """Single-field detection + fit (a batch of one). image: (H, W) tensor
    or array; returns a SpotFindResult of tensors without the batch
    axis."""
    img = _as_images(image, device)
    with torch.no_grad():
        res = detect_and_fit_batch(
            img[None], median_filter_size=median_filter_size,
            correlation_matrix=_prep_correlation_matrix(correlation_matrix),
            c_std=float(c_std), r_2_threshold=float(r_2_threshold),
            consolidation_radius=float(consolidation_radius),
            max_candidates=max_candidates, num_iters=num_iters)
    return SpotFindResult(*(x[0] for x in res))


def _numpy_fields(res):
    """A SpotFindResult's fields as host numpy arrays."""
    return SpotFindResult(*(x.cpu().numpy() if isinstance(x, torch.Tensor)
                            else np.asarray(x) for x in res))


def find_peptides(image, median_filter_size=5, correlation_matrix=None,
                  candidate_pixels=None, c_std=2, r_2_threshold=0.7,
                  consolidation_radius=4, fit_type="gauss", N_iter=10 ** 3,
                  max_candidates=None, num_iters=60, dtype=np.float32,
                  rng_seed=0, device=None):
    """Host-facing spot finder with the reference's output contract.

    Returns {(round(h_0), round(w_0)): (h_0, w_0, H, A, sigma_h, sigma_w,
    theta, sub_img, fit_img, rmse, r_2, s_n)} as pflib.py:395-428
    documents. sub_img is the int64 copy of the 5x5 patch; fit_img the
    model on the patch grid (float32).

    max_candidates=None (the default) is exhaustive, like the reference:
    the chunked path fits every above-threshold candidate. An integer
    caps the bucket (one device program; a warning when the image exceeds
    it). ``device``: where detection and the fits run (None: the
    process default, ``_device.default_device()``, "cuda" unless set
    otherwise; a tensor image stays on its own device).

    fit_type='monte_carlo' is the reference's normalised random-search
    fitter (pflib.py:117-177) over candidates and ``N_iter`` samples drawn
    from ``rng_seed``; its fit image is the best sampled surface (the
    reference returns the last sampled one, which is not reproduced). It
    keeps a 4096 cap when max_candidates is None.
    """
    if consolidation_radius < 2:
        raise ValueError("consolidation_radius must be at least 2")
    if fit_type not in ("gauss", "monte_carlo"):
        raise ValueError(f"unknown fit_type {fit_type!r}")
    # The reference documents candidate_pixels as not implemented and
    # overwrites it (pflib.py:374, 434): a passed value is ignored, here
    # with a warning.
    if candidate_pixels is not None:
        logger.warning(
            "find_peptides: candidate_pixels is ignored (reference parity; "
            "pflib.py documents it as not implemented and overwrites it).")
    image = np.asarray(image)
    img_dev = _as_images(image, device, dtype)
    correlation_matrix = _prep_correlation_matrix(correlation_matrix)

    if fit_type == "monte_carlo":
        if max_candidates is None:
            max_candidates = 4096
        res = _numpy_fields(_detect_and_fit_monte_carlo(
            img_dev, median_filter_size=median_filter_size,
            correlation_matrix=correlation_matrix, c_std=float(c_std),
            r_2_threshold=float(r_2_threshold),
            consolidation_radius=float(consolidation_radius),
            max_candidates=max_candidates, n_iter=N_iter,
            rng_seed=rng_seed))
    elif max_candidates is None:
        res_b = detect_and_fit_exhaustive(
            img_dev[None], median_filter_size=median_filter_size,
            correlation_matrix=correlation_matrix, c_std=float(c_std),
            r_2_threshold=float(r_2_threshold),
            consolidation_radius=float(consolidation_radius),
            num_iters=num_iters)
        res = SpotFindResult(*(x[0] for x in res_b))
    else:
        res = _numpy_fields(detect_and_fit(
            img_dev, median_filter_size=median_filter_size,
            correlation_matrix=correlation_matrix, c_std=float(c_std),
            r_2_threshold=float(r_2_threshold),
            consolidation_radius=float(consolidation_radius),
            max_candidates=max_candidates, num_iters=num_iters))

    count = int(res.cand_count)
    if max_candidates is not None and count > max_candidates:
        logger.warning(
            "find_peptides: %d candidates exceed max_candidates=%d; the "
            "weakest-correlation candidates were dropped. Re-run with a "
            "larger max_candidates for exhaustive coverage.",
            count, max_candidates)
    return _psfs_from_arrays(image, np.nonzero(res.keep)[0], res.params,
                             res.center_h, res.center_w, res.rmse, res.r2,
                             res.s_n, res.cand_h, res.cand_w,
                             fit_type=fit_type)


def _center_keys(keep_idx, center_h, center_w, params):
    """Py2-rounded first-occurrence key dedup over kept fits in candidate
    order (pflib.py:513-519)."""
    seen = set()
    h0, w0, fits = [], [], []
    for i in keep_idx:
        ch, cw = float(center_h[i]), float(center_w[i])
        key = (py2_round(ch), py2_round(cw))
        if key in seen:
            continue
        seen.add(key)
        h0.append(key[0])
        w0.append(key[1])
        p = params[i]
        fits.append((ch, cw, float(p[0]), float(p[1]), float(p[4]),
                     float(p[5]), float(p[6])))
    return np.asarray(h0), np.asarray(w0), fits


def find_peptide_centers(image, median_filter_size=5, c_std=2.0,
                         r_2_threshold=0.7, consolidation_radius=4.0,
                         max_candidates=None, num_iters=60, device="cuda"):
    """Lean find_peptides: the psfs-dict key semantics (Py2-rounded
    first-occurrence dedup in kept-candidate order, pflib.py:513-519)
    without sub and fit images. Returns (h0, w0, fits, count): the rounded
    centers and 7-tuple fits (h_0, w_0, H, A, sigma_h, sigma_w, theta) per
    unique rounded key, plus the true candidate count.

    max_candidates=None (default) is exhaustive via the chunked path; an
    integer caps the bucket, with a warning on overflow."""
    if consolidation_radius < 2:
        # Key uniqueness of the rounded-center dedup needs radius >= 2
        # (pflib.py:431-432).
        raise ValueError("consolidation_radius must be at least 2")
    img = _as_images(image, device)
    if img.dtype != torch.float32:
        img = img.to(torch.float32)
    kw = dict(median_filter_size=median_filter_size, c_std=float(c_std),
              r_2_threshold=float(r_2_threshold),
              consolidation_radius=float(consolidation_radius),
              num_iters=num_iters)
    if max_candidates is None:
        res_b = detect_and_fit_exhaustive(img[None], **kw)
        res = SpotFindResult(*(x[0] for x in res_b))
    else:
        res = _numpy_fields(detect_and_fit(
            img, max_candidates=max_candidates, **kw))
    count = int(res.cand_count)
    if max_candidates is not None and count > max_candidates:
        logger.warning(
            "find_peptide_centers: %d candidates exceed max_candidates=%d; "
            "the weakest-correlation candidates were dropped. Re-run with "
            "a larger max_candidates for exhaustive coverage.",
            count, max_candidates)
    h0, w0, fits = _center_keys(np.nonzero(res.keep)[0], res.center_h,
                                res.center_w, res.params)
    return h0, w0, fits, count


def _psfs_from_arrays(image, idx, params, center_h, center_w, rm, r2, sn,
                      cand_h, cand_w, fit_type="gauss"):
    """Kept-fit arrays -> the reference psfs dict (pflib.py:395-428).

    ``fit_img`` of a Gaussian fit is the model of the kept parameters on
    the 5x5 grid, all kept spots in one batched evaluation on the host, in
    float32 (the JAX package's production dtype; its tests run it in
    float64). A Monte-Carlo fit's ``sub_img`` is the normalised float64
    patch it was fitted to and its ``fit_img`` the best sample's surface
    (``_mc_fit_image``)."""
    out = {}
    fit_imgs = None
    if fit_type != "monte_carlo" and len(idx):
        fit_imgs = gauss2d_image(
            torch.from_numpy(np.ascontiguousarray(params[idx],
                                                  dtype=np.float32)),
            (5, 5), dtype=torch.float32).numpy()
    for j, i in enumerate(idx):
        h, w = int(cand_h[i]), int(cand_w[i])
        sub_img = image[h - 2:h + 3, w - 2:w + 3].astype(np.int64)
        if fit_type == "monte_carlo":
            # pflib.py:444-450 normalises sub_img in place before fitting
            # and stores the normalised copy.
            smin = sub_img.min()
            shifted = (sub_img - smin).astype(np.float64)
            sub_img = shifted / max(float(shifted.max()), 1e-300)
        p = params[i]
        fit_img = fit_imgs[j] if fit_imgs is not None else _mc_fit_image(p)
        h_0, w_0 = float(center_h[i]), float(center_w[i])
        psf = (h_0, w_0, float(p[0]), float(p[1]), float(p[4]), float(p[5]),
               float(p[6]), sub_img, fit_img, float(rm[i]),
               float(r2[i]), float(sn[i]))
        # Py2 half-away-from-zero rounding keeps the keys the reference's
        # (pflib.py:513-519 under Python 2 round()).
        key = (py2_round(h_0), py2_round(w_0))
        out.setdefault(key, psf)
    return out


def warn_candidate_overflow(cand_count, max_candidates, where):
    """Report candidate-bucket truncation, for the batch front doors
    (find_peptides_batch, api.Pipeline.run_zstack)."""
    n_over = int((np.asarray(cand_count) > max_candidates).sum())
    if n_over:
        logger.warning(
            "%s: %d image(s) exceed max_candidates=%d; the weakest-"
            "correlation candidates were dropped.",
            where, n_over, max_candidates)


def psfs_dicts_from_batch(images, keep, params, center_h, center_w,
                          rmse, r2, s_n, cand_h, cand_w,
                          consolidation_radius):
    """Per-image reference psfs dicts (pflib.py:395-428 contract) from
    batched kept-fit arrays, for find_peptides_batch and
    api.Pipeline.run_zstack(psfs=True)."""
    if consolidation_radius < 2:
        # Below 2 the rounded keys are no longer unique and the dedup
        # would drop spots (pflib.py:431-432).
        raise ValueError("consolidation_radius must be at least 2")
    return [
        _psfs_from_arrays(images[b], np.nonzero(keep[b])[0], params[b],
                          center_h[b], center_w[b], rmse[b], r2[b], s_n[b],
                          cand_h[b], cand_w[b])
        for b in range(len(images))
    ]


def find_peptides_batch(images, median_filter_size=5, correlation_matrix=None,
                        c_std=2, r_2_threshold=0.7, consolidation_radius=4,
                        max_candidates=None, num_iters=60, dtype=np.float32,
                        device=None):
    """find_peptides over a same-shape image stack in one device program.
    Returns a list of psfs dicts, one per image, equal to per-image
    find_peptides (fit_type='gauss').

    max_candidates=None (default) is exhaustive via the chunked path; an
    integer caps the per-image bucket with a warning on overflow.
    ``device`` as in find_peptides.
    """
    if consolidation_radius < 2:
        raise ValueError("consolidation_radius must be at least 2")
    images = np.asarray(images)
    imgs = _as_images(images, device, dtype)
    kw = dict(median_filter_size=median_filter_size,
              correlation_matrix=_prep_correlation_matrix(correlation_matrix),
              c_std=float(c_std), r_2_threshold=float(r_2_threshold),
              consolidation_radius=float(consolidation_radius),
              num_iters=num_iters)
    if max_candidates is None:
        res = detect_and_fit_exhaustive(imgs, **kw)
    else:
        with torch.no_grad():
            res = _numpy_fields(detect_and_fit_batch(
                imgs, max_candidates=max_candidates, **kw))
        warn_candidate_overflow(res.cand_count, max_candidates,
                                "find_peptides_batch")
    return psfs_dicts_from_batch(
        images, res.keep, res.params, res.center_h, res.center_w, res.rmse,
        res.r2, res.s_n, res.cand_h, res.cand_w, consolidation_radius)


# ---------------------------------------------------------------------------
# Monte-Carlo fit path (reference pflib.py:117-177, fit_type='monte_carlo')
# ---------------------------------------------------------------------------

def _mc_fit_image(p):
    """Best-sample MC fit surface, normalized by its max (pflib.py:159-161)."""
    h_grid, w_grid = np.meshgrid(np.arange(5.0), np.arange(5.0), indexing="ij")
    g = p[1] * np.exp(-(((h_grid - p[2]) ** 2) + ((w_grid - p[3]) ** 2))
                      / (2.0 * p[4] ** 2)) + p[0]
    return g / g.max()


def draw_mc_normals(n_iter, n, rng_seed, device):
    """(6, n_iter, n) float32 standard normals of one Monte-Carlo fit, from
    a generator seeded with ``rng_seed`` (the H, A, h0, w0, sigma_h,
    sigma_w draws, in that order)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng_seed))
    return torch.randn((6, n_iter, n), generator=gen, device=device)


def _detect_and_fit_monte_carlo(image, median_filter_size=5,
                                correlation_matrix=None, c_std=2.0,
                                r_2_threshold=0.7, consolidation_radius=4.0,
                                max_candidates=4096, n_iter=1000, rng_seed=0,
                                normals=None):
    """Detection + Monte-Carlo fit of one (H, W) float image tensor on its
    device; returns a SpotFindResult of tensors without the batch axis.

    Candidates come from kernel A (``find_candidates``); each 5x5 patch is
    min-max normalised, and kernel D (``ops/fused_mc_fit.mc_fit``) keeps
    the best of ``n_iter`` sampled circular models. R^2, RMSE and S/N are
    taken on the normalised patches; params slot 5 is the sampled sigma_w
    (the reference stores it though its model ignores it) and slot 6 is 0.
    ``normals``: (6, n_iter, max_candidates) standard normals to use in
    place of the generator's (the tests feed the JAX package's)."""
    if correlation_matrix is None:
        correlation_matrix = DEFAULT_CORRELATION_MATRIX
    dt, dev = image.dtype, image.device
    with torch.no_grad():
        hs, ws, valid, count = find_candidates(
            image, median_filter_size=median_filter_size,
            correlation_matrix=np.asarray(correlation_matrix), c_std=c_std,
            max_candidates=max_candidates)
        patches = normalise_patches(gather_patches(image, hs, ws, radius=2))
        n = patches.shape[0]
        z = (draw_mc_normals(n_iter, n, rng_seed, dev) if normals is None
             else torch.as_tensor(normals, dtype=dt, device=dev))
        best_p, _ = mc_fit(patches, sample_params(patches, z).contiguous())
        params = torch.cat([best_p, best_p.new_zeros((n, 1))], dim=1)
        h_grid, w_grid = grids(dt, dev)
        g = mc_model(best_p, h_grid, w_grid)
        g = g / g.reshape(n, -1).amax(dim=-1)[:, None, None]
        r2 = r_squared(patches, g)
        rm = rmse(patches, g)
        sn = illumina_s_n(patches)
        center_h = params[:, 2] + hs.to(dt) - 2.5
        center_w = params[:, 3] + ws.to(dt) - 2.5
        # ~(r2 < thr): a NaN R^2 is kept, like the reference's
        # discard-if-less gate (pflib.py:465-467).
        passed = valid & ~(r2 < r_2_threshold)
        # The candidate-window gate: Monte-Carlo centers drift up to
        # ~2.5 px, so center distance alone would pit fits against each
        # other that the reference never compares (pflib.py:491-495).
        keep = consolidate(center_h, center_w, r2, passed,
                           radius=consolidation_radius, cand_h=hs.to(dt),
                           cand_w=ws.to(dt))
    return SpotFindResult(hs, ws, params, center_h, center_w, rm, r2, sn,
                          keep, valid, count)
