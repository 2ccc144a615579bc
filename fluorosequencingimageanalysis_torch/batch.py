"""Batch image processing + PSF artifact writers.

Counterpart of fluorosequencingimageanalysis_tpu/batch.py: parity with
pflib's output writers and batch runners (pflib.py:594-711, 883-1111). The
reference's multiprocessing fan-out (load-balanced by candidate counts,
pflib.py:1000-1111) has no use on one device, so parallel_image_batch
accepts num_processes for compatibility and batches the images through
the device. Detection runs on the card unless ``find_peptides_parameters``
names another ``device``.
"""

from __future__ import annotations

import csv
import logging
import os
import pickle
import time

import numpy as np

from .utils.hashing import psfs_filename
from .utils.imageio import read_image
from .utils.visualize import save_psfs_png  # noqa: F401 (re-export)
from .models.detect import find_peptides
from .utils.profiling import stage as _stage

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())


def save_psfs_pkl(psfs, image_path=None, timestamp_epoch=None,
                  output_path=None):
    """Pickle the psfs dict (pflib.py:594-636)."""
    if image_path is None and output_path is None:
        raise ValueError("Either image_path or output_path must be provided.")
    if image_path is not None:
        image_path = os.path.abspath(image_path)
    if output_path is None:
        if timestamp_epoch is None:
            timestamp_epoch = round(time.time())
        output_path = psfs_filename(image_path, timestamp_epoch, ".pkl")
    with open(output_path, "wb") as f:
        pickle.dump(psfs, f)
    return output_path


def save_psfs_csv(psfs, image_path=None, timestamp_epoch=None,
                  output_path=None):
    """Tab-delimited PSF summary (pflib.py:639-711; excel-tab dialect,
    header order preserved)."""
    if image_path is None and output_path is None:
        raise ValueError("Either image_path or output_path must be provided.")
    if image_path is not None:
        image_path = os.path.abspath(image_path)
    if output_path is None:
        if timestamp_epoch is None:
            timestamp_epoch = round(time.time())
        output_path = psfs_filename(image_path, timestamp_epoch, ".csv")
    with open(output_path, "w", newline="") as output_file:
        output_writer = csv.writer(output_file, dialect="excel-tab")
        output_writer.writerow(
            ["Absolute image path", "PSF center (h) coordinate",
             "PSF center (w) coordinate", "PSF base (H)eight",
             "PSF (A)mplitude", "PSF width (sigma_h)",
             "PSF width (sigma_w)", "PSF (theta)", "PSF (rmse)",
             "PSF (r_2)", "PSF (s_n)"])
        for ((h, w), (h_0, w_0, H, A, sigma_h, sigma_w, theta, sub_img,
                      fit_img, rmse, r_2, s_n)) in psfs.items():
            output_writer.writerow([image_path, str(h_0), str(w_0), str(H),
                                    str(A), str(sigma_h), str(sigma_w),
                                    str(theta), str(rmse), str(r_2),
                                    str(s_n)])
    return output_path


def image_batch(image_paths, find_peptides_parameters=None,
                timestamp_epoch=None):
    """Find + persist PSFs for a set of images (pflib.py:883-997).

    Per-image failures are logged and skipped, matching the reference's
    checkpointing behavior.
    """
    if timestamp_epoch is None:
        timestamp_epoch = round(time.time())
    image_paths = list(dict.fromkeys(os.path.abspath(p)
                                     for p in image_paths))
    if find_peptides_parameters is None:
        find_peptides_parameters = {}
    processed_images = {}
    for image_path in image_paths:
        output_tuple = [None, None, None, None]
        try:
            with _stage("io/read_image"):
                converted_path, image = read_image(image_path)
        except Exception:
            logger.exception("image_batch: read_image failed for %s",
                             image_path)
            continue
        output_tuple[0] = converted_path
        try:
            with _stage("detect/find_peptides"):
                psfs = find_peptides(image, **find_peptides_parameters)
        except Exception:
            logger.exception("image_batch: find_peptides failed for %s",
                             image_path)
            continue
        try:
            output_tuple[1] = save_psfs_pkl(psfs, image_path=converted_path,
                                            timestamp_epoch=timestamp_epoch)
            output_tuple[2] = save_psfs_csv(psfs, image_path=converted_path,
                                            timestamp_epoch=timestamp_epoch)
            output_tuple[3] = save_psfs_png(psfs, image_path=converted_path,
                                            timestamp_epoch=timestamp_epoch)
        except Exception:
            logger.exception("image_batch: artifact write failed for %s",
                             image_path)
            continue
        processed_images.setdefault(image_path, tuple(output_tuple))
    return processed_images


def parallel_image_batch(image_paths, find_peptides_parameters=None,
                         timestamp_epoch=None, num_processes=None):
    """Reference-signature batch runner (pflib.py:1000-1111).

    The reference fans images out over a Pool load-balanced by candidate
    counts; here images are grouped by shape and each group runs through
    the device as one batch (find_peptides_batch). num_processes is
    accepted and ignored. Per-image
    failures are logged and skipped (the reference's checkpointing
    behavior); non-'gauss' fit types fall back to the sequential runner.
    """
    if timestamp_epoch is None:
        timestamp_epoch = round(time.time())
    if find_peptides_parameters is None:
        find_peptides_parameters = {}
    if find_peptides_parameters.get("fit_type", "gauss") != "gauss":
        return image_batch(image_paths,
                           find_peptides_parameters=find_peptides_parameters,
                           timestamp_epoch=timestamp_epoch)
    # find_peptides-only knobs (the MC fitter's and the explicit
    # fit_type='gauss') are not find_peptides_batch parameters; passing
    # them through would TypeError and push every group onto the slow
    # per-image fallback.
    # (candidate_pixels is silently ignored by find_peptides itself —
    # reference parity, pflib.py:374/434 — so stripping it here is exact.)
    batch_parameters = {k: v for k, v in find_peptides_parameters.items()
                        if k not in ("fit_type", "N_iter", "rng_seed",
                                     "candidate_pixels")}
    from .models.detect import find_peptides_batch
    image_paths = list(dict.fromkeys(os.path.abspath(p)
                                     for p in image_paths))
    loaded = []
    for image_path in image_paths:
        try:
            with _stage("io/read_image"):
                converted_path, image = read_image(image_path)
        except Exception:
            logger.exception("parallel_image_batch: read_image failed "
                             "for %s", image_path)
            continue
        loaded.append((image_path, converted_path, np.asarray(image)))

    by_shape = {}
    for entry in loaded:
        by_shape.setdefault(entry[2].shape, []).append(entry)

    processed_images = {}
    for shape, group in by_shape.items():
        stack = np.stack([img for _, _, img in group])
        try:
            with _stage("detect/find_peptides_batch"):
                psfs_list = find_peptides_batch(stack, **batch_parameters)
        except Exception:
            logger.exception("parallel_image_batch: batched detection "
                             "failed for shape %s; falling back per-image",
                             shape)
            sub = image_batch([p for p, _, _ in group],
                              find_peptides_parameters=
                              find_peptides_parameters,
                              timestamp_epoch=timestamp_epoch)
            processed_images.update(sub)
            continue
        for (image_path, converted_path, _), psfs in zip(group, psfs_list):
            try:
                pkl = save_psfs_pkl(psfs, image_path=converted_path,
                                    timestamp_epoch=timestamp_epoch)
                csv_p = save_psfs_csv(psfs, image_path=converted_path,
                                      timestamp_epoch=timestamp_epoch)
                png = save_psfs_png(psfs, image_path=converted_path,
                                    timestamp_epoch=timestamp_epoch)
            except Exception:
                logger.exception("parallel_image_batch: artifact write "
                                 "failed for %s", image_path)
                continue
            processed_images.setdefault(
                image_path, (converted_path, pkl, csv_p, png))
    return processed_images
