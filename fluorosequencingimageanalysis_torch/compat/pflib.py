"""The reference's ``pflib`` module surface (pflib.py), on the port.

A copy of the repo's root ``pflib.py`` shim with its imports pointed at
the PyTorch package: scripts written against the reference (``pflib.
parallel_image_batch`` / ``find_peptides`` / ``save_psfs_*`` / epoch
hashes) run on it unmodified. ``_psf_candidates`` and ``_fit_2d_gaussian``
take their tensors to the process default device
(``_device.default_device()``); the detection entry points default to it.
"""

import numpy as np
import torch

from .._device import default_device, resolve_device
from ..models.detect import find_peptides
from ..ops.candidates import DEFAULT_CORRELATION_MATRIX, candidate_map
from ..batch import (
    image_batch, parallel_image_batch, save_psfs_pkl, save_psfs_csv,
    save_psfs_png)
from ..utils.hashing import (
    epoch_to_hash as _epoch_to_hash, hash_to_epoch as _hash_to_epoch,
    psfs_filename as _psfs_filename)
from ..utils.imageio import read_image, convert_image
from ..utils.visualize import _histogram_equalization, _intensity_scaling

default_correlation_matrix = np.asarray(DEFAULT_CORRELATION_MATRIX,
                                        dtype=np.int64)


def _psf_candidates(image, median_filter_size=5,
                    correlation_matrix=None, c_std=2, **kwargs):
    """Candidate pixels as a list of (h, w) (pflib.py:217-258)."""
    if correlation_matrix is None:
        correlation_matrix = default_correlation_matrix
    correlation_matrix = np.asarray(correlation_matrix)
    if (correlation_matrix.shape[0] != correlation_matrix.shape[1] or
            correlation_matrix.shape[0] % 2 == 0):
        raise ValueError("correlation_matrix must be square, with an odd "
                         "number of rows and columns")
    image = torch.from_numpy(np.asarray(image, dtype=np.float64))
    _, mask = candidate_map(image.to(resolve_device(default_device())),
                            median_filter_size=median_filter_size,
                            correlation_matrix=correlation_matrix,
                            c_std=c_std)
    hs, ws = np.nonzero(mask.cpu().numpy())
    return list(zip(hs.tolist(), ws.tolist()))


def illumina_s_n(sub_img):
    """(pflib.py:261-281)"""
    sub_img = np.asarray(sub_img, dtype=np.float64)
    if not (sub_img.ndim == 2 and sub_img.shape[0] == sub_img.shape[1]):
        raise ValueError("sub_img must be square, but has shape " +
                         str(sub_img))
    edge = np.concatenate([sub_img[0, :], sub_img[-1, :],
                           sub_img[1:-1, 0], sub_img[1:-1, -1]])
    return (sub_img.max() - edge.mean()) / edge.std()


def _fit_2d_gaussian(subimage, implementation="agpy"):
    """Single-patch fit with the pflib contract (pflib.py:180-214)."""
    subimage = np.asarray(subimage)
    assert subimage.shape[0] == 5 and subimage.shape[1] == 5
    if implementation != "agpy":
        raise NotImplementedError("Currently, only agpy is supported.")
    from ..ops.lm import fit_gaussians_batched
    from ..ops.gaussian import gauss2d_image
    patch = torch.from_numpy(subimage[None].astype(np.float64))
    params, _ = fit_gaussians_batched(
        patch.to(resolve_device(default_device())), num_iters=120)
    fit_img = gauss2d_image(params[0], (5, 5),
                            dtype=torch.float64).cpu().numpy()
    p = params[0].cpu().numpy()
    return (p[2], p[3], p[0], p[1], p[4], p[5], p[6], fit_img)


__all__ = [
    "default_correlation_matrix", "convert_image", "find_peptides",
    "_psf_candidates", "illumina_s_n", "_fit_2d_gaussian", "_epoch_to_hash",
    "_hash_to_epoch", "_psfs_filename", "save_psfs_pkl", "save_psfs_csv",
    "save_psfs_png", "read_image", "_histogram_equalization",
    "_intensity_scaling", "image_batch", "parallel_image_batch",
]


def _2d_gaussian_function(H, A, h_0, w_0, sigma_h, sigma_w, theta, h, w):
    """The Monte-Carlo fitter's model (pflib.py:93-116). Parity note: the
    reference's body ignores theta and sigma_w — it is circular with
    sigma_h only — reproduced exactly."""
    a = (h - h_0) ** 2
    b = (w - w_0) ** 2
    return A * np.exp(-np.divide(a + b, 2 * sigma_h ** 2)) + H


def _fit_2d_gaussian_monte_carlo(subimage, N_iter=10 ** 3):
    """Random-search circular Gaussian fit of a max-normalized 5x5 patch
    (pflib.py:117-177): draw (H, A, h_0, w_0, sigma_h, sigma_w, theta) from
    the reference's proposal distributions, keep the lowest-RMS candidate.
    Returns (h_0, w_0, H, A, sigma_h, sigma_w, theta, fit_image).

    The batched device version over many patches is
    models.detect._detect_and_fit_monte_carlo.
    """
    subimage = np.asarray(subimage, dtype=np.float64)
    assert subimage.shape[0] == 5 and subimage.shape[1] == 5
    y = np.array([np.arange(5) for _ in np.arange(5)])
    x = y.T
    (idx, idy) = np.where(np.max(subimage) == subimage)
    h0mean, w0mean = idx[0], idy[0]
    h0std = w0std = 0.3
    sigmah_mean, sigmah_std = 1.2, 0.3
    sigmaw_mean, sigmaw_std = 1.0, 0.3
    best = None
    rms_current = 10 ** 7 * 25 * np.max(subimage)
    for _ in range(N_iter):
        H = np.abs(np.random.normal(0.0, 0.1))
        A = np.abs(np.random.normal(1.0, 0.2))
        h_0 = np.clip(np.random.normal(h0mean, h0std), 0.01, 4.99)
        w_0 = np.clip(np.random.normal(w0mean, w0std), 0.01, 4.99)
        sigmah = np.abs(np.random.normal(sigmah_mean, sigmah_std))
        sigmaw = np.abs(np.random.normal(sigmaw_mean, sigmaw_std))
        theta = np.clip(0 * np.random.exponential(), 0, 2 * np.pi)
        gauss = _2d_gaussian_function(H, A, h_0, w_0, sigmah, sigmaw, theta,
                                      x, y)
        gauss = gauss / np.max(gauss)
        rms = np.sqrt(np.sum((subimage - gauss) ** 2))
        if rms < rms_current:
            rms_current = rms
            best = (h_0, w_0, H, A, sigmah, sigmaw, theta, gauss)
    return best


__all__ += ["_2d_gaussian_function", "_fit_2d_gaussian_monte_carlo"]
