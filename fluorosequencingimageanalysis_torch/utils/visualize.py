"""Sanity-check visualizations: PSF/trace highlight PNGs.

Parity with pflib's save_psfs_png and contrast filters
(pflib.py:749-880), reimplemented without scikit-image
(plain NumPy contrast mapping + Pillow drawing). A copy of
fluorosequencingimageanalysis_tpu/utils/visualize.py with the Pillow
imports moved into the function that draws; tests/test_torch_import.py
holds the two copies to the same code.
"""

from __future__ import annotations

import os
import time

import numpy as np

from .hashing import psfs_filename
from .imageio import read_image


def _histogram_equalization(image, **kwargs):
    """Histogram-equalize and rescale to 8 bits (pflib.py:749-764).

    skimage.exposure.equalize_hist semantics, both dtype branches:

    - integer images (the pipeline's PNGs/TIFFs): skimage bins per
      integer VALUE (bincount histogram), so its interp lands exactly on
      cdf(v) = P(X <= v) — identical to the right-sided empirical CDF
      computed here, and tie-aware (equal pixels map to the same gray);
    - float images: skimage uses a 256-bin np.histogram + np.interp
      between bin centers, which is NOT the empirical CDF — reproduce
      it exactly so float inputs match the reference byte-for-byte too.
    """
    image = np.asarray(image)
    if np.issubdtype(image.dtype, np.integer) or image.dtype == bool:
        flat = image.ravel()
        sorted_flat = np.sort(flat, kind="stable")
        cdf = np.searchsorted(sorted_flat, flat, side="right") / flat.size
        eq = cdf.reshape(image.shape)
    else:
        hist, edges = np.histogram(image.ravel(), bins=256)
        centers = (edges[:-1] + edges[1:]) / 2.0
        cdf = np.cumsum(hist).astype(np.float64)
        cdf /= cdf[-1]
        eq = np.interp(image.ravel(), centers, cdf).reshape(image.shape)
    return _intensity_scaling(eq)


def _intensity_scaling(image, **kwargs):
    """Rescale the image's full range into uint8 (pflib.py:767-780)."""
    image = np.asarray(image, dtype=np.float64)
    lo, hi = image.min(), image.max()
    if hi == lo:
        return np.zeros(image.shape, dtype=np.uint8)
    return np.clip((image - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)


def save_psfs_png(psfs, image_path, timestamp_epoch=None, output_path=None,
                  square_size=9, square_color="lightblue", square_colors=None,
                  contrast_filter=_intensity_scaling,
                  contrast_filter_args=None):
    """Highlight PSFs with colored squares and save as PNG
    (pflib.py:783-880). Pillow is imported here, so the package imports
    where it is absent."""
    from PIL import Image as PILImage
    from PIL import ImageDraw, ImageOps

    image_path = os.path.abspath(image_path)
    if output_path is None:
        if timestamp_epoch is None:
            timestamp_epoch = round(time.time())
        output_path = psfs_filename(image_path, timestamp_epoch, ".png")
    converted_path, image = read_image(image_path)
    if contrast_filter_args is None:
        contrast_filter_args = {}
    filtered = contrast_filter(image, **contrast_filter_args)
    pillow_image = PILImage.fromarray(filtered, mode="L")
    highlighted = ImageOps.colorize(pillow_image, (0, 0, 0), (255, 255, 255))
    if square_size % 2 == 0 or square_size < 3:
        raise ValueError("square_size must be an odd integer >= 3")
    radius = (square_size - 1) // 2
    draw = ImageDraw.Draw(highlighted)
    for (h, w) in psfs:
        square = ((w - radius, h - radius), (w + radius, h + radius))
        if square_colors is None or (h, w) not in square_colors:
            color = square_color
        else:
            color = square_colors[(h, w)]
        if color is not None:
            draw.rectangle(square, fill=None, outline=color)
    highlighted.save(output_path)
    return output_path
