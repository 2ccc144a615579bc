"""Host-side image IO.

The reference shells out to ImageMagick `convert` to turn arbitrary formats
into PNG before reading (pflib.py:55-90, 714-746). We read
TIFF/PNG/etc. directly with imageio/PIL — pure host-side IO, no external
binary — while keeping the reference's path conventions (a non-PNG target
with an existing sibling ``<path>.png`` uses the sibling).

A copy of fluorosequencingimageanalysis_tpu/utils/imageio.py; tests/
test_torch_import.py holds the two copies to the same code.
"""

from __future__ import annotations

import os

import numpy as np


def read_image_array(image_path: str) -> np.ndarray:
    import imageio.v2 as iio
    arr = np.asarray(iio.imread(image_path))
    if arr.ndim == 3:
        if arr.shape[-1] <= 4:
            # Collapse channel-last RGB(A) sanity-check images to
            # grayscale (first channel).
            arr = arr[..., 0]
        elif arr.shape[0] == 1:
            # Single-page TIFF read back as a (1, H, W) stack.
            arr = arr[0]
        else:
            # Frame-first (Z, H, W) multi-page stack: arr[..., 0] would
            # silently slice the first COLUMN of every page. Point the
            # caller at the stack reader instead.
            raise ValueError(
                f"{image_path} is a {arr.shape[0]}-page stack, not a "
                "single image; read it with read_stack_array (or pass "
                "per-frame files).")
    return arr


def read_stack_array(image_path: str) -> np.ndarray:
    """Read a multi-page image as a (frames, H, W) stack.

    Single-page inputs come back with frames == 1, so movie/z-stack CLIs
    can accept either one multi-page TIFF or a list of per-frame files.
    """
    import imageio.v2 as iio
    try:
        pages = [np.asarray(p) for p in iio.mimread(image_path,
                                                    memtest=False)]
    except Exception:
        pages = [np.asarray(iio.imread(image_path))]
    frames = []
    for page in pages:
        if page.ndim == 3 and page.shape[-1] <= 4:
            page = page[..., 0]
        if page.ndim != 2:
            raise ValueError(
                f"{image_path}: page of shape {page.shape} is not a "
                "2-D grayscale frame.")
        frames.append(page)
    return np.stack(frames)


def read_image(image_path: str):
    """(converted_path, image) — parity with pflib.read_image (pflib.py:714).

    If the target is not a PNG and ``<path>.png`` exists, the sibling PNG is
    read (the reference's convert-once convention). Otherwise the file is
    read directly — no conversion subprocess is needed.
    """
    converted_path = image_path = os.path.abspath(image_path)
    if not image_path.endswith(".png") and os.path.exists(image_path + ".png"):
        converted_path = image_path + ".png"
    return converted_path, read_image_array(converted_path)


def convert_image(input_path, output_path=None, output_format="png",
                  convert_command=None):
    """Convert an image by decoding + re-encoding in-process.

    API parity with pflib.convert_image (pflib.py:55-90); the
    convert_command argument is accepted for compatibility and ignored
    (no subprocess is spawned).
    """
    import imageio.v2 as iio
    if output_path is None:
        output_path = ".".join((input_path, output_format))
    try:
        arr = read_image_array(input_path)
        iio.imwrite(output_path, arr)
    except Exception:
        import logging
        logging.getLogger(__name__).exception("convert_image failed")
        return None
    return output_path
