"""Artifact naming: base-36 epoch hashes and PSF result filenames.

Behavioral parity with the reference's timestamp-hash artifact store
(pflib.py:523-591): results for an image are written next to
the image as ``<abs_image_path>_psfs_<base36(epoch)>.{pkl,csv,png}`` so that
downstream stages can discover and reuse them (checkpoint-by-filename).

A copy of fluorosequencingimageanalysis_tpu/utils/hashing.py; tests/
test_torch_import.py holds the two copies to the same code.
"""

from __future__ import annotations

import os
import time

from .rounding import py2_round

_HASHCHARS = "0123456789abcdefghijklmnopqrstuvwxyz"


def epoch_to_hash(epoch: float) -> str:
    """Base-36 encoding of a Unix epoch, rounded to the nearest second.

    Parity: pflib.py:523-543. The reference rounds with
    Python 2 round() (halves away from zero); Python 3 round() banker's-
    rounds *.5 epochs to the even second, which would name the artifact
    differently from a reference run.
    """
    if epoch <= 0:
        raise ValueError("epoch must be positive.")
    epoch = py2_round(epoch)
    out = ""
    while epoch > 0:
        out = _HASHCHARS[epoch % len(_HASHCHARS)] + out
        epoch //= len(_HASHCHARS)
    return out


def hash_to_epoch(epoch_hash: str) -> int:
    """Inverse of :func:`epoch_to_hash`. Parity: pflib.py:546-566."""
    epoch = 0
    for i, c in enumerate(reversed(epoch_hash)):
        if c not in _HASHCHARS:
            raise ValueError("epoch_hash contains unrecognized character(s).")
        epoch += _HASHCHARS.index(c) * len(_HASHCHARS) ** i
    return epoch


def psfs_filename(image_path: str, timestamp_epoch: float | None,
                  format_suffix: str) -> str:
    """Standard filename for PSF result artifacts.

    Parity: pflib.py:569-591 —
    ``abspath(image_path) + '_psfs_' + hash + suffix``.
    """
    if timestamp_epoch is None:
        timestamp_epoch = round(time.time())
    return (os.path.abspath(image_path) + "_psfs_" +
            epoch_to_hash(timestamp_epoch) + format_suffix)
