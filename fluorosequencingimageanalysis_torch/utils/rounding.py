"""Python-2 rounding (halves away from zero), on the host and the device.

Counterpart of fluorosequencingimageanalysis_tpu/utils/rounding.py
(``py2_round``, ``py2_round_device_i32``) and of
pipeline/tracking.py's ``_py2_round_array`` there. Every form decides with
the exact fraction comparison ``|x| - floor(|x|) >= 0.5``, never
``floor(x + 0.5)`` (which rounds a near-half value up across the tie), so
spot keys cannot diverge between the host, the device and the native
tracker (csrc/tracklink.cpp ``py2round``).

The device form is computed through ``|x|`` so that, for ``|x| < 2^23``,
``|x| - floor(|x|)`` is exact in float32 and the test matches the host
float64 ``py2_round`` of the same value bit for bit, negative halves
included.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def py2_round(x):
    """round() with Python-2 semantics: halves away from zero.

    ``|x| - floor(|x|)`` is exact in float64 below 2^52, so the >= 0.5
    comparison decides every case, ties included, like the Python 2
    builtin (floor(0.49999999999999994 + 0.5) would give 1; this gives 0).
    """
    if x >= 0:
        f = math.floor(x)
        return int(f) + (1 if x - f >= 0.5 else 0)
    f = math.ceil(x)
    return int(f) - (1 if f - x >= 0.5 else 0)


def py2_round_array(x):
    """int64 array of ``x`` rounded with halves away from zero, always
    computed in float64 whatever the input dtype (a float32 ``x + 0.5``
    rounds the just-below-half 0.49999997 up to 1)."""
    x = np.asarray(x, np.float64)
    ax = np.abs(x)
    f = np.floor(ax)
    r = (f + (ax - f >= 0.5)).astype(np.int64)
    return np.where(x < 0, -r, r)


def py2_round_device_i32(x):
    """int32 tensor of ``x`` rounded with halves away from zero."""
    ax = torch.abs(x)
    f = torch.floor(ax)
    r = f + (ax - f >= 0.5).to(x.dtype)
    return torch.where(x < 0, -r, r).to(torch.int32)
