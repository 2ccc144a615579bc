"""Python-2 rounding (halves away from zero), on the host and the device.

A frozen copy of the port's utils/rounding.py (``py2_round_array``,
``py2_round_device_i32``). Both decide with the exact fraction comparison
``|x| - floor(|x|) >= 0.5``, never ``floor(x + 0.5)`` (which rounds a
near-half value up across the tie), so spot keys cannot diverge between
the host and the device. The device form is computed through ``|x|`` so
that, for ``|x| < 2^23``, ``|x| - floor(|x|)`` is exact in float32.
"""

from __future__ import annotations

import numpy as np
import torch


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
