"""Python-2 rounding (halves away from zero) on the device.

Counterpart of fluorosequencingimageanalysis_tpu/utils/rounding.py
``py2_round_device_i32``: computed through ``|x|`` so that, for
``|x| < 2^23``, ``|x| - floor(|x|)`` is exact in float32 and the ``>= 0.5``
test matches the host float64 ``py2_round`` of the same value bit for bit,
negative halves included.
"""

from __future__ import annotations

import torch


def py2_round_device_i32(x):
    """int32 tensor of ``x`` rounded with halves away from zero."""
    ax = torch.abs(x)
    f = torch.floor(ax)
    r = f + (ax - f >= 0.5).to(x.dtype)
    return torch.where(x < 0, -r, r).to(torch.int32)
