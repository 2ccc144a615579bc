"""Planted Gaussian spots, drawn and rendered on the device.

Shared by the generators: ``seeded`` turns a run's seed and an input's
index into a ``torch.Generator`` on the device, ``render`` sums Gaussian
stamps into images with a fixed-point integer accumulation, so that the
same draws give the same pixels whatever order the device adds them in.
"""

from __future__ import annotations

import torch

# Sixteen fractional bits of a camera count in the accumulation.
_FIXED = 65536.0


def seeded(seed, index, device):
    """A generator on ``device`` for input ``index`` of a run with
    ``seed`` (any integer; large ones are folded into 63 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + int(index) * 7919 + 17) % (1 << 63))
    return g


def uniform(lo, hi, shape, g, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                       dtype=torch.float64)


def render(n_images, H, W, img, h, w, amp, sigma, radius, device):
    """(n_images, H, W) float64 sums of ``amp * exp(-((y - h)^2 +
    (x - w)^2) / (2 sigma^2))`` over the spots, each on the square of
    pixels from ``trunc(h) - radius`` to ``trunc(h) + radius`` (and the
    same in w) clipped to its image ``img``."""
    d = torch.arange(-radius, radius + 1, device=device)
    ys = torch.trunc(h).long()[:, None] + d
    xs = torch.trunc(w).long()[:, None] + d
    vy = torch.exp(-(ys - h[:, None]) ** 2 / (2 * sigma ** 2))
    vx = torch.exp(-(xs - w[:, None]) ** 2 / (2 * sigma ** 2))
    val = amp[:, None, None] * vy[:, :, None] * vx[:, None, :]
    ys = ys[:, :, None].expand_as(val)
    xs = xs[:, None, :].expand_as(val)
    ok = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    idx = ((img.long()[:, None, None] * H + ys) * W + xs)[ok]
    acc = torch.zeros(n_images * H * W, dtype=torch.int64, device=device)
    acc.index_add_(0, idx, torch.round(val[ok] * _FIXED).long())
    return acc.view(n_images, H, W).double() / _FIXED


def to_camera(x):
    """float frames -> host uint16 camera counts: clipped to [0, 65535]
    and truncated, as ``np.clip(x, 0, 65535).astype(np.uint16)``."""
    import numpy as np
    return torch.clamp(x, 0, 65535).to(torch.int32).cpu().numpy().astype(
        np.uint16)
