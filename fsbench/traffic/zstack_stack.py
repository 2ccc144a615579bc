"""One field watched over a z or time axis: persistent spots on a sloped,
breathing background.

The distributions of ``make_zstack`` in the port's ``utils/synth.py`` (the
z-stack workload), drawn on the device: ``spots`` spots at subpixel
centers U(border, size - border) with amplitudes U(lo, hi), Gaussian
stamps of ``sigma``; a background ``base + slope_y * y + slope_x * x``
plus a Gaussian bump, all scaled by ``1 + breathing * sin(t /
breathing_period)`` in frame t; noise N(0, noise). Frames go to the host
as raw uint16 camera counts [T, H, W].
"""

from __future__ import annotations

import torch

from .spots import render, seeded, to_camera, uniform


def generate(params, config, seed, index, device, return_truth=False):
    T, H, W = config["frames"], config["height"], config["width"]
    g = seeded(seed, index, device)
    n = params["spots"]
    b = params["border"]
    pos = torch.stack([uniform(b, H - b, (n,), g, device),
                       uniform(b, W - b, (n,), g, device)], dim=-1)
    amp = uniform(*params["amplitude"], (n,), g, device)
    field = render(1, H, W, torch.zeros(n, dtype=torch.int64, device=device),
                   pos[:, 0], pos[:, 1], amp, params["sigma"],
                   params["stamp_radius"], device)[0]
    yy = torch.arange(H, device=device, dtype=torch.float64)[:, None]
    xx = torch.arange(W, device=device, dtype=torch.float64)[None, :]
    bump = params["bump"]
    base = (params["base"] + params["slope"][0] * yy +
            params["slope"][1] * xx +
            bump["amplitude"] * torch.exp(
                -((yy - bump["center"][0]) ** 2 +
                  (xx - bump["center"][1]) ** 2) /
                (2 * bump["sigma"] ** 2)))
    t = torch.arange(T, device=device, dtype=torch.float64)
    scale = 1.0 + params["breathing"] * torch.sin(
        t / params["breathing_period"])
    noise = torch.randn((T, H, W), generator=g, device=device,
                        dtype=torch.float32) * params["noise"]
    frames = base[None] * scale[:, None, None] + field[None] + noise
    stack = to_camera(frames)
    if return_truth:
        return stack, {"positions": pos.cpu().numpy(),
                       "amplitudes": amp.cpu().numpy()}
    return stack
