"""A sequencing run's stack: fields of persistent spots imaged cycle after
cycle, with dropouts and stage drift.

The distributions of ``make_experiment_stack`` in the port's
``utils/synth.py`` (the full-experiment workload), drawn on the device:
noise N(mean, std) per pixel; ``spots_per_field`` spots a field at
subpixel centers U(border, size - border); amplitudes U(lo, hi); each
spot present in a later cycle with probability ``presence`` (always in
cycle 0); an integer drift of ``drift[0]..drift[1]`` px a cycle on each
axis, cumulative and shared by every field (cycle c shows a spot planted
at p at p - drift[c]); Gaussian stamps of ``sigma`` on a square of
``stamp_radius``. Frames go to the host as raw uint16 camera counts
[F, C, H, W], as a lab's files arrive.
"""

from __future__ import annotations

import torch

from .spots import render, seeded, to_camera, uniform


def generate(params, config, seed, index, device, return_truth=False):
    F, C = config["fields"], config["cycles"]
    H, W = config["height"], config["width"]
    g = seeded(seed, index, device)
    n = params["spots_per_field"]
    b = params["border"]
    lo, hi = params["drift"]
    steps = torch.randint(lo, hi + 1, (C - 1, 2), generator=g,
                          device=device)
    drift = torch.cat([torch.zeros((1, 2), dtype=torch.int64,
                                   device=device), steps.cumsum(0)])
    pos = torch.stack([uniform(b, H - b, (F, n), g, device),
                       uniform(b, W - b, (F, n), g, device)], dim=-1)
    amp = uniform(*params["amplitude"], (F, n), g, device)
    present = torch.rand((F, n, C), generator=g, device=device) < \
        params["presence"]
    present[:, :, 0] = True
    mean, std = params["noise"]
    frames = torch.empty((F, C, H, W), dtype=torch.float64, device=device)
    cyc = torch.arange(C, device=device)[None, :].expand(n, C)
    for f in range(F):
        keep = present[f]
        ph = pos[f, :, None, 0] - drift[None, :, 0]
        pw = pos[f, :, None, 1] - drift[None, :, 1]
        frames[f] = render(C, H, W, cyc[keep], ph[keep], pw[keep],
                           amp[f, :, None].expand(n, C)[keep],
                           params["sigma"], params["stamp_radius"], device)
    noise = torch.randn((F, C, H, W), generator=g, device=device,
                        dtype=torch.float32)
    frames += noise * std + mean
    stack = to_camera(frames)
    if return_truth:
        return stack, {"positions": pos.cpu().numpy(),
                       "amplitudes": amp.cpu().numpy(),
                       "presence": present.cpu().numpy(),
                       "drift": drift.cpu().numpy()}
    return stack
