"""One field filmed continuously while its dyes photobleach.

The distributions of ``make_movie`` in the port's ``utils/synth.py`` (the
basic_timetrace_script workload), drawn on the device: ``spots`` spots at
subpixel centers U(border, size - border), each with ``dyes`` dyes drawn
uniformly from [lo, hi]; a spot's bleach frames are drawn without
replacement from ``bleach_frames`` [first, last] (one dye lost at each),
and it is gone once its last dye is; every dye adds ``dye_counts`` at the
peak of a Gaussian of ``sigma``; the spot wanders by a cumulative
N(0, ``wander``) px a frame on each axis; the background is
N(noise[0], noise[1]). Stamps are summed with the fixed-point
accumulation of ``spots.render``. Frames go to the host as raw uint16
camera counts [T, H, W].
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
    lo, hi = params["dyes"]
    dyes = torch.randint(lo, hi + 1, (n,), generator=g, device=device)
    first, last = params["bleach_frames"]
    # Without replacement: the first ``dyes`` of a random permutation of
    # the candidate frames.
    perm = torch.argsort(torch.rand((n, last - first + 1), generator=g,
                                    device=device, dtype=torch.float64),
                         dim=1)[:, :hi] + first
    drops = torch.where(torch.arange(hi, device=device)[None] < dyes[:, None],
                        perm, T)
    wander = torch.cumsum(torch.randn((n, T, 2), generator=g, device=device,
                                      dtype=torch.float64) *
                          params["wander"], dim=1)
    frame = torch.arange(T, device=device)
    level = dyes[:, None] - (drops[:, None, :] <= frame[None, :, None]).sum(
        dim=-1)
    spot, f = torch.nonzero(level > 0, as_tuple=True)
    h = pos[spot, 0] + wander[spot, f, 0]
    w = pos[spot, 1] + wander[spot, f, 1]
    amp = level[spot, f].double() * params["dye_counts"]
    field = render(T, H, W, f, h, w, amp, params["sigma"],
                   params["stamp_radius"], device)
    mean, std = params["noise"]
    noise = torch.randn((T, H, W), generator=g, device=device,
                        dtype=torch.float32) * std + mean
    movie = to_camera(noise + field)
    if return_truth:
        return movie, {"positions": pos.cpu().numpy(),
                       "dyes": dyes.cpu().numpy(),
                       "drops": torch.sort(drops, dim=1).values.cpu().numpy(),
                       "levels": level.cpu().numpy()}
    return movie
