"""One experiment step over a [F, C, H, W] float32 tensor, in plain torch.

Frozen copy of the one-device ``parallel/mesh.py::experiment_step`` of the
port for the mexican-hat photometry: registration of consecutive cycles,
detection and fit of every image, the kept fits compacted into a
``max_spots`` bucket by R^2, Python-2-rounded centers with the reference's
Spot box quirk, and the photometry at the kept spots.
"""

from __future__ import annotations

import torch

from .candidates import topk_lowest_index
from .detect import detect_and_fit_batch, identity
from .photometry import mexican_hat_batch
from .registration import phase_correlate_stack
from .rounding import py2_round_device_i32


def experiment_step(stack, settings, max_candidates, max_spots,
                    lowp=identity):
    """The step's host-facing outputs for ``run_experiment``: offsets_h/w
    [F, C]; spot_rh, spot_rw, spot_state, spot_cand_c, photometry
    [F, C, S]; spot_count and cand_count [F, C]."""
    F, C, H, W = stack.shape
    stack = lowp(stack.to(torch.float32))
    det, phot = settings["detect"], settings["photometry"]
    if phot["method"] != "mexican_hat":
        raise ValueError("the reference measures the mexican hat only")
    off_h, off_w, _, _ = phase_correlate_stack(
        stack, settings["registration"]["upsample_factor"])
    imgs = stack.reshape(F * C, H, W)
    res = detect_and_fit_batch(
        imgs, median_filter_size=det["median_filter_size"],
        c_std=det["c_std"], r_2_threshold=det["r_2_threshold"],
        consolidation_radius=det["consolidation_radius"],
        max_candidates=max_candidates, num_iters=det["num_iters"],
        theta_starts=det["theta_starts"], lowp=lowp)
    keep_flat = res.keep.reshape(F * C, max_candidates)
    spot_count = keep_flat.sum(dim=-1, dtype=torch.int32)
    # NaN R^2 fits rank below every finite one; ties in candidate order.
    r2_rank = torch.where(torch.isnan(res.r2), -torch.inf, res.r2)
    score = torch.where(keep_flat, torch.clamp_min(r2_rank, -1e30),
                        -torch.inf)
    top_score, top_idx = topk_lowest_index(score, max_spots)
    spot_valid = top_score > -torch.inf
    sh = torch.gather(res.center_h, 1, top_idx)
    sw = torch.gather(res.center_w, 1, top_idx)
    rh_i = py2_round_device_i32(sh)
    rw_i = py2_round_device_i32(sw)
    r_box = 2
    ok_plain = ((rh_i >= r_box) & (rh_i + r_box < H) &
                (rw_i >= r_box) & (rw_i + r_box < W))
    in_h = (sh >= r_box) & (sh < H - r_box)
    in_w = (sw >= r_box) & (sw < W - r_box)
    quirk_keep = ok_plain | ~(~in_h & in_w)
    wild = (~(torch.isfinite(sh) & torch.isfinite(sw)) |
            (torch.abs(rh_i) > 0x7FFF) | (torch.abs(rw_i) > 0x7FFF))
    rh_i = torch.where(wild, 0, rh_i)
    rw_i = torch.where(wild, 0, rw_i)
    spot_state = spot_valid.to(torch.int8) * (1 + quirk_keep.to(torch.int8))
    spot_state = torch.where(wild & spot_valid,
                             torch.tensor(3, dtype=torch.int8,
                                          device=stack.device), spot_state)
    r = phot["radius"]
    rch = torch.clamp(rh_i, r, H - r - 1)
    rcw = torch.clamp(rw_i, r, W - r - 1)
    values = lowp(mexican_hat_batch(imgs, rch, rcw,
                                    brim_size=phot["brim_size"], radius=r))
    values = torch.where(spot_valid, values, torch.zeros_like(values))

    def fc(x):
        return x.reshape(F, C, *x.shape[1:]).cpu().numpy()

    return {"offsets_h": off_h.cpu().numpy(),
            "offsets_w": off_w.cpu().numpy(),
            "spot_rh": fc(rh_i), "spot_rw": fc(rw_i),
            "spot_state": fc(spot_state), "spot_cand_c": fc(top_idx),
            "photometry": fc(values), "spot_count": fc(spot_count),
            "cand_count": fc(res.cand_count)}
