"""Entry: ``Pipeline.run_zstack`` on a host uint16 [T, H, W] stack, with
the lean keep-first fetch.

``check`` runs the plain reference (``fsbench.reference``) on the same
stack, in groups of ``GROUP_FRAMES`` frames as the port runs them, and
compares the lean buckets:

- ``cand_count``: candidates per frame that differ, over the reference's
  candidates (the background and the candidate map);
- ``spot_count``: kept fits per frame that differ, over the reference's;
- ``kept``: kept (frame, candidate pixel) entries that one side lacks,
  over the reference's (the fits, the R^2 gate and the NMS);
- ``center_px``: the largest difference of a kept fit's center (px);
- ``amplitude``: the largest relative difference of a kept fit's
  amplitude;
- ``offset_counts``: the largest difference of a kept fit's constant
  offset, in camera counts (what the background subtraction left);
- ``r2``: the largest difference of a kept fit's R^2;
each of the last four on the entries both sides kept.
"""

from __future__ import annotations

import numpy as np
import torch

from . import common

GROUP_FRAMES = 8


def images_per_call(config):
    return config["frames"]


class Driver:
    def __init__(self, config, workdir, device, profile=False):
        self.pipe = common.pipeline(config, device, profile)
        self.kw = config["call"]

    def call(self, stack, keep=False):
        return {"result": self.pipe.run_zstack(stack, lean=True, **self.kw)}


def _subtracted(stack, lo, config, device, lowp):
    from fsbench.reference.background import stack_background, widen

    kw = config["call"]
    x = torch.from_numpy(stack[lo:lo + GROUP_FRAMES].astype(np.int32)
                         ).to(device)
    bg = lowp(stack_background(x, box_size=kw["box_size"],
                               filter_size=kw["filter_size"]))
    return lowp(widen(x) - bg)


def reference(stack, config, device, lowp=None):
    """The reference's lean buckets for a host uint16 [T, H, W] stack."""
    from fsbench.reference.detect import (detect_and_fit_batch, identity,
                                          pack_spot_buckets)

    lowp = lowp or identity
    det = config["settings"]["detect"]
    kw = config["call"]
    parts = []
    for lo in range(0, stack.shape[0], GROUP_FRAMES):
        sub = _subtracted(stack, lo, config, device, lowp)
        res = detect_and_fit_batch(
            sub, median_filter_size=det["median_filter_size"],
            c_std=det["c_std"], r_2_threshold=det["r_2_threshold"],
            consolidation_radius=det["consolidation_radius"],
            max_candidates=kw["max_candidates"], num_iters=det["num_iters"],
            theta_starts=det["theta_starts"], lowp=lowp)
        parts.append(pack_spot_buckets(res, kw["max_spots"]))
        del sub, res
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _kept(buckets):
    """{(frame, cand_h, cand_w): slot index} of the kept entries."""
    t, s = np.nonzero(buckets["keep"])
    return {(int(a), int(buckets["cand_h"][a, b]),
             int(buckets["cand_w"][a, b])): (a, b) for a, b in zip(t, s)}


def compare(got, want):
    res = got["result"]
    if res["cand_count"].shape != want["cand_count"].shape:
        return {n: float("inf") for n in (
            "cand_count", "spot_count", "kept", "center_px", "amplitude",
            "offset_counts", "r2")}
    cand = np.abs(res["cand_count"].astype(np.int64) -
                  want["cand_count"]).sum() / max(want["cand_count"].sum(), 1)
    spots = np.abs(res["spot_count"].astype(np.int64) -
                   want["spot_count"]).sum() / max(want["spot_count"].sum(),
                                                   1)
    mine, ref = _kept(res), _kept(want)
    kept = common.multiset_mismatch(list(mine), list(ref))
    both = [k for k in ref if k in mine]
    a = tuple(np.array([mine[k][i] for k in both], np.int64)
              for i in range(2))
    b = tuple(np.array([ref[k][i] for k in both], np.int64)
              for i in range(2))

    def gap(name, index=None):
        x, y = res[name][a], want[name][b]
        if index is not None:
            x, y = x[:, index], y[:, index]
        d = np.abs(x.astype(np.float64) - y)
        # NaN on both sides agrees; NaN on one side is as far as can be.
        d[np.isnan(x) & np.isnan(y)] = 0.0
        return np.where(np.isnan(d), np.inf, d)

    amp_ref = np.abs(want["params"][b][:, 1].astype(np.float64))
    if not both:
        inf = float("inf")
        return {"cand_count": float(cand), "spot_count": float(spots),
                "kept": kept, "center_px": inf, "amplitude": inf,
                "offset_counts": inf, "r2": inf}
    return {"cand_count": float(cand), "spot_count": float(spots),
            "kept": kept,
            "center_px": max(common.max_or_zero(gap("center_h")),
                             common.max_or_zero(gap("center_w"))),
            "amplitude": common.max_or_zero(
                gap("params", 1) / np.maximum(amp_ref, 1e-6)),
            "offset_counts": common.max_or_zero(gap("params", 0)),
            "r2": common.max_or_zero(gap("r2"))}


def read_sample(sample):
    return sample


def check(stack, sample, config, device):
    return compare(sample, reference(stack, config, device))


def as_sample(ref):
    """A reference answer in the form of a sample (the control)."""
    return {"result": ref}


def kernel_work(stack, config, device):
    """Work of kernels A and B for one call on ``stack``: the pixels of
    the candidate maps and the fits that the inputs need (each frame's
    candidates after the reference's background, capped at the
    bucket)."""
    from fsbench.reference.detect import candidate_counts, identity

    det = config["settings"]["detect"]
    fits = 0
    for lo in range(0, stack.shape[0], GROUP_FRAMES):
        sub = _subtracted(stack, lo, config, device, identity)
        counts = candidate_counts(sub, det["median_filter_size"],
                                  det["c_std"])
        fits += int(torch.clamp(counts, max=config["call"]["max_candidates"]
                                ).sum())
    return {"pixels": int(np.prod(stack.shape)), "fits": fits,
            "num_iters": det["num_iters"],
            "theta_starts": det["theta_starts"]}
