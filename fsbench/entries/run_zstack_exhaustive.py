"""Entry: ``Pipeline.run_zstack(max_candidates="exhaustive")`` on a host
uint16 [T, H, W] stack: every above-threshold candidate of every frame
fitted through the chunked path, the NMS on the host, the full schema
fetched (K = chunks x 4,096, padded to the widest group).

``check`` runs the plain reference (``fsbench.reference``) on the same
stack, in groups of ``GROUP_FRAMES`` frames as the port runs them: the
reference background, then detection and fits with a bucket as large as
the group's largest candidate count, so that no candidate is cut, and the
fixpoint NMS (``reference/consolidate.py``), an algorithm independent of
the port's greedy binned loop (``consolidate_host``) with the same
semantics. It compares the numbers of ``run_zstack.py``'s check
(``cand_count``, ``spot_count``, ``kept``, ``center_px``, ``amplitude``,
``offset_counts``, ``r2``) on the full schema: ``spot_count`` is a frame's
kept fits (``keep.sum(1)``) on both sides, and kept entries are keyed by
(frame, cand_h, cand_w), so neither side's chunk layout nor its padding
matters.
"""

from __future__ import annotations

import numpy as np
import torch

from . import common
# ``compare`` is run_zstack.py's: it reads the kept fits of a read sample
# (the port's full schema with ``spot_count``) against the reference's.
from .run_zstack import GROUP_FRAMES, _subtracted, compare  # noqa: F401


def images_per_call(config):
    return config["frames"]


class Driver:
    def __init__(self, config, workdir, device, profile=False):
        self.pipe = common.pipeline(config, device, profile)
        self.kw = config["call"]

    def call(self, stack, keep=False):
        return {"result": self.pipe.run_zstack(stack, **self.kw)}


def _true_counts(sub, det, lowp):
    """(B,) candidates of each frame of ``sub``, from the maps the
    reference's detection computes (``lowp`` rounded)."""
    from fsbench.reference.candidates import _threshold_and_extract_batch
    from fsbench.reference.detect import candidate_maps

    cms = candidate_maps(sub, det["median_filter_size"], lowp)
    _, _, _, count = _threshold_and_extract_batch(cms, 1,
                                                  float(det["c_std"]))
    return count.to(torch.int64)


def _join(parts):
    """Concatenate the groups' keep-first buckets over frames, each padded
    to the widest with unkept, invalid slots."""
    width = max(p["keep"].shape[1] for p in parts)

    def pad(a):
        extra = [(0, 0), (0, width - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
        return np.pad(a, extra)

    return {k: (np.concatenate([p[k] for p in parts]) if parts[0][k].ndim == 1
                else np.concatenate([pad(p[k]) for p in parts]))
            for k in parts[0]}


def reference(stack, config, device, lowp=None):
    """The reference's kept fits for a host uint16 [T, H, W] stack, in the
    keep-first form of ``pack_spot_buckets`` (every kept fit of a frame,
    then padding), with ``spot_count`` and the true ``cand_count``. Float32
    on the card means no TF32 in its matmuls and convolutions."""
    from fsbench.reference.detect import (detect_and_fit_batch, identity,
                                          pack_spot_buckets)

    lowp = lowp or identity
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    det = config["settings"]["detect"]
    parts = []
    for lo in range(0, stack.shape[0], GROUP_FRAMES):
        sub = _subtracted(stack, lo, config, device, lowp)
        bucket = max(int(_true_counts(sub, det, lowp).max()), 1)
        res = detect_and_fit_batch(
            sub, median_filter_size=det["median_filter_size"],
            c_std=det["c_std"], r_2_threshold=det["r_2_threshold"],
            consolidation_radius=det["consolidation_radius"],
            max_candidates=bucket, num_iters=det["num_iters"],
            theta_starts=det["theta_starts"], lowp=lowp)
        kept = max(int(res.keep.sum(dim=1).max()), 1)
        parts.append(pack_spot_buckets(res, kept))
        del sub, res
    return _join(parts)


def read_sample(sample):
    """The port's full schema with each frame's kept fits counted."""
    res = sample["result"]
    return {"result": dict(res, spot_count=res["keep"].sum(
        axis=1, dtype=np.int32))}


def check(stack, sample, config, device):
    return compare(read_sample(sample), reference(stack, config, device))


def as_sample(ref):
    """A reference answer in the form of a read sample (the control)."""
    return {"result": ref}


def kernel_work(stack, config, device):
    """Work of kernels A and B for one call on ``stack``: the pixels of
    the candidate maps and every candidate of every frame after the
    reference's background, each fitted once (no cap)."""
    from fsbench.reference.detect import identity

    det = config["settings"]["detect"]
    fits = 0
    for lo in range(0, stack.shape[0], GROUP_FRAMES):
        sub = _subtracted(stack, lo, config, device, identity)
        fits += int(_true_counts(sub, det, identity).sum())
    return {"pixels": int(np.prod(stack.shape)), "fits": fits,
            "num_iters": det["num_iters"],
            "theta_starts": det["theta_starts"]}
