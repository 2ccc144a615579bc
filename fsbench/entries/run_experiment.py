"""Entry: ``Pipeline.run_experiment`` on a host uint16 [F, C, H, W] stack,
writing the track-photometries CSV and the filtered category CSV.

``check`` runs the plain reference (``fsbench.reference``) on the same
stack and compares what the call returned and wrote with it:

- ``spot_count``: the relative difference of the spots tracked (kept fits
  after the rounded-center dedupe and the box rule);
- ``rows``: rows (field, h, w, category) that one side lacks, over the
  reference's rows: registration (the cumulative offsets place every
  tracked and filled-in spot), tracking, fill-in and categories;
- ``photometry``: the largest difference of a row's photometry in any
  cycle (detected spots and hole gathers), over the median magnitude of
  the reference's values, on the rows both sides have;
- ``categories``: per-field category counts that differ, over the traces;
- ``track_csv``: lines of the track-photometries CSV that either side
  lacks, over the reference's lines;
- ``category_csv``: the counts of the category CSV that differ, over the
  reference's total.

The registration offsets are not compared on their own: they come in
steps of 1/upsample_factor px, and the control reads them equal; a wrong
offset moves every position the rows hold.
"""

from __future__ import annotations

import csv
import io
import os

import numpy as np
import torch

from . import common

GROUP_FIELDS = 8


def images_per_call(config):
    return config["fields"] * config["cycles"]


class Driver:
    """The timed call; ``keep`` writes the CSVs to files of their own so
    that the sampled call's files outlive the window."""

    def __init__(self, config, workdir, device, profile=False):
        self.pipe = common.pipeline(config, device, profile)
        self.kw = config["call"]
        self.paths = {
            keep: (os.path.join(workdir, prefix + "tracks.csv"),
                   os.path.join(workdir, prefix + "categories.csv"))
            for keep, prefix in ((True, "sample_"), (False, ""))}

    def call(self, stack, keep=False):
        track, cats = self.paths[keep]
        res = self.pipe.run_experiment(stack, csv_path=track,
                                       category_csv_path=cats, **self.kw)
        return {"result": res, "track_csv": track, "category_csv": cats}


def reference(stack, config, device, lowp=None):
    """The reference's answer for a host uint16 [F, C, H, W] stack."""
    from fsbench.reference import experiment as ex
    from fsbench.reference.detect import identity
    from fsbench.reference.step import experiment_step

    lowp = lowp or identity
    F, C, H, W = stack.shape
    kw = config["call"]
    settings = config["settings"]
    per_field = []
    spot_count = 0
    for lo in range(0, F, GROUP_FIELDS):
        x = torch.from_numpy(stack[lo:lo + GROUP_FIELDS].astype(np.int32)
                             ).to(device).to(torch.float32)
        out = experiment_step(x, settings, kw["max_candidates"],
                              kw["max_spots"], lowp)
        rows, n = ex.experiment_host_half(
            out, lowp(x).reshape(-1, H, W), x.shape[0], C, (H, W), settings,
            kw["candidate_radius"], lowp)
        per_field += rows
        spot_count += n
        del x, out
    rows, counts = [], {}
    for f, field_rows in enumerate(per_field):
        counts[f] = {}
        for cat, h0, w0, ph in field_rows:
            rows.append(("ch1", f, h0, w0, cat, ph))
            counts[f][cat] = counts[f].get(cat, 0) + 1
    filtered = ex.filter_monotone({"ch1": counts})
    return {"rows": rows, "category_counts": {"ch1": counts},
            "spot_count": spot_count,
            "track_csv": ex.track_csv_text(rows, C),
            "category_csv": ex.category_csv_text(filtered)}


def compare(got, want):
    """The numbers compared (see the module docstring); ``got`` holds the
    program's result dict and both CSVs' text."""
    res = got["result"]
    n_spots = res["summary"]["ch1"]["spot_count"]
    spot_count = abs(n_spots - want["spot_count"]) / max(
        want["spot_count"], 1)

    def key(r):
        return (r[1], r[2], r[3], r[4])

    rows = common.multiset_mismatch([key(r) for r in res["rows"]],
                                    [key(r) for r in want["rows"]])
    mine = {}
    for r in res["rows"]:
        mine.setdefault(key(r), np.asarray(r[5], np.float64))
    ref_vals = np.concatenate([np.asarray(r[5], np.float64)
                               for r in want["rows"]] or [np.zeros(1)])
    scale = max(float(np.median(np.abs(ref_vals))), 1.0)
    gaps = [np.max(np.abs(mine[key(r)] - np.asarray(r[5], np.float64)))
            for r in want["rows"] if key(r) in mine]
    photometry = common.max_or_zero(gaps) / scale if gaps else float("inf")
    got_counts = res["category_counts"].get("ch1", {})
    want_counts = want["category_counts"]["ch1"]
    diff = 0
    for f in set(got_counts) | set(want_counts):
        a, b = got_counts.get(f, {}), want_counts.get(f, {})
        diff += sum(abs(a.get(c, 0) - b.get(c, 0)) for c in set(a) | set(b))
    categories = diff / max(len(want["rows"]), 1)
    track_csv = common.multiset_mismatch(got["track_csv_text"].splitlines(),
                                         want["track_csv"].splitlines())
    category_csv = _count_mismatch(got["category_csv_text"],
                                   want["category_csv"])
    return {"spot_count": spot_count, "rows": rows,
            "photometry": photometry, "categories": categories,
            "track_csv": track_csv, "category_csv": category_csv}


def _count_mismatch(got_text, want_text):
    """Sum of |count differences| per (pattern, channel) of two category
    CSVs, over the reference's total count."""
    def counts(text):
        rows = list(csv.reader(io.StringIO(text)))[1:]
        return {(r[0], r[1]): int(r[2]) for r in rows}
    try:
        a = counts(got_text)
    except (ValueError, IndexError):
        return float("inf")
    b = counts(want_text)
    diff = sum(abs(a.get(k, 0) - b.get(k, 0)) for k in set(a) | set(b))
    return diff / max(sum(b.values()), 1)


def read_sample(sample):
    """The sampled call's result with its two CSVs read back."""
    out = dict(sample)
    with open(sample["track_csv"], newline="") as fh:
        out["track_csv_text"] = fh.read()
    with open(sample["category_csv"], newline="") as fh:
        out["category_csv_text"] = fh.read()
    return out


def check(stack, sample, config, device):
    return compare(read_sample(sample), reference(stack, config, device))


def as_sample(ref):
    """A reference answer in the form of a read sample (the control)."""
    return {"result": {"rows": ref["rows"],
                       "summary": {"ch1": {"spot_count": ref["spot_count"]}},
                       "category_counts": ref["category_counts"]},
            "track_csv_text": ref["track_csv"],
            "category_csv_text": ref["category_csv"]}


def kernel_work(stack, config, device):
    """Work of kernels A and B for one call on ``stack``: the pixels of
    the candidate maps and the fits that the inputs need (each image's
    candidates, capped at the bucket), counted by the reference's own
    extraction."""
    from fsbench.reference.detect import candidate_counts

    F, C, H, W = stack.shape
    det = config["settings"]["detect"]
    fits = 0
    for lo in range(0, F, GROUP_FIELDS):
        x = torch.from_numpy(stack[lo:lo + GROUP_FIELDS].astype(np.int32)
                             ).to(device).to(torch.float32)
        counts = candidate_counts(x.reshape(-1, H, W),
                                  det["median_filter_size"], det["c_std"])
        fits += int(torch.clamp(counts, max=config["call"]["max_candidates"]
                                ).sum())
    return {"pixels": F * C * H * W, "fits": fits,
            "num_iters": det["num_iters"],
            "theta_starts": det["theta_starts"]}
