"""Entry: ``Pipeline.run_timetrace`` on a host uint16 [T, H, W] movie,
writing the timetrace CSV with the step-fit and intermediate columns.

``check`` runs the plain reference (``fsbench.reference``) on the same
movie: frame 0's detection on the exhaustive path (the existing reference
modules, with a bucket that holds every candidate), the tracker and the
per-frame photometry (``reference/lctrack.py``), the step-fit chain
(``reference/stepfit.py``) and the CSV (``reference/timetrace_csv.py``),
and compares:

- ``traces``: tracks (by their start key) that one side lacks, over the
  reference's tracks;
- ``track_px``: the largest gap of a tracked position, in px, over the
  frames where either side has the track; a frame where only one side has
  it counts as a gap of the frame's larger side;
- ``photometry``: the largest gap of a photometry, over the median
  magnitude of the reference's photometries;
- ``plateaus``: traces whose t-filtered plateaus (starts and stops, and
  heights to 1e-9 relative) differ or that one side lacks, over the
  reference's traces;
- ``csv``: lines of the CSV that one side lacks, over the reference's
  lines, each line without its running trace number (the start key in
  the next two fields names the trace, so one lost track costs its own
  lines, not every later one's);
each of the middle three on the tracks both sides have.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import common

_NUMBERS = ("traces", "track_px", "photometry", "plateaus", "csv")


def images_per_call(config):
    return config["frames"]


class Driver:
    """The timed call; ``keep`` writes the CSV to a file of its own so
    that the sampled call's file outlives the window."""

    def __init__(self, config, workdir, device, profile=False):
        self.pipe = common.pipeline(config, device, profile)
        self.kw = config["call"]
        self.paths = {keep: os.path.join(workdir, prefix + "timetrace.csv")
                      for keep, prefix in ((True, "sample_"), (False, ""))}

    def call(self, movie, keep=False):
        path = self.paths[keep]
        res = self.pipe.run_timetrace(movie, csv_path=path, **self.kw)
        return {"result": res, "csv": path, "size": max(movie.shape[1:])}


def frame0_starts(frame, config, lowp):
    """Start keys of frame 0 ((H, W) float32 tensor) by the reference's
    detection with every candidate in the bucket."""
    from fsbench.reference.detect import candidate_counts, \
        detect_and_fit_batch
    from fsbench.reference.lctrack import start_keys

    det = config["settings"]["detect"]
    img = frame[None]
    count = int(candidate_counts(img, det["median_filter_size"],
                                 det["c_std"])[0])
    res = detect_and_fit_batch(
        img, median_filter_size=det["median_filter_size"],
        c_std=det["c_std"], r_2_threshold=det["r_2_threshold"],
        consolidation_radius=det["consolidation_radius"],
        max_candidates=max(count, 1), num_iters=det["num_iters"],
        theta_starts=det["theta_starts"], lowp=lowp)
    return start_keys(res.keep[0].cpu().numpy(),
                      res.center_h[0].cpu().numpy(),
                      res.center_w[0].cpu().numpy())


def reference(movie, config, device, lowp=None):
    """The reference's answer for a host uint16 [T, H, W] movie."""
    from fsbench.reference import lctrack, stepfit, timetrace_csv
    from fsbench.reference.detect import identity

    lowp = lowp or identity
    kw = config["call"]
    phot = config["settings"]["photometry"]
    if phot["method"] != "mexican_hat" or kw["photometry_min"] is not None:
        raise ValueError("the reference measures the mexican hat with no "
                         "floor only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = lowp(torch.from_numpy(movie.astype(np.float32)).to(device))
    h0, w0 = frame0_starts(x[0], config, lowp)
    rec_h, rec_w, present = lctrack.track(
        x, h0, w0, search_radius=kw["search_radius"],
        s_n_cutoff=kw["s_n_cutoff"])
    phots = lctrack.photometries(x, rec_h, rec_w, present,
                                 radius=phot["radius"],
                                 brim_size=phot["brim_size"], lowp=lowp)
    del x
    fits = stepfit.stepfit_chain(
        phots, mirror_start=kw["mirror_start"],
        chung_kennedy=kw["chung_kennedy"], p_threshold=kw["p_threshold"],
        device=device, lowp=lowp)
    return {"h": h0, "w": w0, "size": max(movie.shape[1:]),
            "rec_h": rec_h, "rec_w": rec_w,
            "present": present, "photometries": phots,
            "t_filtered": [f[3] for f in fits],
            "csv": timetrace_csv.csv_text(h0, w0, fits, movie.shape[0])}


def _plateaus_differ(a, b):
    if len(a) != len(b):
        return True
    for (s1, e1, h1), (s2, e2, h2) in zip(a, b):
        if s1 != s2 or e1 != e2 or \
                not abs(h1 - h2) <= 1e-9 * max(abs(h2), 1.0):
            return True
    return False


def _keyed_lines(text):
    """The CSV's lines without their first field (the running trace
    number)."""
    return [line.split(",", 1)[-1] for line in text.splitlines()]


def compare(got, want):
    """The numbers compared (see the module docstring); ``got`` and
    ``want`` in the form ``read_sample`` gives."""
    mine = {k: i for i, k in enumerate(zip(got["h"].tolist(),
                                           got["w"].tolist()))}
    ref = {k: i for i, k in enumerate(zip(want["h"].tolist(),
                                          want["w"].tolist()))}
    n_ref = max(len(ref), 1)
    traces = common.multiset_mismatch(list(mine), list(ref))
    both = [k for k in ref if k in mine]
    if not both or got["rec_h"].shape[0] != want["rec_h"].shape[0]:
        return {n: (traces if n == "traces" else float("inf"))
                for n in _NUMBERS}
    a = np.array([mine[k] for k in both])
    b = np.array([ref[k] for k in both])
    pa, pb = got["present"][:, a], want["present"][:, b]
    gap = np.maximum(
        np.abs(got["rec_h"][:, a].astype(np.int64) - want["rec_h"][:, b]),
        np.abs(got["rec_w"][:, a].astype(np.int64) - want["rec_w"][:, b]))
    gap = np.where(pa & pb, gap, 0)
    gap = np.where(pa != pb, want["size"], gap)
    track_px = float(gap.max(initial=0))
    ph_ref = np.asarray(want["photometries"], np.float64)
    scale = max(float(np.median(np.abs(ph_ref))), 1.0)
    d = np.abs(np.asarray(got["photometries"], np.float64)[a] - ph_ref[b])
    photometry = float(np.where(np.isnan(d), np.inf, d).max()) / scale
    differ = sum(_plateaus_differ(got["t_filtered"][i], want["t_filtered"][j])
                 for i, j in zip(a.tolist(), b.tolist()))
    differ += (len(ref) - len(both)) + (len(mine) - len(both))
    csv_gap = common.multiset_mismatch(_keyed_lines(got["csv"]),
                                       _keyed_lines(want["csv"]))
    return {"traces": traces, "track_px": track_px,
            "photometry": photometry, "plateaus": differ / n_ref,
            "csv": csv_gap}


def read_sample(sample):
    """The sampled call's tracks, photometries, t-filtered plateaus and
    CSV text."""
    res = sample["result"]
    tr = res["traces"]
    h = np.asarray(tr["h"], np.int64)
    w = np.asarray(tr["w"], np.int64)
    t_filtered = [list(res["step_fits"][k].trace) for k in
                  zip(tr["h"], tr["w"])]
    with open(sample["csv"], newline="") as fh:
        text = fh.read()
    T = res["photometries"].shape[1]
    empty = np.zeros((T, 0), np.int32)
    return {"h": h, "w": w, "size": sample["size"],
            "rec_h": empty if tr["rec_h"] is None else tr["rec_h"],
            "rec_w": empty if tr["rec_w"] is None else tr["rec_w"],
            "present": (empty.astype(bool) if tr["present"] is None
                        else tr["present"]),
            "photometries": np.asarray(res["photometries"], np.float64),
            "t_filtered": t_filtered, "csv": text}


def check(movie, sample, config, device):
    return compare(read_sample(sample), reference(movie, config, device))


def as_sample(ref):
    """A reference answer in the form of a read sample (the control)."""
    return ref


def kernel_work(movie, config, device):
    """Work of kernels A and B for one call on ``movie``: frame 0's pixels
    and its candidates, each fitted once on the exhaustive path."""
    from fsbench.reference.detect import candidate_counts

    det = config["settings"]["detect"]
    x = torch.from_numpy(movie[:1].astype(np.float32)).to(device)
    fits = int(candidate_counts(x, det["median_filter_size"],
                                det["c_std"]).sum())
    return {"pixels": int(np.prod(movie.shape[1:])), "fits": fits,
            "num_iters": det["num_iters"],
            "theta_starts": det["theta_starts"]}
