"""Entry: the ``run-experiment`` subcommand on a sequencing run's image
files (``fsbench/traffic/experiment_files.py``: one directory a cycle, one
uncompressed TIFF a field), run in process through the port's
``__main__.main`` as a lab runs it over its files, writing the
track-photometries CSV and the filtered category CSV. The subcommand
reads the files (``Pipeline.run_experiment_files``) and runs
``Pipeline.run_experiment`` on their stack.

``reference`` reads the call's own files with the plain reader
(``fsbench/reference/tiff.py``) and runs the ``seqrun`` reference
(``run_experiment.reference``) on that stack. The subcommand returns no
rows, so ``compare`` works from the files it wrote:

- ``track_csv``: lines of the track-photometries CSV that either side
  lacks, over the reference's lines;
- ``rows``: rows (field, h, w, category) of that CSV that one side lacks,
  over the reference's rows;
- ``photometry``: the largest difference of a row's photometry in any
  cycle, over the median magnitude of the reference's values, on the rows
  both sides have;
- ``category_csv``: the counts of the category CSV that differ, over the
  reference's total.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json

import numpy as np

from . import common
from . import run_experiment as seqrun


def images_per_call(config):
    return config["fields"] * config["cycles"]


def cli_args(config, device):
    """The subcommand's flags for the configuration's settings. Raises
    where a setting has no flag and differs from the subcommand's
    default."""
    from fluorosequencingimageanalysis_torch.config import RegistrationConfig

    s, kw = config["settings"], config["call"]
    reg = RegistrationConfig()
    if kw["candidate_radius"] != 2 or any(
            getattr(reg, k) != v for k, v in s["registration"].items()):
        raise ValueError("run-experiment has no flag for candidate_radius "
                         "or the registration; only their defaults run")
    return ["--max-candidates", str(kw["max_candidates"]),
            "--max-spots", str(kw["max_spots"]),
            "--detect-parameters", repr(s["detect"]),
            "--photometry-parameters", repr(s["photometry"]),
            "--device", str(device)]


class Driver:
    """The timed call; ``keep`` writes the CSVs to files of their own so
    that the sampled call's files outlive the window."""

    def __init__(self, config, workdir, device, profile=False):
        from fluorosequencingimageanalysis_torch.__main__ import main

        self.main = main
        self.workdir = workdir
        self.args = cli_args(config, device) + (["--profile"] if profile
                                                else [])
        self.names = {keep: (prefix + "tracks.csv",
                             prefix + "categories.csv")
                      for keep, prefix in ((True, "sample_"), (False, ""))}

    def call(self, inputs, keep=False):
        track, cats = self.names[keep]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = self.main(["run-experiment", "--peptide-files",
                            *inputs.files, "--output-dir", self.workdir,
                            "--csv", track, "--category-csv", cats,
                            *self.args])
        if rc != 0:
            raise RuntimeError(f"run-experiment exited with {rc}")
        summary = json.loads(printed.getvalue().strip().splitlines()[-1])
        return {"summary": summary, "track_csv": summary["csv"],
                "category_csv": summary["category_csv"]}


def reference(inputs, config, device, lowp=None):
    """The reference's answer for the files of ``inputs``."""
    from fsbench.reference import tiff

    return seqrun.reference(tiff.read_stack(inputs.files), config, device,
                            lowp)


def _track_rows(text):
    """[((field, h, w, category), photometries)] of a track CSV's text;
    a value that is no number reads NaN."""
    def number(v):
        try:
            return float(v)
        except ValueError:
            return float("nan")
    rows = list(csv.reader(io.StringIO(text)))[1:]
    return [(tuple(r[1:5]), np.array([number(v) for v in r[5:]]))
            for r in rows]


def compare(got, want):
    """The numbers compared (see the module docstring); ``got`` holds both
    CSVs' text as ``read_sample`` gives them, ``want`` the reference's."""
    mine, ref = _track_rows(got["track_csv_text"]), \
        _track_rows(want["track_csv"])
    rows = common.multiset_mismatch([k for k, _ in mine],
                                    [k for k, _ in ref])
    values = {}
    for k, v in mine:
        values.setdefault(k, v)
    ref_vals = np.concatenate([v for _, v in ref] or [np.zeros(1)])
    scale = max(float(np.median(np.abs(ref_vals))), 1.0)
    gaps = [np.max(np.abs(values[k] - v)) if values[k].shape == v.shape
            else np.inf for k, v in ref if k in values]
    gaps = np.nan_to_num(gaps, nan=np.inf)
    photometry = (common.max_or_zero(gaps) / scale if len(gaps)
                  else float("inf"))
    track_csv = common.multiset_mismatch(got["track_csv_text"].splitlines(),
                                         want["track_csv"].splitlines())
    category_csv = seqrun._count_mismatch(got["category_csv_text"],
                                          want["category_csv"])
    return {"track_csv": track_csv, "rows": rows, "photometry": photometry,
            "category_csv": category_csv}


def read_sample(sample):
    """The sampled call's two CSVs, read back."""
    out = dict(sample)
    with open(sample["track_csv"], newline="") as fh:
        out["track_csv_text"] = fh.read()
    with open(sample["category_csv"], newline="") as fh:
        out["category_csv_text"] = fh.read()
    return out


def check(inputs, sample, config, device):
    return compare(read_sample(sample), reference(inputs, config, device))


def as_sample(ref):
    """A reference answer in the form of a read sample (the control)."""
    return {"track_csv_text": ref["track_csv"],
            "category_csv_text": ref["category_csv"]}


def kernel_work(inputs, config, device):
    """Work of kernels A and B for one call: ``run_experiment``'s on the
    files' stack."""
    return seqrun.kernel_work(inputs.stack, config, device)
