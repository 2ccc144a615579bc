"""The port's file front door (``pipeline/files.py::load_stack``,
``Pipeline.run_experiment_files``, the ``run-experiment`` subcommand)
against the benchmark's plain TIFF reader (``fsbench/reference/tiff.py``)
and against the loader the subcommand had before it moved into the port,
on the CPU.

Seeded 3-field x 4-cycle runs of 64x64 uint16 images
(``utils/synth.py::make_experiment_stack``) are written as one
uncompressed TIFF a field in a directory a cycle, in one strip and in
several, by the benchmark's writer (``fsbench/traffic/experiment_files.py``).
Held: the stacks equal; the CSVs of ``run_experiment_files`` and of the
subcommand byte-equal to ``run_experiment``'s on the stack the plain
reader read, for one channel and for two; uneven directories and channels
of different cycle counts refused with the subcommand's text; the spans
and counters recorded only while tracing is on.
"""

import json

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_torch.__main__ import main
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.pipeline.experiment import Experiment
from fluorosequencingimageanalysis_torch.pipeline.files import (
    FileLayoutError, load_stack)
from fluorosequencingimageanalysis_torch.utils import profiling, synth
from fluorosequencingimageanalysis_torch.utils.imageio import (
    read_image_array)
from fsbench.reference import tiff
from fsbench.traffic.experiment_files import write_files

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

F, C, H, W = 3, 4, 64, 64
KW = dict(max_candidates=256, max_spots=128)


def _stack(seed):
    x = synth.make_experiment_stack(F, C, H, W, spots_per_field=12,
                                    seed=seed)
    return np.clip(np.rint(x), 0, 65535).astype(np.uint16)


def _files(tmp_path, seed, rows_per_strip=None, name="run"):
    stack = _stack(seed)
    root = tmp_path / name
    root.mkdir()
    return stack, write_files(stack, str(root), rows_per_strip)


def _old_load_stack(files):
    """The subcommand's loader before it moved to ``pipeline/files.py``,
    as it was."""
    frame_indexed, field_indexed = Experiment.easy_sort_target_images(files)
    n_fields = {len(v) for v in frame_indexed.values()}
    if len(n_fields) != 1:
        raise SystemExit("every cycle directory must hold the same number "
                         f"of field files (got counts {sorted(n_fields)})")
    fields = []
    for f in sorted(field_indexed):
        fields.append(np.stack([read_image_array(p)
                                for p in field_indexed[f]]))
    stack = np.stack(fields)  # [F, C, H, W]
    return stack, stack.shape[1]


@pytest.mark.parametrize("seed, rows_per_strip",
                         [(1, None), (2, None), (3, 16), (4, 5)])
def test_loader_equals_the_plain_reader_and_the_old_loader(
        tmp_path, seed, rows_per_strip):
    stack, files = _files(tmp_path, seed, rows_per_strip)
    files = list(reversed(files))   # the sort makes the order
    got, n_cycles = load_stack(files)
    old, old_cycles = _old_load_stack(files)
    assert got.dtype == np.uint16 and got.shape == (F, C, H, W)
    assert n_cycles == old_cycles == C
    np.testing.assert_array_equal(got, tiff.read_stack(files))
    np.testing.assert_array_equal(got, old)
    np.testing.assert_array_equal(got, stack)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_run_experiment_files_writes_run_experiments_csvs(tmp_path):
    _, files = _files(tmp_path, 5)
    pipe = Pipeline(device="cpu")
    got = pipe.run_experiment_files(
        files, csv_path=str(tmp_path / "a.csv"),
        category_csv_path=str(tmp_path / "a_cat.csv"), **KW)
    want = pipe.run_experiment(
        tiff.read_stack(files), csv_path=str(tmp_path / "b.csv"),
        category_csv_path=str(tmp_path / "b_cat.csv"), **KW)
    assert len(got["rows"]) == len(want["rows"]) > 0
    assert _read(tmp_path / "a.csv") == _read(tmp_path / "b.csv")
    assert _read(tmp_path / "a_cat.csv") == _read(tmp_path / "b_cat.csv")
    assert got["offsets"]["ch1"][0].shape == (F, C)


def test_the_subcommand_writes_run_experiments_csvs_for_two_channels(
        tmp_path, capsys):
    _, files1 = _files(tmp_path, 6, name="ch1")
    _, files2 = _files(tmp_path, 7, 8, name="ch2")
    out = str(tmp_path / "out")
    assert main(["run-experiment", "--peptide-files", *files1,
                 "--second-channel-files", *files2, "--output-dir", out,
                 "--max-candidates", "256", "--max-spots", "128",
                 "--all-categories", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (summary["fields"], summary["cycles"]) == (F, C)
    assert summary["channels"] == ["ch1", "ch2"]
    want = Pipeline(device="cpu").run_experiment(
        {"ch1": tiff.read_stack(files1), "ch2": tiff.read_stack(files2)},
        csv_path=str(tmp_path / "w.csv"),
        category_csv_path=str(tmp_path / "w_cat.csv"),
        category_csv_filtered=False, **KW)
    assert summary["rows"] == len(want["rows"])
    assert {r[0] for r in want["rows"]} == {"ch1", "ch2"}
    assert _read(summary["csv"]) == _read(tmp_path / "w.csv")
    assert _read(summary["category_csv"]) == _read(tmp_path / "w_cat.csv")


def test_uneven_files_are_refused_with_the_subcommands_text(tmp_path):
    _, files = _files(tmp_path, 8)
    uneven = files[:-1]
    with pytest.raises(FileLayoutError, match="same number of field files"):
        load_stack(uneven)
    with pytest.raises(SystemExit, match="same number of field files"):
        _old_load_stack(uneven)
    out = str(tmp_path / "out")
    with pytest.raises(SystemExit,
                       match="every cycle directory must hold the same "
                             r"number of field files \(got counts"):
        main(["run-experiment", "--peptide-files", *uneven, "--output-dir",
              out, "--device", "cpu"])
    fewer = [p for p in files if "cycle_03" not in p]
    with pytest.raises(FileLayoutError, match="same cycle count"):
        Pipeline(device="cpu").run_experiment_files(files, fewer)
    with pytest.raises(SystemExit,
                       match="second channel must have the same cycle "
                             "count"):
        main(["run-experiment", "--peptide-files", *files,
              "--second-channel-files", *fewer, "--output-dir", out,
              "--device", "cpu"])


SPANS = ("api/files/sort", "api/files/read", "api/files/assemble")


def test_spans_and_counters_only_while_tracing(tmp_path):
    _, files = _files(tmp_path, 9)
    profiling.reset_timings()
    profiling.reset_counters()
    try:
        load_stack(files)
        assert not set(SPANS) & set(profiling.timings())
        assert not {"files/read", "files/bytes"} & \
            set(profiling.counters())
        with profiling.tracing():
            load_stack(files)
        timings, counts = profiling.timings(), profiling.counters()
        assert set(SPANS) <= set(timings)
        assert timings["api/files/sort"]["count"] == 1
        assert timings["api/files/read"]["count"] == F
        assert counts["files/read"] == F * C
        assert counts["files/bytes"] == F * C * H * W * 2
        profiling.reset_timings()
        profiling.reset_counters()
        Pipeline(device="cpu", profile=True).run_experiment_files(files,
                                                                  **KW)
        assert set(SPANS) <= set(profiling.timings())
        assert profiling.counters()["files/read"] == F * C
    finally:
        profiling.reset_timings()
        profiling.reset_counters()
