"""The port's file front door (``pipeline/files.py::load_stack``,
``Pipeline.run_experiment_files``, the ``run-experiment`` subcommand)
against the benchmark's plain TIFF reader (``fsbench/reference/tiff.py``)
and against the loader the subcommand had before it moved into the port,
on the CPU.

Seeded 3-field x 4-cycle runs of 64x64 uint16 images
(``utils/synth.py::make_experiment_stack``) are written as one
uncompressed TIFF a field in a directory a cycle, in one strip and in
several, by the benchmark's writer (``fsbench/traffic/experiment_files.py``).
Held: the stacks equal, also where one file is big-endian, Deflate-
compressed, uint8 (promoted as numpy stacks it) or of another shape
(refused as numpy refuses it), with no ``np.stack`` where every file
decodes alike; the CSVs of ``run_experiment_files`` and of the
subcommand byte-equal to ``run_experiment``'s on the stack the plain
reader read, for one channel and for two; uneven directories and channels
of different cycle counts refused with the subcommand's text; the spans
and counters recorded only while tracing is on. On a card (``-m cuda``):
the stack read into pinned memory and the CSVs of the files' run equal to
those of the in-memory stack's, call after call.
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
    read_image_array, write_tiff)
from fsbench.reference import tiff
from fsbench.traffic.experiment_files import write_files

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

F, C, H, W = 3, 4, 64, 64
KW = dict(max_candidates=256, max_spots=128)


def _stack(seed, n_fields=F, n_cycles=C):
    x = synth.make_experiment_stack(n_fields, n_cycles, H, W,
                                    spots_per_field=12, seed=seed)
    return np.clip(np.rint(x), 0, 65535).astype(np.uint16)


def _files(tmp_path, seed, rows_per_strip=None, name="run", n_fields=F,
           n_cycles=C):
    stack = _stack(seed, n_fields, n_cycles)
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
        assert timings["api/files/read"]["count"] == F * C
        assert timings["api/files/assemble"]["count"] == F * C
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


def _path(files, field, cycle):
    return next(p for p in files
                if p.endswith(f"cycle_{cycle:02d}/field_{field:03d}.tif"))


def _no_stack(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("np.stack called")
    monkeypatch.setattr(np, "stack", refuse)


@pytest.mark.parametrize("rows_per_strip", [None, 7])
def test_uniform_files_go_into_one_buffer_without_np_stack(
        tmp_path, monkeypatch, rows_per_strip):
    stack, files = _files(tmp_path, 10, rows_per_strip)
    want = tiff.read_stack(files)
    old, _ = _old_load_stack(files)
    profiling.reset_counters()
    _no_stack(monkeypatch)
    try:
        with profiling.tracing():
            got, n_cycles = load_stack(files, device="cpu")
        counts = profiling.counters()
    finally:
        profiling.reset_counters()
    assert isinstance(got, np.ndarray) and n_cycles == C
    assert got.dtype == old.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, old)
    assert counts["files/bytes"] == got.nbytes
    assert counts["files/pinned_bytes"] == 0


@pytest.mark.parametrize("where", [(0, 0), (1, 2), (F - 1, C - 1)])
@pytest.mark.parametrize("encoding", [dict(byteorder=">"),
                                      dict(compression="deflate"),
                                      dict(compression="deflate",
                                           predictor=True)],
                         ids=["big_endian", "deflate", "deflate_predictor"])
def test_one_file_encoded_otherwise_reads_the_same(tmp_path, monkeypatch,
                                                   where, encoding):
    stack, files = _files(tmp_path, 11, 9)
    want = tiff.read_stack(files)
    f, c = where
    write_tiff(_path(files, f, c), stack[f, c], **encoding)
    old, _ = _old_load_stack(files)
    _no_stack(monkeypatch)
    got, _ = load_stack(files)
    assert got.dtype == old.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, old)


@pytest.mark.parametrize("where", [(0, 0), (0, 1), (1, 2), (F - 1, C - 1)])
def test_a_uint8_file_among_uint16_is_promoted_as_before(tmp_path, where):
    stack, files = _files(tmp_path, 12)
    f, c = where
    small = (stack[f, c] >> 8).astype(np.uint8)
    write_tiff(_path(files, f, c), small)
    want = stack.copy()
    want[f, c] = small
    old, _ = _old_load_stack(files)
    profiling.reset_counters()
    try:
        with profiling.tracing():
            got, n_cycles = load_stack(files, device="cpu")
        counts = profiling.counters()
    finally:
        profiling.reset_counters()
    assert n_cycles == C
    assert got.dtype == old.dtype == np.uint16
    np.testing.assert_array_equal(got, old)
    np.testing.assert_array_equal(got, want)
    assert counts["files/read"] == F * C
    assert counts["files/pinned_bytes"] == 0


@pytest.mark.parametrize("where", [(0, 0), (0, 3), (2, 1)])
def test_a_file_of_another_shape_is_refused_as_before(tmp_path, where):
    stack, files = _files(tmp_path, 13)
    f, c = where
    write_tiff(_path(files, f, c), stack[f, c, :, :W - 8])
    with pytest.raises(ValueError) as old:
        _old_load_stack(files)
    with pytest.raises(ValueError) as got:
        load_stack(files)
    assert str(got.value) == str(old.value)
    assert "same shape" in str(got.value)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_stack_is_read_into_pinned_memory_on_the_card(dev, tmp_path):
    stack, files = _files(tmp_path, 14)
    pipe = Pipeline(device=dev)
    profiling.reset_counters()
    try:
        with profiling.tracing():
            got, n_cycles = load_stack(files, pipe.device)
        counts = profiling.counters()
    finally:
        profiling.reset_counters()
    assert isinstance(got, torch.Tensor) and got.is_pinned()
    assert got.dtype == torch.uint16 and n_cycles == C
    np.testing.assert_array_equal(got.numpy(), tiff.read_stack(files))
    assert counts["files/pinned_bytes"] == counts["files/bytes"] == \
        stack.nbytes > 0


@pytest.mark.cuda
def test_run_experiment_files_on_the_card_writes_the_arrays_csvs(
        dev, tmp_path):
    """2 fields x 3 cycles, two file sets back to back and again: each
    call's CSVs are run_experiment's on its own in-memory stack."""
    pipe = Pipeline(device=dev)
    sets = [_files(tmp_path, seed, name=f"run{seed}", n_fields=2,
                   n_cycles=3)[1] for seed in (15, 16)]
    wants = []
    for i, files in enumerate(sets):
        pipe.run_experiment(
            tiff.read_stack(files), csv_path=str(tmp_path / f"w{i}.csv"),
            category_csv_path=str(tmp_path / f"w{i}_cat.csv"), **KW)
        wants.append((_read(tmp_path / f"w{i}.csv"),
                      _read(tmp_path / f"w{i}_cat.csv")))
    assert wants[0][0] != wants[1][0]
    for k, i in enumerate((0, 1, 0, 1)):
        out = pipe.run_experiment_files(
            sets[i], csv_path=str(tmp_path / f"g{k}.csv"),
            category_csv_path=str(tmp_path / f"g{k}_cat.csv"), **KW)
        assert len(out["rows"]) > 0
        assert (_read(tmp_path / f"g{k}.csv"),
                _read(tmp_path / f"g{k}_cat.csv")) == wants[i]
