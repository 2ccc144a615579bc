"""The cell ``seqrun.files`` on the CPU at a tiny size: the plain TIFF
reader reads back the generator's stack, a sound run is ``correct`` and a
traced one reports the file front door's metrics, the bfloat16 control
fails a limit, and three faults planted under the timed path (two cycle
directories read in swapped order, one file decoded big-endian, a call
that answers for the previous call's files) each fail ``correct``."""

from __future__ import annotations

import copy
import os

import numpy as np
import pytest
import torch

from fsbench import registry
from fsbench.readings import readings
from fsbench.reference import tiff
from fsbench.run import run_cell

CELL = "seqrun.files"
CPU = torch.device("cpu")


def tiny():
    """The cell and its configuration cut as ``conftest.tiny`` cuts the
    ``seqrun`` cells: 3 fields x 4 cycles of 128x128, 60 spots a field,
    buckets of 512 candidates and 256 spots."""
    cell = copy.deepcopy(registry.cell(CELL))
    config = copy.deepcopy(registry.config(cell["config"]))
    config.update(fields=3, cycles=4, height=128, width=128)
    config["call"].update(max_candidates=512, max_spots=256)
    cell["params"]["spots_per_field"] = 60
    cell["sample_calls"] = 2
    cell["warmup_calls"] = 1
    return cell, config


def _run(seed=11, seconds=1.0, trace=0):
    cell, config = tiny()
    return run_cell(CELL, seed, seconds, trace, device="cpu", cell=cell,
                    config=config)


def test_reference_reader_reads_the_generators_stack():
    cell, config = tiny()
    gen = registry.generator(cell["generator"])
    big = 2 ** 31 + 12345
    a = gen.generate(cell["params"], config, big, 0, CPU)
    b = gen.generate(cell["params"], config, big, 1, CPU)
    assert a.stack.dtype == np.uint16 and a.stack.shape == (3, 4, 128, 128)
    assert len(a.files) == 12 and a.files == sorted(a.files)
    assert os.path.relpath(a.root, registry.ROOT).startswith(".."), \
        "the files lie outside the checkout"
    np.testing.assert_array_equal(tiff.read_stack(a.files), a.stack)
    np.testing.assert_array_equal(tiff.read_stack(list(reversed(a.files))),
                                  a.stack)
    stack = registry.generator("experiment_stack").generate(
        cell["params"], config, big, 0, CPU)
    np.testing.assert_array_equal(a.stack, stack)
    assert not np.array_equal(a.stack, b.stack)
    root = a.root
    del a
    assert not os.path.exists(root)


def test_reference_reader_reads_strips_and_refuses_other_files(tmp_path):
    from fsbench.traffic.experiment_files import write_tiff

    img = np.random.default_rng(3).integers(0, 2 ** 16, (37, 29),
                                            dtype=np.uint16)
    for rows in (None, 1, 5, 37):
        path = str(tmp_path / f"s{rows}.tif")
        write_tiff(path, img, rows)
        np.testing.assert_array_equal(tiff.read(path), img)
    data = bytearray(open(path, "rb").read())
    bad = str(tmp_path / "bad.tif")
    for at, value in ((0, b"MM"), (8 + 2 + 12 * 3 + 8, b"\x05\x00")):
        broken = bytearray(data)
        broken[at:at + len(value)] = value
        with open(bad, "wb") as fh:
            fh.write(broken)
        with pytest.raises(ValueError):
            tiff.read(bad)


def test_sound_run_is_correct():
    _, res = _run()
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["compared"]) == {"track_csv", "rows", "photometry",
                                    "category_csv"}
    assert all(c["value"] == 0 for c in res["compared"].values())
    assert set(res["metrics"]) == {"images_per_s", "setup_s"}


def test_a_traced_run_reports_the_file_metrics():
    run, res = _run(seed=2 ** 31 + 5, seconds=0.5, trace=1)
    assert res["correct"], res["compared"]
    m = res["metrics"]
    assert set(m) == {"file_read_ms", "file_assemble_ms", "files_per_call"}
    assert m["files_per_call"]["value"] == 12
    assert m["file_read_ms"]["value"] > 0
    assert m["file_assemble_ms"]["value"] > 0


def _swapped_cycles(monkeypatch):
    """Cycle directories 1 and 2 read in swapped order."""
    from fluorosequencingimageanalysis_torch.pipeline.experiment import \
        Experiment
    real = Experiment.easy_sort_target_images

    def swapped(files):
        frames, fields = real(files)
        frames[1], frames[2] = frames[2], frames[1]
        for cycles in fields.values():
            cycles[1], cycles[2] = cycles[2], cycles[1]
        return frames, fields
    monkeypatch.setattr(Experiment, "easy_sort_target_images",
                        staticmethod(swapped))


def _big_endian(monkeypatch):
    """One file a call (field 0 of cycle 0) decoded big-endian."""
    from fluorosequencingimageanalysis_torch.utils import imageio
    real = imageio.read_image_array

    def read(path):
        arr = real(path)
        if path.endswith(os.path.join("cycle_00", "field_000.tif")):
            arr = arr.byteswap()
        return arr
    monkeypatch.setattr(imageio, "read_image_array", read)


def _stale(monkeypatch):
    """A call that answers for the previous call's files."""
    from fluorosequencingimageanalysis_torch.api import Pipeline
    real = Pipeline.run_experiment_files
    prev = {}

    def stale(self, files, *a, **kw):
        use = prev.get("files", files)
        prev["files"] = files
        return real(self, use, *a, **kw)
    monkeypatch.setattr(Pipeline, "run_experiment_files", stale)


@pytest.mark.parametrize("fault", [_swapped_cycles, _big_endian, _stale],
                         ids=["swapped_cycles", "big_endian", "stale"])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    _, res = _run()
    assert not res["correct"], res["compared"]


def test_control_fails_a_limit():
    """The reference in bfloat16 in the program's place fails at least
    one limit on every seed, and the program none."""
    cell, config = tiny()
    out, _ = readings(CELL, [21, 22, 23], device="cpu", cell=cell,
                      config=config)
    limits = cell["limits"]
    for line in out:
        assert all(v <= limits[n] for n, v in line["program"].items())
        assert any(v > limits[n] for n, v in line["control"].items())


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the cell at its own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this process sees none")
    _, res = run_cell(CELL, 2 ** 31 + 77, 3.0, 0)
    assert res["correct"], res["compared"]
    assert res["device"]["platform"] == "gpu"
