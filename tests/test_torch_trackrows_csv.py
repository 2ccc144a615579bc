"""The native track-photometries CSV writer (native/trackrows_csv.py over
csrc/trackrows_csv.cpp) against the Python writer it replaces on
``run_experiment``'s path (``fast_experiment._write_track_rows_csv_python``,
kept as the fallback and the oracle), byte for byte; rows it cannot write
as the Python writer does go to the Python writer, whole.

Imports no JAX, so it also runs where the port runs:

    python -m pytest --noconftest tests/test_torch_trackrows_csv.py -q
"""

import math
import os

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_torch import _build
from fluorosequencingimageanalysis_torch.api import Pipeline
from fluorosequencingimageanalysis_torch.native import trackrows_csv
from fluorosequencingimageanalysis_torch.pipeline import fast_experiment as fe
from fluorosequencingimageanalysis_torch.utils import profiling
from fluorosequencingimageanalysis_torch.utils.synth import (
    make_experiment_stack)

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

COUNTER = "experiment/csv_rows_native"


def default_rows(C, n=40, F=3, channel="ch1", seed=0):
    """Rows as run_experiment assembles them from ``_rows_by_field``: one
    shared category tuple a category and field, Python int h and w, and
    each trace's values a float64 view of one photometry array."""
    rng = np.random.default_rng(seed)
    cats = rng.random((n, C)) < 0.7
    cats[:, 0] = True
    pos = rng.integers(0, 512, (n, C, 2)).astype(np.float64)
    phot = rng.normal(3000.0, 900.0, (n, C)) * rng.choice([1.0, -1e-3, 1e4],
                                                          (n, 1))
    sizes = [n // F] * (F - 1) + [n - (n // F) * (F - 1)]
    per_field = fe._rows_by_field(pos, cats, phot, sizes, F)
    return [(channel, f, h0, w0, cat, ph)
            for f, field_rows in enumerate(per_field)
            for (cat, h0, w0, ph) in field_rows]


EDGE_VALUES = [math.nan, math.inf, -math.inf, -0.0, 1e16, 1e15, 1e-5, 1e-4,
               5e-324, 1.7976931348623157e308]


def edge_rows():
    rows = default_rows(len(EDGE_VALUES), n=6)
    edges = np.array(EDGE_VALUES)
    return [r[:5] + (np.roll(edges, k),) for k, r in enumerate(rows)]


def keep_invalid_rows():
    """The keep_invalid surface: tuples of Python floats and None (a
    None Spot), H and W None where frame 0 is one; and with mdma, numpy
    float64 scalars."""
    out = []
    for k, r in enumerate(default_rows(5, n=30)):
        vals = tuple(None if (k + i) % 4 == 0 else float(v)
                     for i, v in enumerate(r[5]))
        h0, w0 = (None, None) if vals[0] is None else r[2:4]
        if k % 3 == 0:
            vals = tuple(None if v is None else np.float64(v) * 0.97
                         for v in vals)
        out.append((r[0], r[1], h0, w0, r[4], vals))
    return out


def averages_rows():
    rows = []
    for k, r in enumerate(default_rows(4, n=20)):
        mean = float(np.mean(r[5])) if k % 5 else float("nan")
        h0, w0 = (None, None) if k % 7 == 0 else r[2:4]
        rows.append(r[:2] + (h0, w0, r[4], mean))
    rows.append(rows[0][:5] + (np.float64(-0.0),))
    return rows


def two_channel_rows():
    return (default_rows(3, n=12, channel="ch1") +
            default_rows(3, n=15, channel='dye "A", 561 nm', seed=1))


CASES = {
    "cycles_1": (lambda: default_rows(1), 1, False),
    "cycles_2": (lambda: default_rows(2), 2, False),
    "cycles_12": (lambda: default_rows(12, n=120, F=4), 12, False),
    "cycles_70": (lambda: default_rows(70), 70, False),
    "edge_values": (edge_rows, len(EDGE_VALUES), False),
    "none_values_and_positions": (keep_invalid_rows, 5, False),
    "save_averages": (averages_rows, 4, True),
    "two_channels_quoted": (two_channel_rows, 3, False),
    "no_rows": (lambda: [], 12, False),
    "no_rows_save_averages": (lambda: [], 12, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_file_is_the_python_writers(case, tmp_path):
    make, n_cycles, save_averages = CASES[case]
    rows = make()
    assert trackrows_csv.as_arrays(rows, save_averages) is not None
    want, got = tmp_path / "python.csv", tmp_path / "native.csv"
    fe._write_track_rows_csv_python(rows, n_cycles, str(want),
                                    save_averages=save_averages)
    profiling.reset_counters()
    with profiling.tracing():
        fe.write_track_rows_csv(rows, n_cycles, str(got),
                                save_averages=save_averages)
    assert profiling.counters().get(COUNTER) == len(rows)
    assert got.read_bytes() == want.read_bytes()


def _ints(photometry, frame, adjustments):
    return int(photometry)


FALLBACK_CASES = {
    "int_values": lambda rows: [r[:5] + (tuple(int(v) for v in r[5]),)
                                for r in rows],
    "float32_values": lambda rows: [r[:5] + (r[5].astype(np.float32),)
                                    for r in rows],
    "mixed_arrays_and_tuples": lambda rows: [
        r if k % 2 else r[:5] + (tuple(r[5].tolist()),)
        for k, r in enumerate(rows)],
    "ragged_values": lambda rows: rows[:-1] + [rows[-1][:5] +
                                               (rows[-1][5][:2],)],
    "numpy_int_position": lambda rows: [r[:2] + (np.int64(r[2]),) + r[3:]
                                        for r in rows],
    "bool_field": lambda rows: [r[:1] + (bool(r[1]),) + r[2:] for r in rows],
    "list_values": lambda rows: [r[:5] + (list(r[5]),) for r in rows],
    "big_endian_values": lambda rows: [r[:5] + (r[5].astype(">f8"),)
                                       for r in rows],
    "matrix_rows": lambda rows: [r[:5] + (r[5][None, :],) for r in rows],
}


@pytest.mark.parametrize("case", list(FALLBACK_CASES))
def test_other_rows_go_to_the_python_writer_whole(case, tmp_path):
    rows = FALLBACK_CASES[case](default_rows(3, n=12))
    assert trackrows_csv.as_arrays(rows) is None
    want, got = tmp_path / "python.csv", tmp_path / "written.csv"
    fe._write_track_rows_csv_python(rows, 3, str(want))
    profiling.reset_counters()
    with profiling.tracing():
        fe.write_track_rows_csv(rows, 3, str(got))
    assert COUNTER not in profiling.counters()
    assert got.read_bytes() == want.read_bytes()


@pytest.fixture(scope="module")
def tiny_stack():
    return np.clip(make_experiment_stack(3, 3, 64, 64, spots_per_field=15,
                                         seed=3), 0, 65535).astype(np.uint16)


# run_experiment's surfaces, and the writer each takes: "fields" (the
# arrays behind rows that are still _rows_by_field's), "rows" (the rows
# by the native writer) or "python" (the Python writer).
SURFACES = {
    "default": ({}, "fields"),
    "two_channels": ({"channels": True}, "fields"),
    "remainder_filter": ({"remainder_threshold": 7}, "fields"),
    "groups_of_one_field": ({"group_fields": 1}, "fields"),
    "a_group_with_no_trace": ({"group_fields": 1, "blank_field": True},
                              "rows"),
    "keep_invalid_mdma": ({"keep_invalid": True, "mdma": True}, "rows"),
    "save_averages": ({"save_averages": True}, "rows"),
    "adjustment_ints": ({"adjustment_function": _ints}, "python"),
}


@pytest.mark.parametrize("surface", list(SURFACES))
def test_run_experiment_writes_the_python_writers_bytes(surface, tiny_stack,
                                                        tmp_path,
                                                        monkeypatch):
    """run_experiment's CSV is the Python writer's file for the rows it
    returns, whichever writer its surface takes; the counter counts the
    native writer's rows only."""
    from fluorosequencingimageanalysis_torch import api

    kw, want_path = SURFACES[surface]
    kw = dict(kw)
    stack = tiny_stack.copy()
    if kw.pop("blank_field", False):
        stack[1] = 400
    if "group_fields" in kw:
        monkeypatch.setattr(api, "GROUP_FIELDS", kw.pop("group_fields"))
    if kw.pop("channels", False):
        stack = {"ch1": stack, 'dye "A", 561 nm': stack[::-1].copy()}
    taken = []
    for name, label in (("write_track_fields_csv", "fields"),
                        ("write_track_rows_csv", "rows"),
                        ("_write_track_rows_csv_python", "python")):
        def watched(*args, _f=getattr(fe, name), _label=label, **kwargs):
            taken.append(_label)
            return _f(*args, **kwargs)
        monkeypatch.setattr(fe, name, watched)
    got = tmp_path / "run.csv"
    profiling.reset_counters()
    with profiling.tracing():
        res = Pipeline(device="cpu").run_experiment(
            stack, max_candidates=128, csv_path=str(got), **kw)
    assert taken[-1] == want_path
    want = tmp_path / "python.csv"
    fe._write_track_rows_csv_python(
        res["rows"], tiny_stack.shape[1], str(want),
        save_averages=kw.get("save_averages", False))
    assert len(res["rows"]) > 10
    assert got.read_bytes() == want.read_bytes()
    if surface == "remainder_filter":
        assert 0 < sum(res["invalid_fields_mask"]) < len(tiny_stack)
    native = profiling.counters().get(COUNTER)
    assert native == (None if want_path == "python" else len(res["rows"]))


@pytest.mark.parametrize("threads", [1, 3])
def test_blocks_continue_the_file(threads, tmp_path):
    """Many blocks of rows, formatted on one thread or three, more than
    the threads may format ahead of the writer: the file is the rows
    written alone, repeated, in order."""
    small = trackrows_csv.as_arrays(keep_invalid_rows())
    reps = 30 * 2048 // len(small.field) + 7
    big = small._replace(**{
        k: np.concatenate([getattr(small, k)] * reps)
        for k in ("channel", "field", "h", "w", "h_none", "w_none",
                  "category", "values", "none")})
    header = trackrows_csv.HEADER + [f"FRAME {i}" for i in range(5)]
    assert trackrows_csv.write(str(tmp_path / "big.csv"), header, big,
                               n_threads=threads) == len(big.field)
    trackrows_csv.write(str(tmp_path / "one.csv"), header, small,
                        n_threads=1)
    head, body = (tmp_path / "one.csv").read_bytes().split(b"\r\n", 1)
    assert (tmp_path / "big.csv").read_bytes() == \
        head + b"\r\n" + body * reps


def test_arrays_are_validated(tmp_path):
    arrays = trackrows_csv.as_arrays(default_rows(3, n=6))
    header = trackrows_csv.HEADER + ["FRAME 0", "FRAME 1", "FRAME 2"]
    with pytest.raises(ValueError, match="values must be"):
        trackrows_csv.write(str(tmp_path / "a.csv"), header,
                            arrays._replace(values=arrays.values[:4]))
    with pytest.raises(ValueError, match="category"):
        trackrows_csv.write(str(tmp_path / "b.csv"), header,
                            arrays._replace(category=arrays.category + 99))


def test_host_builds_are_keyed_by_their_headers(tmp_path, monkeypatch):
    """An edit of a shared host header (csrc/*.h) rebuilds the host
    sources; a CUDA header does not."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "core.cpp").write_text('#include "shared.h"\n')
    (csrc / "shared.h").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    so = _build.library_path("core")
    (csrc / "shared.h").write_text("// two\n")
    assert _build.library_path("core") != so
    so = _build.library_path("core")
    (csrc / "extra.cuh").write_text("// a CUDA header\n")
    assert _build.library_path("core") == so
    assert os.path.basename(so).startswith("core-")
