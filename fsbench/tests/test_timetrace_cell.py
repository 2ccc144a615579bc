"""The cell ``timetrace.movie100`` on the CPU at a tiny size: a sound run
is ``correct``, the bfloat16 control fails a limit, and three faults
planted under the timed path each fail ``correct``; its generator gives
the same movie for the same seed and plants what the cell file says."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from fsbench import registry
from fsbench.readings import readings
from fsbench.run import run_cell

CELL = "timetrace.movie100"
CPU = torch.device("cpu")


def tiny():
    """The cell and its configuration cut to 24 frames of 128x128 with 30
    spots, bleaching between frames 4 and 21 (the generator's frames 4 to
    T - 3, as at full size)."""
    cell = copy.deepcopy(registry.cell(CELL))
    config = copy.deepcopy(registry.config(cell["config"]))
    config.update(frames=24, height=128, width=128)
    cell["params"].update(spots=30, bleach_frames=[4, 21])
    cell["sample_calls"] = 2
    cell["warmup_calls"] = 1
    return cell, config


def _run(seed=11, seconds=1.0, trace=0):
    cell, config = tiny()
    return run_cell(CELL, seed, seconds, trace, device="cpu", cell=cell,
                    config=config)


def test_sound_run_is_correct():
    _, res = _run()
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["compared"]) == {"traces", "track_px", "photometry",
                                    "plateaus", "csv"}
    assert all(c["value"] == 0 for c in res["compared"].values())
    assert set(res["metrics"]) == {"images_per_s", "setup_s"}


def test_a_traced_run_reports_the_host_metrics():
    """On the CPU (no device time) a traced run reports the host spans and
    the counter, and leaves the device spans out."""
    run, res = _run(seed=2 ** 31 + 5, seconds=0.5, trace=1)
    assert res["correct"], res["compared"]
    m = res["metrics"]
    assert {"stepfit_postpass_ms", "tt_csv_ms", "traces_per_movie"} <= set(m)
    assert not {"tt_track_ms", "stepfit_ck_ms"} & set(m)
    assert m["tt_csv_ms"]["value"] > 0
    assert 1 <= m["traces_per_movie"]["value"] <= 30


def _stale(monkeypatch):
    """A call that answers for the previous call's movie."""
    from fluorosequencingimageanalysis_torch.api import Pipeline
    real = Pipeline.run_timetrace
    prev = {}

    def stale(self, movie, *a, **kw):
        use = prev.get("movie", movie)
        prev["movie"] = movie
        return real(self, use, *a, **kw)
    monkeypatch.setattr(Pipeline, "run_timetrace", stale)


def _half(monkeypatch):
    """The second half of the frames replaced by the first half."""
    from fluorosequencingimageanalysis_torch.api import Pipeline
    real = Pipeline.run_timetrace

    def half(self, movie, *a, **kw):
        x = np.array(movie)
        n = x.shape[0] // 2
        x[n:2 * n] = x[:n]
        return real(self, x, *a, **kw)
    monkeypatch.setattr(Pipeline, "run_timetrace", half)


def _altered(monkeypatch):
    """One trace's t-filtered plateau altered where the native post-pass
    produces it."""
    from fluorosequencingimageanalysis_torch.native import stepchain
    real = stepchain.stepfit_postpass

    def postpass(*a, **kw):
        out = list(real(*a, **kw))
        tf_h = out[7].copy()
        tf_h[0, 0] += 0.05 * abs(tf_h[0, 0]) + 10.0
        out[7] = tf_h
        return tuple(out)
    monkeypatch.setattr(stepchain, "stepfit_postpass", postpass)


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["stale", "half_frames", "altered_plateau"])
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


def test_same_seed_same_movie():
    cell, config = tiny()
    gen = registry.generator(cell["generator"])
    big = 2 ** 31 + 12345
    a = gen.generate(cell["params"], config, big, 0, CPU)
    b = gen.generate(cell["params"], config, big, 0, CPU)
    c = gen.generate(cell["params"], config, big, 1, CPU)
    d = gen.generate(cell["params"], config, big + 1, 0, CPU)
    assert a.dtype == np.uint16 and a.shape == (24, 128, 128)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, d)


def test_movie_plants_what_the_cell_says():
    cell, config = tiny()
    p = cell["params"]
    gen = registry.generator(cell["generator"])
    movie, truth = gen.generate(p, config, 3, 0, CPU, return_truth=True)
    T, H = config["frames"], config["height"]
    pos, dyes, drops = truth["positions"], truth["dyes"], truth["drops"]
    assert pos.shape == (p["spots"], 2)
    assert pos.min() >= p["border"] and pos.max() < H - p["border"]
    assert dyes.min() >= p["dyes"][0] and dyes.max() <= p["dyes"][1]
    first, last = p["bleach_frames"]
    for k, row in zip(dyes, drops):
        real = row[:k]
        assert len(set(real.tolist())) == k     # without replacement
        assert real.min() >= first and real.max() <= last
        assert (row[k:] == T).all()             # no drop for a dye not held
    # One dye lost at each bleach frame; gone after the last.
    levels = truth["levels"]
    assert (levels[:, 0] == dyes).all()
    assert (levels[:, -1] == 0).all()
    assert (np.diff(levels, axis=1) <= 0).all()
    # The noise floor: the median pixel is the background's mean.
    assert abs(np.median(movie) - p["noise"][0]) < 3


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the cell at its own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this process sees none")
    _, res = run_cell(CELL, 2 ** 31 + 77, 3.0, 0)
    assert res["correct"], res["compared"]
    assert res["device"]["platform"] == "gpu"
