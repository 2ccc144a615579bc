"""The cell ``zstack.exhaustive`` on the CPU at a tiny size: a sound run
is ``correct`` with every compared number 0 and a traced one reports the
uncapped path's metrics, the bfloat16 control fails a limit, three faults
planted under the timed path (an answer for the previous call's input, the
answer of a capped bucket smaller than the frames' candidate counts, two
groups' frames swapped) each fail ``correct``, and the reference runs with
neither the port nor JAX loadable."""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fsbench import isolation, registry
from fsbench.readings import readings
from fsbench.run import run_cell

CELL = "zstack.exhaustive"
CHUNK = 256
CAP = 256
ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="", USE_FLAX="0")


def tiny():
    """The cell and its configuration at 10 frames (groups of 8 and 2) of
    128x128 and the cell's density (125 spots, ~700 candidates a frame)."""
    cell = copy.deepcopy(registry.cell(CELL))
    config = copy.deepcopy(registry.config(cell["config"]))
    config.update(frames=10, height=128, width=128)
    cell["params"]["spots"] = 125
    cell["sample_calls"] = 2
    cell["warmup_calls"] = 1
    return cell, config


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    """Chunks of 256 candidates, so that a tiny frame takes three."""
    from fluorosequencingimageanalysis_torch.models import detect
    monkeypatch.setattr(detect, "EXHAUSTIVE_CHUNK", CHUNK)


def _run(seed=11, seconds=1.0, trace=0):
    cell, config = tiny()
    return run_cell(CELL, seed, seconds, trace, device="cpu", cell=cell,
                    config=config)


def test_sound_run_is_correct():
    _, res = _run()
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["compared"]) == {"cand_count", "spot_count", "kept",
                                    "center_px", "amplitude",
                                    "offset_counts", "r2"}
    assert all(c["value"] == 0 for c in res["compared"].values())
    assert set(res["metrics"]) == {"images_per_s", "setup_s"}


def test_a_traced_run_reports_the_exhaustive_metrics():
    """On the CPU the device span has no device time, so
    ``exhaustive_detect_ms`` is left out; the host span and the counter
    are read."""
    run, res = _run(seed=2 ** 31 + 5, seconds=0.5, trace=1)
    assert res["correct"], res["compared"]
    m = res["metrics"]
    assert set(m) == {"host_nms_ms", "exhaustive_chunks"}
    assert m["exhaustive_chunks"]["value"] == 2 * 3   # 2 groups, 3 chunks
    assert m["host_nms_ms"]["value"] > 0


def _stale(monkeypatch):
    """A call that answers for the previous call's input."""
    from fluorosequencingimageanalysis_torch.api import Pipeline
    real = Pipeline.run_zstack
    prev = {}

    def stale(self, stack, *a, **kw):
        use = prev.get("stack", stack)
        prev["stack"] = stack
        return real(self, use, *a, **kw)
    monkeypatch.setattr(Pipeline, "run_zstack", stale)


def _capped(monkeypatch):
    """The answer of a fixed bucket of ``CAP`` candidates, fewer than
    every frame has: what a capped run gives."""
    from fluorosequencingimageanalysis_torch.api import Pipeline
    real = Pipeline.run_zstack

    def capped(self, stack, *a, **kw):
        assert kw.pop("max_candidates") == "exhaustive"
        out = real(self, stack, *a, max_candidates=CAP, **kw)
        assert (out["cand_count"] > CAP).all()
        return out
    monkeypatch.setattr(Pipeline, "run_zstack", capped)


def _swapped_groups(monkeypatch):
    """The first group's first two frames and the second group's two
    frames trade places in the answer."""
    from fluorosequencingimageanalysis_torch.api import Pipeline
    real = Pipeline.run_zstack

    def swapped(self, stack, *a, **kw):
        out = real(self, stack, *a, **kw)
        order = np.r_[8:10, 2:8, 0:2]
        return {k: v[order] for k, v in out.items()}
    monkeypatch.setattr(Pipeline, "run_zstack", swapped)


@pytest.mark.parametrize("fault", [_stale, _capped, _swapped_groups],
                         ids=["stale", "capped", "swapped_groups"])
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


def test_reference_loads_neither_the_port_nor_jax():
    """The check's reference, the count of kernel work and the generator
    of a tiny stack run with the port unimportable, and load no JAX."""
    code = ("import sys, json\n"
            "sys.modules['fluorosequencingimageanalysis_torch'] = None\n"
            "import torch\n"
            "from fsbench import isolation, registry\n"
            "from fsbench.tests.test_exhaustive_cell import tiny\n"
            "cell, config = tiny()\n"
            "gen = registry.generator(cell['generator'])\n"
            "entry = registry.entry(config['entry'])\n"
            "stack = gen.generate(cell['params'], config, 7, 0,"
            " torch.device('cpu'))\n"
            "ref = entry.reference(stack, config, 'cpu')\n"
            "work = entry.kernel_work(stack, config, 'cpu')\n"
            "tops = sorted({m.split('.')[0] for m, v in"
            " list(sys.modules.items()) if v is not None})\n"
            "print(json.dumps([int(ref['spot_count'].sum()), work['fits'],"
            " int(ref['cand_count'].sum()), isolation.loaded(), tops]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         env=ENV, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    kept, fits, cands, found, tops = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert kept > 0 and fits == cands > kept
    assert found == [] and not set(tops) & set(isolation.FORBIDDEN)
    assert isolation.PORT not in tops


@pytest.mark.cuda
def test_cell_on_the_card(monkeypatch):
    """One short run of the cell at its own size on the card, with the
    port's own chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this process sees none")
    monkeypatch.undo()
    _, res = run_cell(CELL, 2 ** 31 + 77, 3.0, 0)
    assert res["correct"], res["compared"]
    assert res["device"]["platform"] == "gpu"
