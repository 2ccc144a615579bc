"""``correct`` on the CPU at tiny shapes: a sound run passes; the control
and each fault a cell can have, planted under the timed path, fail.

The harness's look for a card is skipped (``run_cell`` on the CPU); the
rest of a run is driven as on the card."""

from __future__ import annotations

import numpy as np
import pytest

from fsbench.readings import readings
from fsbench.run import run_cell
from fsbench.tests.conftest import tiny

CELLS = ["seqrun.dense", "zstack.frames32"]


def _run(name, seconds=1.0):
    cell, config = tiny(name)
    _, res = run_cell(name, 11, seconds, 0, device="cpu", cell=cell,
                      config=config)
    return res


def _method(name):
    from fluorosequencingimageanalysis_torch.api import Pipeline
    return Pipeline, ("run_experiment" if name.startswith("seqrun")
                      else "run_zstack")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "compared"


def _stale(name, monkeypatch):
    """A call that answers for the previous call's input."""
    cls, meth = _method(name)
    real = getattr(cls, meth)
    prev = {}

    def stale(self, stack, *a, **kw):
        use = prev.get("stack", stack)
        prev["stack"] = stack
        return real(self, use, *a, **kw)
    monkeypatch.setattr(cls, meth, stale)


def _half(name, monkeypatch):
    """Half of the batch left out: the first half's images stand in for
    the second's."""
    cls, meth = _method(name)
    real = getattr(cls, meth)

    def half(self, stack, *a, **kw):
        x = np.array(stack)
        n = x.shape[0] // 2
        x[n:2 * n] = x[:n]
        return real(self, x, *a, **kw)
    monkeypatch.setattr(cls, meth, half)


def _altered(name, monkeypatch):
    """One answer altered where it is produced: one row's photometry (the
    experiment), one kept fit's center (the z-stack)."""
    if name.startswith("seqrun"):
        from fluorosequencingimageanalysis_torch.pipeline import \
            fast_experiment as fe
        real = fe._rows_by_field

        def rows(*a, **kw):
            out = real(*a, **kw)
            for field in out:
                if field:
                    cat, h, w, ph = field[0]
                    ph = np.array(ph, np.float64)
                    ph[-1] += 0.05 * abs(ph[-1]) + 10.0
                    field[0] = (cat, h, w, ph)
                    break
            return out
        monkeypatch.setattr(fe, "_rows_by_field", rows)
    else:
        from fluorosequencingimageanalysis_torch.models import detect
        real = detect.pack_spot_buckets

        def pack(*a, **kw):
            f32, *rest = real(*a, **kw)
            f32 = f32.clone()
            f32[0, 0, 0] += 0.5
            return (f32, *rest)
        monkeypatch.setattr(detect, "pack_spot_buckets", pack)


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["stale", "half_batch", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(name, monkeypatch)
    res = _run(name)
    assert not res["correct"], res["compared"]


def test_registration_fault_is_not_correct(monkeypatch):
    """A registration one pixel off in one cycle fails the experiment's
    rows, which is where its offsets are checked."""
    from fluorosequencingimageanalysis_torch.parallel import mesh
    real = mesh.phase_correlate_stack

    def shifted(*a, **kw):
        r, c, e, d = real(*a, **kw)
        r = r.clone()
        r[..., 1] += 1.0
        return r, c, e, d
    monkeypatch.setattr(mesh, "phase_correlate_stack", shifted)
    res = _run("seqrun.dense")
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    """The reference in bfloat16 in the program's place fails at least
    one limit, and the program none."""
    cell, config = tiny(name)
    out, _ = readings(name, [21, 22, 23], device="cpu", cell=cell,
                      config=config)
    limits = cell["limits"]
    for line in out:
        assert all(v <= limits[n] for n, v in line["program"].items())
        assert any(v > limits[n] for n, v in line["control"].items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["seqrun.dense", "zstack.frames32",
                                  "seqrun.sparse"])
def test_cell_on_the_card(name, card):
    """One short run of the cell at its own size on the card."""
    _, res = run_cell(name, 2 ** 31 + 77, 3.0, 0)
    assert res["correct"], res["compared"]
    assert res["device"]["platform"] == "gpu"
