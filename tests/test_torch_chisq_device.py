"""The port's device chi-squared engine against the JAX package's and the
native oracle, on the CPU.

``ops/chisq_batch_device.py`` computes the Kerssemakers best-fit/counter-fit
chain for every trace at once in torch float64, like the JAX package's
jitted program; the native C++ core (bit-equal to the host chain) is the
oracle. Stated tolerance, as tests/test_chisq_device.py asks of the JAX
engine: the plateaus' starts and stops equal the oracle's exactly on every
trace, heights within 1e-9 (both take the host's np.mean over the same
plateau); the JAX engine's output equals the port's the same way.
"""

import numpy as np
import pytest
import torch

from fluorosequencingimageanalysis_tpu.ops.chisq_batch_device import (
    chi_squared_fit_device as jax_chisq_device)

from fluorosequencingimageanalysis_torch import stepfitting as sf
from fluorosequencingimageanalysis_torch.ops import chisq_batch_device as cd
from fluorosequencingimageanalysis_torch.utils import synth

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host


def _make_traces(rng, n, T, quantize=False):
    traces = np.zeros((n, T))
    for i in range(n):
        nsteps = int(rng.integers(0, min(5, T // 5)))
        drops = np.sort(rng.choice(np.arange(2, T - 2), nsteps,
                                   replace=False))
        lvl = float(nsteps + 1)
        tr = np.full(T, lvl)
        for d in drops:
            lvl -= 1.0
            tr[d:] = lvl
        tr = tr * 2000 + rng.normal(0, 400, T)
        if quantize:
            q = float(rng.choice([250.0, 500.0, 1000.0]))
            tr = np.round(tr / q) * q
        traces[i] = tr
    return traces


def _assert_equal_fits(got, want, ctx):
    assert len(got) == len(want), ctx
    for a, b in zip(got, want):
        assert a[0] == b[0] and a[1] == b[1], (ctx, a, b)
        assert abs(a[2] - b[2]) < 1e-9, (ctx, a, b)


@pytest.mark.parametrize("trial", range(6))
def test_device_engine_matches_the_oracle_and_the_jax_engine(trial):
    rng = np.random.default_rng([1, trial])
    T = int(rng.integers(16, 64))
    n = int(rng.integers(3, 8))
    traces = _make_traces(rng, n, T, quantize=bool(trial % 2))
    kwargs = dict(
        num_steps=int(rng.integers(2, min(9, T - 2))),
        min_step_length=int(rng.integers(0, 4)),
        min_step_magnitude=float(rng.choice([0.0, 300.0, 900.0])),
        ignore_counterfits=bool(rng.integers(0, 2)))
    got = cd.chi_squared_fit_device(traces, device="cpu", **kwargs)
    want = jax_chisq_device(traces, **kwargs)
    for i in range(n):
        oracle = sf.chi_squared_step_fitter(
            tuple(float(v) for v in traces[i]), **kwargs)
        _assert_equal_fits(got[i], oracle, (trial, i, kwargs))
        _assert_equal_fits(got[i], want[i], (trial, i, kwargs))


def test_device_engine_flat_trace_and_validation():
    # Flat trace: the best fit never grows; S takes the bf_res == 0 -> 1e10
    # branch; the result is the single whole-trace plateau.
    flat = np.full((1, 20), 3000.0)
    out = cd.chi_squared_fit_device(flat, num_steps=4, device="cpu")
    oracle = sf.chi_squared_step_fitter(tuple(flat[0]), num_steps=4)
    _assert_equal_fits(out[0], oracle, "flat")
    _assert_equal_fits(out[0], jax_chisq_device(flat, num_steps=4)[0],
                       "flat")
    with pytest.raises(ValueError, match="num_steps"):
        cd.chi_squared_fit_device(flat, num_steps=19, device="cpu")
    with pytest.raises(ValueError, match="num_steps_multiplier"):
        cd.chi_squared_fit_device(flat, num_steps_multiplier=0,
                                  device="cpu")
    assert cd.chi_squared_fit_device(np.zeros((0, 10)), num_steps=2,
                                     device="cpu") == []
    # num_steps from the multiplier: min(ceil(m T), T - 2), as the oracle.
    rng = np.random.default_rng(2)
    traces = _make_traces(rng, 3, 12)
    got = cd.chi_squared_fit_device(traces, num_steps_multiplier=0.5,
                                    device="cpu")
    for i in range(3):
        _assert_equal_fits(got[i], sf.chi_squared_step_fitter(
            tuple(traces[i]), num_steps_multiplier=0.5), i)


def test_batch_api_device_engine_on_the_cpu():
    """chi_squared_fit_batch(engine="device", device="cpu") runs the torch
    program and equals the native core; num_steps = T - 1 runs on the
    native core whatever the engine."""
    traces = synth.make_chisq_traces(40, 50, seed=3)
    for kw in (dict(num_steps=6), dict(num_steps=10, min_step_length=0),
               dict(num_steps=4, ignore_counterfits=True)):
        native = sf.chi_squared_fit_batch(traces, engine="native",
                                          n_threads=1, **kw)
        device = sf.chi_squared_fit_batch(traces, engine="device",
                                          device="cpu", **kw)
        for i, (a, b) in enumerate(zip(native, device)):
            _assert_equal_fits(b, a, (kw, i))
    short = traces[:4, :8]
    assert sf.chi_squared_fit_batch(short, num_steps=7, engine="device",
                                    device="cpu") == \
        sf.chi_squared_fit_batch(short, num_steps=7, n_threads=1)
    assert sf.chi_squared_fit_batch(np.zeros((0, 8)), engine="device",
                                    device="cpu") == []


def test_program_pieces_on_a_batch():
    """The batched segment bounds and the counterfit mask, checked on a
    hand-made batch."""
    starts = torch.tensor([[1, 0, 0, 1, 0, 1],
                           [1, 1, 0, 0, 0, 0]], dtype=torch.bool)
    a, b = cd._segment_bounds(starts)
    assert a.tolist() == [[0, 0, 0, 3, 3, 5], [0, 1, 1, 1, 1, 1]]
    assert b.tolist() == [[2, 2, 2, 4, 4, 5], [0, 5, 5, 5, 5, 5]]
    cf = torch.tensor([[1, 0, 0, 0, 1, 0],
                       [1, 0, 0, 0, 0, 0]], dtype=torch.bool)
    forbidden = cd._counterfit_forbidden(starts, cf)
    assert forbidden.tolist() == [
        [True, True, True, True, True, False],
        [True, False, False, False, False, False]]
