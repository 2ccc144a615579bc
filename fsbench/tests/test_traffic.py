"""The generators: the same seed gives the same stack, and what they plant
is what the cell files say."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fsbench import registry
from fsbench.tests.conftest import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["seqrun.dense", "seqrun.sparse",
                                  "zstack.frames32"])
def test_same_seed_same_stack(name):
    cell, config = tiny(name)
    gen = registry.generator(cell["generator"])
    big = 2 ** 31 + 12345
    a = gen.generate(cell["params"], config, big, 0, CPU)
    b = gen.generate(cell["params"], config, big, 0, CPU)
    c = gen.generate(cell["params"], config, big, 1, CPU)
    d = gen.generate(cell["params"], config, big + 1, 0, CPU)
    assert a.dtype == np.uint16
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, d)


@pytest.mark.parametrize("name", ["seqrun.dense", "seqrun.sparse"])
def test_experiment_plants_what_the_cell_says(name):
    cell, config = tiny(name)
    p = cell["params"]
    config.update(fields=4, cycles=12)
    gen = registry.generator(cell["generator"])
    stack, truth = gen.generate(p, config, 3, 0, CPU, return_truth=True)
    F, C, H, W = 4, 12, config["height"], config["width"]
    assert stack.shape == (F, C, H, W)
    pos, amp = truth["positions"], truth["amplitudes"]
    assert pos.shape == (F, p["spots_per_field"], 2)
    b = p["border"]
    assert pos.min() >= b and pos[..., 0].max() < H - b
    assert pos[..., 1].max() < W - b
    lo, hi = p["amplitude"]
    assert amp.min() >= lo and amp.max() <= hi
    pres = truth["presence"]
    assert pres[:, :, 0].all()
    rate = pres[:, :, 1:].mean()
    n = pres[:, :, 1:].size
    assert abs(rate - p["presence"]) < 4 * np.sqrt(
        p["presence"] * (1 - p["presence"]) / n)
    steps = np.diff(truth["drift"], axis=0)
    assert (truth["drift"][0] == 0).all()
    assert steps.min() >= p["drift"][0] and steps.max() <= p["drift"][1]
    # The noise floor: the median pixel is the noise mean.
    assert abs(np.median(stack) - p["noise"][0]) < 5


def test_zstack_plants_what_the_cell_says():
    cell, config = tiny("zstack.frames32")
    p = cell["params"]
    gen = registry.generator(cell["generator"])
    stack, truth = gen.generate(p, config, 3, 0, CPU, return_truth=True)
    T, H, W = config["frames"], config["height"], config["width"]
    assert stack.shape == (T, H, W) and stack.dtype == np.uint16
    assert truth["positions"].shape == (p["spots"], 2)
    lo, hi = p["amplitude"]
    assert truth["amplitudes"].min() >= lo
    assert truth["amplitudes"].max() <= hi
    # A corner far from spots reads the sloped background, breathing.
    corner = stack[:, :4, :4].astype(np.float64).mean(axis=(1, 2))
    t = np.arange(T)
    expect = p["base"] * (1 + p["breathing"] * np.sin(
        t / p["breathing_period"]))
    assert np.abs(corner - expect).max() < 25
