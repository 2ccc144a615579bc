"""Shared fixtures of the benchmark's own tests (CPU, tiny shapes)."""

from __future__ import annotations

import copy

import pytest

from fsbench import registry


def tiny(name):
    """Cell ``name`` and its configuration, cut to a size the CPU runs in
    seconds: the same distributions on 128x128 images."""
    cell = copy.deepcopy(registry.cell(name))
    config = copy.deepcopy(registry.config(cell["config"]))
    config.update(height=128, width=128)
    if config["entry"] == "run_experiment":
        config.update(fields=3, cycles=4)
        config["call"].update(max_candidates=512, max_spots=256)
        cell["params"]["spots_per_field"] = min(
            cell["params"]["spots_per_field"], 60)
    else:
        config["frames"] = 10
        config["call"].update(max_candidates=1024, max_spots=256)
        cell["params"]["spots"] = 50
    cell["sample_calls"] = 2
    cell["warmup_calls"] = 1
    return cell, config


@pytest.fixture
def card():
    """The CUDA device, or a skip where this process sees none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this process sees none")
    return torch.device("cuda")
