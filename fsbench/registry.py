"""Find the benchmark's files by name."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(*parts):
    path = os.path.join(HERE, *parts)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no such benchmark file: {path}")
    with open(path) as fh:
        return json.load(fh)


def _load_module(kind, name):
    """``fsbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    mod_name = f"fsbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def benchmark():
    """BENCHMARK.json at the root of the repository."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(name):
    return _load_json("workloads", name + ".json")


def config(name):
    return _load_json("configs", name + ".json")


def generator(name):
    return _load_module("traffic", name)


def entry(name):
    return _load_module("entries", name)


def metric(name):
    return _load_module("metrics", name)


def cell_metrics(bench, cell_name, per_layer):
    """Names of the metrics ``cell_name`` reports: the end-to-end ones
    (``per_layer`` False) or the per-layer ones, each listed for the cell
    or for every cell (no ``workloads`` key)."""
    key = "per_layer" if per_layer else "end_to_end"
    return [m["name"] for m in bench[key]
            if "workloads" not in m or cell_name in m["workloads"]]
