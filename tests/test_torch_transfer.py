"""The port's transfer layer (``_transfer.py``) and sharding rule
(``_device.py``), on the CPU, and the layering they make possible: the
modules below the front doors reach neither ``api`` nor ``parallel``, and
only the transfer layer (and the profiler's timing events) stages pinned
memory or makes CUDA events.

The same calls on a card are in ``tests/test_torch_cuda.py``.
"""

import ast
import os

import numpy as np
import pytest
import torch

import fluorosequencingimageanalysis_torch as port
from fluorosequencingimageanalysis_torch._device import (Mesh, data_devices,
                                                         make_mesh, shares)
from fluorosequencingimageanalysis_torch._transfer import (
    Uploader, count_fetched, fetch, wait)
from fluorosequencingimageanalysis_torch.utils import profiling

torch.set_num_threads(1)  # tier-1 runs several xdist workers per host

PORT_DIR = os.path.dirname(os.path.abspath(port.__file__))
PACKAGE = "fluorosequencingimageanalysis_torch"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _host(n=10, w=3, dtype=torch.int32):
    return torch.arange(n * w).reshape(n, w).to(dtype)


def _uploads():
    c = profiling.counters()
    return c.get("ledger/uploads", 0), c.get("ledger/upload_bytes", 0)


def test_uploader_pieces_are_the_host_slices_and_resident_rows_are_sliced():
    """A tensor already on the pieces' device is sliced, not copied, and
    not counted; ``take`` drops the uploader's reference to the piece."""
    host = _host()
    pieces = [(0, 4, CPU), (4, 7, CPU), (7, 10, CPU)]
    up = Uploader(host, pieces)
    for i in range(len(pieces)):
        up.upload(i)
    up.upload(0)                            # once only
    for i, (lo, hi, _) in enumerate(pieces):
        part = up.take(i)
        assert torch.equal(part, host[lo:hi])
        assert part.data_ptr() == host[lo:hi].data_ptr()   # a view
        assert up.parts[i] is None
    assert up.host is None and up.streams == {}
    assert _uploads() == (0, 0)


@pytest.mark.parametrize("dtype", [torch.uint16, torch.float64])
def test_from_host_counts_every_piece(dtype):
    """``from_host``: every piece is an upload, counted with its bytes,
    even where the rows already lie on the device."""
    host = _host(9, 5, dtype)
    pieces = [(0, 5, CPU), (5, 9, CPU)]
    up = Uploader(host, pieces, from_host=True)
    parts = [up.take(i) for i in range(len(pieces))]
    assert torch.equal(torch.cat(parts), host)
    assert _uploads() == (2, host.numel() * host.element_size())


def test_rows_bound_for_another_device_are_copied_and_counted():
    """A piece for a device the rows are not on is copied there (the meta
    device stands in for one), counted, and never pinned."""
    host = _host(6, 2, torch.float32)
    meta = torch.device("meta")
    up = Uploader(host, [(0, 2, meta), (2, 6, CPU)])
    a, b = up.take(0), up.take(1)
    assert a.device == meta and a.shape == (2, 2)
    assert torch.equal(b, host[2:6])
    assert up.host is None
    assert _uploads() == (1, 2 * 2 * 4)


def test_uploader_over_shares_rebuilds_the_rows():
    host = _host(11, 4, torch.int64)
    spans = shares(11, ["cpu"] * 3)
    up = Uploader(host, spans, from_host=True)
    assert torch.equal(torch.cat([up.take(i) for i in range(3)]), host)
    assert _uploads() == (3, host.numel() * 8)


def test_fetch_then_wait_passes_cpu_values_through():
    tensors = [torch.arange(6, dtype=torch.float32).reshape(2, 3),
               torch.tensor([True, False]), torch.zeros(0, dtype=torch.int16)]
    pending = fetch(tensors)
    host, event = pending
    assert event is None
    arrays = wait(pending)
    assert arrays is host
    for a, t in zip(arrays, tensors):
        assert isinstance(a, np.ndarray) and a.dtype == t.numpy().dtype
        np.testing.assert_array_equal(a, t.numpy())
        if t.numel():
            assert a.ctypes.data == t.data_ptr()   # no copy on the CPU
    assert wait(fetch([])) == []
    assert "ledger/result_fetches" not in profiling.counters()


def test_count_fetched_counts_arrays_and_bytes():
    arrays = [np.zeros((3, 4), np.float32), np.zeros(5, np.int16),
              np.zeros(0, bool)]
    count_fetched(arrays)
    count_fetched(arrays[:1])
    c = profiling.counters()
    assert c["ledger/result_fetches"] == 4
    assert c["ledger/fetch_bytes"] == 2 * 48 + 10


def test_shares_and_data_devices_live_in_device():
    assert data_devices("cpu") == [CPU]
    mesh = make_mesh(devices=["cpu"] * 6, data_axis=3)
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 3, "model": 2}
    assert data_devices(mesh) == [CPU] * 3
    assert shares(7, mesh) == [(0, 3, CPU), (3, 5, CPU), (5, 7, CPU)]
    assert shares(1, ["cpu"] * 3) == [(0, 1, CPU)]
    assert shares(0, "cpu") == [(0, 0, CPU)]
    with pytest.raises(ValueError, match="empty device list"):
        shares(3, [])


def _port_sources():
    for root, dirs, files in os.walk(PORT_DIR):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                yield os.path.relpath(path, PORT_DIR), path


def _imported_modules(rel, tree):
    """Absolute names of every module an import in ``tree`` (the source
    at ``rel`` in the package) reaches, function-local imports too."""
    here = [PACKAGE] + rel.split(os.sep)[:-1]   # the source's package
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            base = (here[:len(here) - node.level + 1] if node.level
                    else [])
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod
            for a in node.names:
                yield f"{mod}.{a.name}"


def test_layers_below_the_front_doors_import_neither_api_nor_parallel():
    """ops/, models/, pipeline/, sim/ and native/ reach the sharding rule
    and the transfer layer downward (``_device``, ``_transfer``), never
    up into ``parallel`` or ``api``."""
    upward = (f"{PACKAGE}.api", f"{PACKAGE}.parallel")
    lower = ("ops", "models", "pipeline", "sim", "native")
    seen = 0
    for rel, path in _port_sources():
        if rel.split(os.sep)[0] not in lower:
            continue
        with open(path) as f:
            tree = ast.parse(f.read())
        seen += 1
        bad = sorted({m for m in _imported_modules(rel, tree)
                      if m in upward or m.startswith(
                          tuple(u + "." for u in upward))})
        assert not bad, (rel, bad)
    assert seen >= 40


def test_only_the_transfer_layer_pins_memory_or_makes_cuda_events():
    """``pin_memory`` (a call or a keyword) and ``torch.cuda.Event(`` appear
    only in ``_transfer.py`` and ``utils/profiling.py`` (its timing
    events); the A/B tools under ``tools/`` time with events of their
    own. Two copies stay on the current stream, where the uploader's side
    stream and events measured slower: the step fitter's pieces and the
    hole gathers' indices (their results come back through
    ``_transfer.fetch``). The file loader reads each image into a pinned
    buffer, which the uploader reads as it is (``pipeline/files.py``)."""
    layer = {"_transfer.py", os.path.join("utils", "profiling.py")}
    left_as_they_were = {os.path.join("ops", "stepfit_batch.py"),
                         os.path.join("pipeline", "fast_experiment.py")}
    loader = {os.path.join("pipeline", "files.py")}
    pins, events = set(), set()
    for rel, path in _port_sources():
        if rel.split(os.sep)[0] == "tools":
            continue
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute)
                    and node.attr == "pin_memory") or (
                    isinstance(node, ast.keyword)
                    and node.arg == "pin_memory"):
                pins.add(rel)
            if (isinstance(node, ast.Call)
                    and ast.unparse(node.func) == "torch.cuda.Event"):
                events.add(rel)
    assert pins == {"_transfer.py"} | left_as_they_were | loader
    assert events == layer
