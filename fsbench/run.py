"""Run one cell of the benchmark once and print its result line.

    python3 -m fsbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the cell's inputs on the device from ``--seed`` and copies
them to the host, builds the entry and warms it up on the cell's own
shapes. The window then calls the entry back to back, cycling through the
inputs, for ``--seconds`` (whole calls; the last one ends past it). After
the window the peak memory is read, the program's state is freed, and the
plain reference checks one call drawn from the seed. With ``--trace 1``
the window runs under torch.profiler with the port's stage timings on,
and the per-layer metrics are reported instead of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, each number the check compared
beside its limit (also the last lines of standard error). A run on a
machine without the CUDA devices the cell asks for, or one that finds JAX
or the JAX package loaded, exits with a code other than 0 and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import random
import sys
import time
import traceback

T_IMPORT = time.time()

if __package__ in (None, ""):   # run as a file: make ``fsbench`` importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from fsbench import isolation, registry  # noqa: E402


def process_start_time():
    """Wall-clock time at which this process started (Linux /proc), else
    the time this module was imported."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            boot = next(int(line.split()[1]) for line in fh
                        if line.startswith("btime "))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def cache_dirs():
    """Build and kernel caches of the program, at fixed paths inside the
    checkout."""
    base = os.path.join(registry.ROOT, ".fsbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))


def _finite(x):
    """``x`` as a float, or None where it is not finite (JSON has no
    infinity): a check that found nothing to compare."""
    x = float(x)
    return x if math.isfinite(x) else None


class Run:
    """What a finished run holds for the metric readers."""

    def __init__(self, name, cell, config, entry, inputs, device):
        self.name, self.cell, self.config = name, cell, config
        self.entry, self.inputs, self.device = entry, inputs, device
        self.calls = []
        self.window_start = None
        self.setup_s = None
        self.stages = None
        self.trace = None
        self._work = None

    def kernel_seconds(self, symbol):
        """Device seconds of the operations whose name holds ``symbol``."""
        if not self.trace:
            return 0.0
        return sum(s for n, s in self.trace["kernels"].items()
                   if symbol in n)

    def call_work(self):
        """The entry's ``kernel_work`` for each call of the window."""
        if self._work is None:
            self._work = [self.entry.kernel_work(x, self.config, self.device)
                          for x in self.inputs]
        return [self._work[c["input"]] for c in self.calls]


def run_cell(name, seed, seconds, trace, device="cuda", setup_start=None,
             cell=None, config=None):
    """One run of cell ``name`` (its files, unless ``cell`` and ``config``
    are given); returns (Run, result dict)."""
    import torch

    setup_start = process_start_time() if setup_start is None else \
        setup_start
    cell = registry.cell(name) if cell is None else cell
    config = registry.config(cell["config"]) if config is None else config
    generator = registry.generator(cell["generator"])
    entry = registry.entry(config["entry"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    workdir = os.path.join(registry.ROOT, ".fsbench_run", name)
    os.makedirs(workdir, exist_ok=True)

    inputs = [generator.generate(cell["params"], config, seed, i, dev)
              for i in range(cell["inputs"])]
    run = Run(name, cell, config, entry, inputs, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    driver = entry.Driver(config, workdir, device, profile=bool(trace))
    n_in = len(inputs)
    for i in range(cell["warmup_calls"]):
        driver.call(inputs[i % n_in])
    if on_card:
        torch.cuda.synchronize()
    images = entry.images_per_call(config)
    sample_at = random.Random(seed).randrange(cell["sample_calls"])
    tracer = None
    kept = last = None
    failed = 0
    with contextlib.ExitStack() as scope:
        if trace:
            from fsbench.entries.common import reset_stages, stages_as_spans
            from fsbench.trace import DeviceTrace
            reset_stages()
            scope.callback(stages_as_spans())
            tracer = scope.enter_context(DeviceTrace(name + "/window"))
            scope.enter_context(tracer.span(name + "/window"))
        run.window_start = time.perf_counter()
        run.setup_s = time.time() - setup_start
        i = 0
        while not run.calls or \
                time.perf_counter() - run.window_start < seconds:
            k = (cell["warmup_calls"] + i) % n_in
            t0 = time.perf_counter()
            ok = True
            try:
                with (tracer.span(name + "/call") if tracer
                      else contextlib.nullcontext()):
                    out = driver.call(inputs[k], keep=i == sample_at)
                    if on_card:
                        torch.cuda.synchronize()
            except Exception:   # a failed call counts; the window goes on
                traceback.print_exc()
                failed += 1
                ok, out = False, None
            t1 = time.perf_counter()
            run.calls.append({"start": t0, "end": t1, "images": images,
                              "input": k, "ok": ok})
            if i == sample_at:
                kept = (k, out)
            last = (k, out)
            i += 1
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if trace:
        from fsbench.entries.common import STAGE_PREFIX, stage_totals
        run.stages = stage_totals()
        run.trace = tracer.summary(
            host_spans=(name + "/call", STAGE_PREFIX))
        del tracer
    del driver
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # The check: the sampled call, or the last if the window ended first.
    k, sample = kept if kept is not None else last
    kept = last = None
    limits = cell["limits"]
    if sample is None:
        numbers = {n: float("inf") for n in limits}
    else:
        numbers = entry.check(inputs[k], sample, config, device)
    compared = {n: {"value": _finite(numbers[n]), "limit": limits[n]}
                for n in limits}
    correct = failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compared.values())

    bench = registry.benchmark()
    metrics = {}
    for m in registry.cell_metrics(bench, name, per_layer=bool(trace)):
        reader = registry.metric(m)
        value = reader.read(run)
        if value is not None:
            metrics[m] = {"value": value, "unit": reader.UNIT}
    result = {"correct": correct, "attempted": len(run.calls),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else dev.type,
                         "kind": (torch.cuda.get_device_name(dev)
                                  if on_card else "cpu"),
                         "count": cell["chips"],
                         "memory_peak_bytes": peak}}
    if trace and run.trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["compared"] = compared
    return run, result


def main(argv=None):
    setup_start = process_start_time()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = registry.cell(args.workload)
    cache_dirs()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"fsbench: cell {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; nothing measured", file=sys.stderr)
        return 3
    run, result = run_cell(args.workload, args.seed, args.seconds,
                           args.trace, setup_start=setup_start)
    found = isolation.loaded()
    if found:
        print("fsbench: the run loaded " + ", ".join(found) +
              "; no result", file=sys.stderr)
        return 4
    walls = [round((c["end"] - c["start"]) * 1e3, 1) for c in run.calls]
    print(f"fsbench: {len(walls)} calls, ms: {walls}", file=sys.stderr)
    for n, c in result["compared"].items():
        print(f"compared {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
