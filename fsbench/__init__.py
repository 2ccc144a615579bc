"""The benchmark of the PyTorch and CUDA port.

One run measures one cell (a configuration under a traffic mix) on the
machine it starts on:

    python3 -m fsbench.run --workload seqrun.dense --seed 7 --seconds 40 \\
        --trace 0

Everything that belongs to one configuration, cell, traffic generator,
entry point or metric sits in a file of its own, found by its name:
``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<generator>.py``, ``entries/<entry>.py`` and
``metrics/<metric>.py``. ``reference/`` is the plain reference that
decides ``correct``. BENCHMARK.json at the root of the repository names the
cells and which metrics each reports.
"""
