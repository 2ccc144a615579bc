"""What the file cell's reference and generator load: neither the port
nor JAX."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from fsbench import isolation, registry

ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="", USE_FLAX="0")


def test_tiff_reference_loads_neither_the_port_nor_jax():
    code = ("import sys, json\n"
            "import fsbench.reference.tiff\n"
            "import fsbench.traffic.experiment_files\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         env=ENV, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & set(isolation.FORBIDDEN)
    assert isolation.PORT not in tops


def test_files_reference_checks_without_the_port():
    """The files written and read back, and the whole reference of a tiny
    call, with the port unimportable."""
    code = ("import sys, json\n"
            "sys.modules['fluorosequencingimageanalysis_torch'] = None\n"
            "from fsbench.tests.test_files_cell import tiny\n"
            "from fsbench import registry, isolation\n"
            "cell, config = tiny()\n"
            "gen = registry.generator(cell['generator'])\n"
            "entry = registry.entry(config['entry'])\n"
            "import torch\n"
            "inputs = gen.generate(cell['params'], config, 7, 0,"
            " torch.device('cpu'))\n"
            "ref = entry.reference(inputs, config, 'cpu')\n"
            "print(json.dumps([len(ref['rows']), isolation.loaded()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         env=ENV, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    n, found = json.loads(out.stdout.strip().splitlines()[-1])
    assert n > 0 and found == []
