"""What the movie cell's reference loads: neither the port nor JAX."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from fsbench import isolation, registry

ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="", USE_FLAX="0")


def test_movie_reference_loads_neither_the_port_nor_jax():
    code = ("import sys, json\n"
            "import fsbench.reference.lctrack, fsbench.reference.stepfit\n"
            "import fsbench.reference.timetrace_csv\n"
            "import fsbench.traffic.movie_stack\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         env=ENV, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & set(isolation.FORBIDDEN)
    assert isolation.PORT not in tops


def test_movie_reference_checks_without_the_port():
    """The whole check (detection, tracker, photometry, step-fit chain,
    CSV) of a tiny movie runs with the port unimportable."""
    code = ("import sys, json\n"
            "sys.modules['fluorosequencingimageanalysis_torch'] = None\n"
            "from fsbench.tests.test_timetrace_cell import tiny\n"
            "from fsbench import registry, isolation\n"
            "cell, config = tiny()\n"
            "gen = registry.generator(cell['generator'])\n"
            "entry = registry.entry(config['entry'])\n"
            "import torch\n"
            "movie = gen.generate(cell['params'], config, 7, 0,"
            " torch.device('cpu'))\n"
            "ref = entry.reference(movie, config, 'cpu')\n"
            "print(json.dumps([len(ref['h']), isolation.loaded(),"
            " torch.backends.cuda.matmul.allow_tf32,"
            " torch.backends.cudnn.allow_tf32]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         env=ENV, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    n, found, tf32, cudnn_tf32 = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert n > 0 and found == [] and not tf32 and not cudnn_tf32
