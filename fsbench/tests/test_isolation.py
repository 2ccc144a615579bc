"""What a run and the reference load, and a run without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from fsbench import isolation, registry

ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="", USE_FLAX="0")


def _py(code, *args):
    return subprocess.run([sys.executable, "-c", code, *args],
                          cwd=registry.ROOT, env=ENV, capture_output=True,
                          text=True, timeout=600)


def test_loaded_compares_whole_top_level_names():
    mods = {"fluorosequencingimageanalysis_torch.api": 1, "jaxtyping": 1,
            "numpy": 1}
    assert isolation.loaded(modules=mods) == []
    mods["jax.numpy"] = 1
    mods["fluorosequencingimageanalysis_tpu"] = 1
    assert isolation.loaded(modules=mods) == [
        "fluorosequencingimageanalysis_tpu", "jax"]


def test_reference_loads_neither_the_port_nor_jax():
    code = ("import sys, json\n"
            "import fsbench.reference.experiment, fsbench.reference.step\n"
            "import fsbench.reference.background, fsbench.reference.detect\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    out = _py(code)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & set(isolation.FORBIDDEN)
    assert isolation.PORT not in tops


def test_a_run_loads_no_jax():
    code = ("import sys, json\n"
            "from fsbench.tests.conftest import tiny\n"
            "from fsbench.run import run_cell\n"
            "from fsbench import isolation\n"
            "cell, config = tiny('zstack.frames32')\n"
            "run, res = run_cell('zstack.frames32', 5, 0.5, 0, device='cpu',"
            " cell=cell, config=config)\n"
            "print(json.dumps([res['correct'], isolation.loaded()]))")
    out = _py(code)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, found = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and found == []


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "fsbench.run", "--workload", "seqrun.dense",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=registry.ROOT, env=ENV, capture_output=True, text=True,
        timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
