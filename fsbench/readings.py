"""The readings a cell's limits are set from.

For each seed: the cell's first input, one call of the program on it, the
reference, and the control (the reference computed with every float that
leaves a stage rounded to bfloat16, the precision below the
configuration's float32) in the program's place. Prints one JSON line a
seed with the numbers the check compares for the program and for the
control, then the largest of each over the seeds for the program and the
smallest for the control.

    python3 -m fsbench.readings --workload seqrun.dense --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from fsbench import registry
from fsbench.reference.detect import bf16


def readings(name, seeds, device="cuda", cell=None, config=None,
             control=None):
    """``control``: on how many of the seeds (the first ones) to read the
    control; all of them by default."""
    import torch

    cell = registry.cell(name) if cell is None else cell
    config = registry.config(cell["config"]) if config is None else config
    gen = registry.generator(cell["generator"])
    entry = registry.entry(config["entry"])
    workdir = os.path.join(registry.ROOT, ".fsbench_run", name)
    os.makedirs(workdir, exist_ok=True)
    driver = entry.Driver(config, workdir, device)
    out = []
    n_control = len(seeds) if control is None else control
    for i, seed in enumerate(seeds):
        stack = gen.generate(cell["params"], config, seed, 0,
                             torch.device(device))
        sample = driver.call(stack, keep=True)
        ref = entry.reference(stack, config, device)
        line = {"seed": seed,
                "program": entry.compare(entry.read_sample(sample), ref)}
        if i < n_control:
            ctl = entry.reference(stack, config, device, lowp=bf16)
            line["control"] = entry.compare(entry.as_sample(ctl), ref)
        out.append(line)
        print(json.dumps(line), flush=True)
    names = list(out[0]["program"])
    summary = {"program_max": {n: max(r["program"][n] for r in out)
                               for n in names}}
    if n_control:
        summary["control_min"] = {n: min(r["control"][n] for r in out
                                         if "control" in r)
                                  for n in names}
    print(json.dumps(summary), flush=True)
    return out, summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=None,
                   help="read the control on the first N seeds only")
    args = p.parse_args(argv)
    readings(args.workload, args.seeds, control=args.control)
    return 0


if __name__ == "__main__":
    sys.exit(main())
