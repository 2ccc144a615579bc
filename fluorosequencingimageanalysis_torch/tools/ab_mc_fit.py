"""Kernel D's block shape, compared on one card in turns.

    python -m fluorosequencingimageanalysis_torch.tools.ab_mc_fit

Builds csrc/mc_fit.cu with other values of its PARTS (warps a block, each
scanning one range of the samples) and CANDS (candidates a block)
constants, one nvcc per variant, all at once; checks every variant
against the plain twin bit for bit on frame 0 of config 2 (8,192
candidates x 1,000 samples, the Monte-Carlo frame of chip_smoke.py); then
times each with CUDA events, 10 runs in one order and 10 in the reverse
order, and prints each variant's registers, spill bytes and median ms.
Needs one CUDA card and nvcc; imports no jax.
"""

import ctypes
import os
import re
import statistics
import subprocess
import tempfile

import numpy as np
import torch

from .. import _build
from ..models import detect
from ..ops.candidates import find_candidates, gather_patches
from ..ops.mc_fit import mc_fit_plain, normalise_patches, sample_params
from ..utils.synth import make_zstack

VARIANTS = [(4, 32), (8, 32), (16, 32), (8, 64)]  # (PARTS, CANDS)
K, N_ITER, REPS = 8192, 1000, 10


def build(tmp):
    """{variant: (launch function, registers, spill bytes)}."""
    with open(os.path.join(_build.CSRC, "mc_fit.cu")) as f:
        src = f.read()
    procs = {}
    for parts, cands in VARIANTS:
        text = re.sub(r"constexpr int PARTS = \d+;",
                      f"constexpr int PARTS = {parts};", src)
        text = re.sub(r"constexpr int CANDS = \d+;",
                      f"constexpr int CANDS = {cands};", text)
        path = os.path.join(tmp, f"mc_fit_{parts}_{cands}.cu")
        with open(path, "w") as f:
            f.write(text)
        so = path[:-3] + ".so"
        procs[(parts, cands)] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.flags("mc_fit"), "-I", _build.CSRC,
             "-o", so, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (so, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{report}")
        fn = ctypes.CDLL(so).mc_fit_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 +
                       [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        regs = max(int(r) for r in re.findall(r"Used (\d+) registers",
                                              report))
        spills = sum(int(b) for b in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", report))
        out[key] = (fn, regs, spills)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ab_mc_fit: torch sees no CUDA device")
    dev = torch.device("cuda")
    frame = make_zstack(1, 512, 512, n_spots=800, seed=4)[0]
    img = torch.from_numpy(frame.astype(np.float32)).to(dev)
    hs, ws, _, _ = find_candidates(img, max_candidates=K)
    patches = normalise_patches(gather_patches(img, hs, ws))
    samples = sample_params(patches, detect.draw_mc_normals(
        N_ITER, K, 0, dev)).contiguous()
    want = mc_fit_plain(patches, samples)
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn):
        best_p = torch.empty((K, 6), device=dev)
        best_norm = torch.empty((K,), device=dev)
        err = fn(patches.data_ptr(), samples.data_ptr(), K, N_ITER,
                 best_p.data_ptr(), best_norm.data_ptr(), stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return best_p, best_norm

    with tempfile.TemporaryDirectory() as tmp:
        variants = build(tmp)
        times = {key: [] for key in variants}
        for key, (fn, _, _) in variants.items():
            got = run(fn)
            torch.cuda.synchronize()
            if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(got, want)):
                raise RuntimeError(f"{key} differs from the twin")
        for order in (list(variants), list(variants)[::-1]):
            for key in order:
                fn = variants[key][0]
                run(fn)
                for _ in range(REPS):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    a.record()
                    run(fn)
                    b.record()
                    torch.cuda.synchronize()
                    times[key].append(a.elapsed_time(b))
        for (parts, cands), (_, regs, spills) in variants.items():
            t = times[(parts, cands)]
            print(f"warps a block {parts:2d}, candidates a block {cands}: "
                  f"{regs} registers, {spills} spill bytes, median "
                  f"{statistics.median(t):.4f} ms (min {min(t):.4f}), "
                  f"bit-equal to the twin", flush=True)
    print(torch.cuda.get_device_name(0), flush=True)


if __name__ == "__main__":
    main()
