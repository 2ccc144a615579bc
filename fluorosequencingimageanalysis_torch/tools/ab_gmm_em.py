"""Kernel E's layouts, compared on one card in turns.

    python -m fluorosequencingimageanalysis_torch.tools.ab_gmm_em \\
        [--against NAME=PATH.cu ...] [--reps 5]

Builds csrc/gmm_em.cu with other values of its CLUSTER (blocks that split
one group's points), WARPS (warps a block), MIN_BLOCKS (blocks an SM the
registers must allow), UNROLL (points a thread's loop interleaves) and
TILE_MAX (points a block stages at once) constants, one nvcc per variant,
all at once;
``--against`` adds another source of the same C entry point
(``gmm_em_launch``), such as an earlier commit's csrc/gmm_em.cu unpacked
with its header beside it, built with its own directory first on the
include path. At config 5's mixtures shape (12 cycles x 100,000 points,
50 models: k 2-6 x 10 restarts, K = 6; the starts ``per_cycle_gmm``
builds) it checks every build against the plain twin after 3 rounds,
model by model, at the CPU tests' tolerances, and two 100-round launches
for equal bits; then times each 100-round launch with CUDA events,
``--reps`` runs in one order and as many in the reverse order, and prints
for each its median ms, its share of the special-function bound
(chip_smoke.py::bound_e's count: k exp2 and one log2 a point, model and
pass, at 16 a clock on each SM at 1.98 GHz), its registers and spill
bytes (ptxas) and its warps an SM (the occupancy API). Needs one CUDA
card and nvcc; imports no jax.
"""

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import tempfile

import numpy as np
import torch

from .. import _build
from ..inference.gmm import _collect_raw
from ..ops import gmm_batch as gb
from ..ops.fused_gmm_em import GEOMETRY_KEYS
from ..utils.synth import make_gmm_photometries

# (CLUSTER, WARPS, MIN_BLOCKS, UNROLL, TILE_MAX): the kept form first
# (csrc/gmm_em.cu's constants), then other block shapes of it; CLUSTER = 1
# streams each group's points from L2 every round, shared by the block's
# models, with no cluster reduction.
VARIANTS = [(4, 16, 2, 2, 16384), (2, 16, 2, 1, 16384), (8, 8, 3, 2, 16384),
            (1, 16, 2, 2, 16384)]
T, F, KS, N_INIT, N_ITER, REG = 100_000, 12, (2, 3, 4, 5, 6), 10, 100, 1e-6
LL_REL, MEAN_ABS, W_ABS, VAR_REL, VAR_OF_MOMENT = 1e-5, 1e-3, 1e-3, 1e-3, 1e-5
PEAK_SFU_OPS = 132 * 16 * 1.98e9
# Blocks an SM of any build, for the sources that have no gmm_em_geometry:
# appended to the source, it asks the occupancy API about gmm_em_kernel<K>
# at the THREADS and dynamic shared memory the source launches it with.
OCCUPANCY_PROBE = r"""
template <int K>
int ab_blocks_per_sm(int* out) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, gmm_em_kernel<K>, THREADS, 0));
}
extern "C" int ab_occupancy(int K, int* out) {
  switch (K) {
    case 1: return ab_blocks_per_sm<1>(out);
    case 2: return ab_blocks_per_sm<2>(out);
    case 3: return ab_blocks_per_sm<3>(out);
    case 4: return ab_blocks_per_sm<4>(out);
    case 5: return ab_blocks_per_sm<5>(out);
    case 6: return ab_blocks_per_sm<6>(out);
    case 7: return ab_blocks_per_sm<7>(out);
    case 8: return ab_blocks_per_sm<8>(out);
    default: return -1;
  }
}
"""


def _report(text):
    """(the most registers, all spill bytes, {K: (registers, spill bytes)})
    from ptxas's report of one build (one kernel a K)."""
    per_k = {}
    for block in text.split("Compiling entry function")[1:]:
        k = re.search(r"gmm_em_kernelILi(\d+)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        if k and regs:
            per_k[int(k.group(1))] = (int(regs.group(1)), sum(
                int(b) for b in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", block)))
    regs = max(int(r) for r in re.findall(r"Used (\d+) registers", text))
    spills = sum(int(b) for b in re.findall(
        r"(\d+) bytes spill (?:stores|loads)", text))
    return regs, spills, dict(sorted(per_k.items()))


def build(tmp, against):
    """{label: (library, registers, spill bytes, {K: (registers, spill
    bytes)})}, every build at once."""
    with open(os.path.join(_build.CSRC, "gmm_em.cu")) as f:
        src = f.read()
    jobs = {}
    for cluster, warps, blocks, unroll, tile in VARIANTS:
        text = src
        for name, val in (("CLUSTER", cluster), ("WARPS", warps),
                          ("MIN_BLOCKS", blocks), ("UNROLL", unroll),
                          ("TILE_MAX", tile)):
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {val};", text)
            if n != 1:
                raise RuntimeError(f"csrc/gmm_em.cu has no {name} constant")
        label = (f"cluster {cluster}, {warps} warps, >= {blocks} blocks/SM, "
                 f"unroll {unroll}, tiles <= {tile}")
        jobs[label] = (text, _build.CSRC)
    for spec in against:
        label, path = spec.split("=", 1)
        with open(path) as f:
            jobs[label] = (f.read() + OCCUPANCY_PROBE,
                           os.path.dirname(os.path.abspath(path)))
    procs = {}
    for i, (label, (text, inc)) in enumerate(jobs.items()):
        path = os.path.join(tmp, f"gmm_em_{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        so = path[:-3] + ".so"
        procs[label] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.flags("gmm_em"), "-I", inc, "-o",
             so, path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for label, (so, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{report}")
        out[label] = (ctypes.CDLL(so), *_report(report))
    return out


def warps_per_sm(lib, G, N, B, K):
    """(warps an SM, the geometry dict or None) of one build."""
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    if hasattr(lib, "gmm_em_geometry"):
        fn = lib.gmm_em_geometry
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        if fn(G, N, B, K, ctypes.addressof(out)) != 0:
            raise RuntimeError("gmm_em_geometry failed")
        geo = dict(zip(GEOMETRY_KEYS, out))
        return geo["blocks_per_sm"] * geo["warps"], geo
    fn = lib.ab_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    if fn(K, ctypes.addressof(out)) != 0:
        raise RuntimeError("the occupancy probe failed")
    # The first form launches one block of 4 warps per model.
    return out[0] * 4, None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    metavar="NAME=PATH.cu")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_gmm_em: torch sees no CUDA device")
    dev = torch.device("cuda")
    ks = list(KS)
    phot = make_gmm_photometries(T, F)
    groups = [np.asarray(_collect_raw(phot, c), np.float64)
              for c in range(F)]
    n_valid = np.array([g.size for g in groups])
    z, _, _, starts = gb.prepare(groups, ks, N_INIT, 0, 2048)
    zt = torch.from_numpy(z).to(dev)
    counts = torch.from_numpy(n_valid.astype(np.int32)).to(dev)
    st = [torch.from_numpy(a).to(dev) for a in starts]
    G, B, K = st[0].shape
    act = starts[3]
    valid = (torch.arange(z.shape[1], device=dev)[None, :] <
             counts[:, None].long()).float()
    stream = torch.cuda.current_stream().cuda_stream
    comps = sum(ks) * N_INIT
    sfu = (N_ITER + 1) * float(n_valid.sum()) * (comps + len(ks) * N_INIT)
    bound_ms = sfu / PEAK_SFU_OPS * 1e3

    def run(lib, n_iter):
        fn = lib.gmm_em_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 +
                       [ctypes.c_void_p] * 4 +
                       [ctypes.c_int, ctypes.c_float] +
                       [ctypes.c_void_p] * 5)
        out = [torch.empty_like(st[0]) for _ in range(3)] + [
            torch.empty((G, B), device=dev)]
        err = fn(zt.data_ptr(), counts.data_ptr(), G, z.shape[1], B, K,
                 *(t.data_ptr() for t in st), n_iter, REG,
                 *(t.data_ptr() for t in out), stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    def host(out):
        return [t.double().cpu().numpy() for t in out]

    want = host(gb._em_plain(zt, valid, *st, 3, REG))
    with tempfile.TemporaryDirectory() as tmp:
        builds = build(tmp, args.against)
        rows = {}
        for label, (lib, regs, spills, per_k) in builds.items():
            got = host(run(lib, 3))
            moment = want[1] ** 2 + want[2]
            errs = {"loglik_rel": float((np.abs(got[3] - want[3]) /
                                         np.abs(want[3])).max()),
                    "mean_abs": float(np.abs(got[1] - want[1])[act].max()),
                    "weight_abs": float(np.abs(got[0] - want[0]).max())}
            within = (errs["loglik_rel"] <= LL_REL and
                      errs["mean_abs"] <= MEAN_ABS and
                      errs["weight_abs"] <= W_ABS and
                      (np.abs(got[2] - want[2]) <= np.maximum(
                          VAR_REL * want[2], VAR_OF_MOMENT * moment))[
                              act].all())
            a, b = run(lib, N_ITER), run(lib, N_ITER)
            torch.cuda.synchronize()
            repeats = all(torch.equal(x, y) for x, y in zip(a, b))
            wps, geo = warps_per_sm(lib, G, z.shape[1], B, K)
            rows[label] = dict(registers=regs, spill_bytes=spills,
                               per_k=per_k,
                               warps_per_sm=wps, geometry=geo,
                               within_tolerance_after_3=bool(within),
                               repeats_bit_for_bit=repeats, **errs,
                               times=[])
        for order in (list(builds), list(builds)[::-1]):
            for label in order:
                lib = builds[label][0]
                run(lib, N_ITER)
                for _ in range(args.reps):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    start.record()
                    run(lib, N_ITER)
                    end.record()
                    torch.cuda.synchronize()
                    rows[label]["times"].append(start.elapsed_time(end))
    print(f"config 5 mixtures: G = {G} x N = {int(n_valid.max())}, B = {B}, "
          f"K = {K}, {N_ITER} rounds; special-function bound "
          f"{bound_ms:.3f} ms", flush=True)
    for label, r in rows.items():
        t = r.pop("times")
        med = statistics.median(t)
        print(f"{label}: median {med:.3f} ms (min {min(t):.3f}, max "
              f"{max(t):.3f}), {100 * bound_ms / med:.1f}% of the bound, "
              f"{r['registers']} registers, {r['spill_bytes']} spill bytes "
              f"(K: registers, spills {r['per_k']}), "
              f"{r['warps_per_sm']} warps/SM, within the tolerances after 3 "
              f"rounds: {r['within_tolerance_after_3']} (loglik "
              f"{r['loglik_rel']:.2e}, mean {r['mean_abs']:.2e}, weight "
              f"{r['weight_abs']:.2e}), bit-repeatable: "
              f"{r['repeats_bit_for_bit']}, geometry {r['geometry']}",
              flush=True)
    print(torch.cuda.get_device_name(0), flush=True)


if __name__ == "__main__":
    main()
