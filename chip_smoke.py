#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # every check, the timings
    python3 chip_smoke.py --profile    # also profiler traces of both paths
    python3 chip_smoke.py --phases fluor,timetrace   # only those groups

Builds the hand-written kernels from csrc/ (nvcc, sm_90a, one process per
source, all at once) and reads ptxas's registers and spills for each,
checks each against its plain PyTorch twin on the card (kernel A bit for
bit, kernel B's parameters bit for bit, kernel C's winners, found flags
and scores bit for bit, kernel D's best samples and norms bit for bit),
times each beside its bound
(bytes over the memory rate or operations over the float32 rate), drives
the experiment step through ``Pipeline(device="cuda").run_stack`` on the
headline stack (8 fields x 4 cycles of 512x512, ~200 planted spots per
field, max_candidates=2048, num_iters=40, upsample_factor=20, mexican-hat
photometry) and checks its output, compares the card with the CPU on a
reduced stack, and times the step and its split into upload, device step
and download. Then the full experiment, config 4 (32 fields x 8 cycles of
512x512 uint16, ~2,000 spots per field with dropouts and stage drift,
max_candidates=4096, max_spots=3072, every other setting the config's
default), through ``Pipeline(device="cuda").run_experiment``: fields/s,
its stages, the overlap of the step with host tracking, peak memory, the
kernels' launches per run and both kernels against their twins at that
path's shapes, the recovery of planted spots, both CSVs, and the card
against the CPU on a reduced stack. Then the object layer (group
``objects``): the reference's class path (tools/class_path.py: detection,
``Image``/``Spot`` objects, ``SequenceExperiment`` registration, tracking,
the discard of invalid traces and the track CSV) on config 4's first 8
fields with the card as the default device: its rows against
``run_experiment``'s on the same fields (keys, categories and order equal,
photometry within rtol 1e-5, atol 1e-2), the card against the CPU on one
field, kernels A and B launched by it (one each a field) and held against
their twins at its shapes, the wall, its stage split and peak memory.
Then the z-stack and single-image front doors: the background estimator
against its float64 host oracle,
config 2 (32 frames of 512x512 uint16, 800 persistent spots on a sloped,
breathing background, max_candidates=8192, lean fetch of 2048 slots)
through ``Pipeline(device="cuda").run_zstack`` (frames/s, the stage
split, peak memory, launches, lean against the full schema, planted
recovery), the exhaustive path on 8 of those frames against the capped
run, ``find_peptides`` and ``find_peptides_batch`` and ``run_zstack``
against the CPU, and the ``zstack`` subcommand in a process of its own.
Then the movie front door and the step fitters: config 3 (4096 traces of
100 frames, mirror 10, one Chung-Kennedy pass, p 0.01) through
``Pipeline(device="cuda").stepfit`` (traces/s, the stage split, every
result against the CPU run and a sample against the float64 host chain),
the chi-squared fitter on 2048 x 100 traces (host work), a 24-frame movie
of a 512x512 field with 800 bleaching spots through ``run_timetrace``
(wall, traces/s, the stage split and the share of the wall no stage
names, the tracker loop alone, planted recovery, the CSV, both kernels at
this path's shapes), the card against the CPU on a reduced movie, and the
``stepfit`` subcommand in a process of its own.
Then fluor counting, config 5 (100,000 traces of 12 cycles, up to 5
fluors: 6,188 candidate sequences a trace): ``score_traces`` on the card
(traces/s, kernel C alone beside its bound, its twin and the matmul form
of the JAX package as the nearest composition of library calls, a sample
against the per-trace float64 host oracle, the card against the CPU,
``score_chunk_device``), a 20,000-row track CSV through
``Pipeline.fluor_counts`` on both ingestion paths and through
``fluor_counts_calibrated`` against the CPU runs, the experiment's own
track CSV through ``fluor_counts``, and the ``fluor-counts`` (manual and
``--auto-calibrate``), ``background-correct`` and ``remainder-correct``
subcommands each in a process of its own.
Then simulation and the Monte-Carlo detector: config 5's simulation half
(100,000 molecules of the two-colour 18-mer, 12 count cycles) through the
batched simulator (molecules/s, device time and operations, peak memory,
the count histograms against the host event loop, the card against the
CPU on identical draws), its simulate -> fit chain through kernel C
(molecules/s, chained against two-step), the native signal sampler into a
trie, frame 0 of config 2 through ``find_peptides(fit_type=
"monte_carlo")`` at 8,192 candidates and 1,000 samples (kernels A and D;
D against its twin bit for bit, beside its bound; the card against the CPU
on identical draws), and the ``simulate`` subcommand in a process of its
own.
Then the remaining batched fitters: config 5's traces as per-cycle
photometries (100,000 x 12, OFF frames drawn from N(2,000, 300^2)) through
kernel E against its twin (G = 12, N = 100,000, k 2-6, 10 restarts, 100
rounds: model by model after 3 rounds, the restarts and the BIC-selected k
after 100, beside its bound), ``Pipeline(device="cuda").per_cycle_gmm``
(wall, stage split, peak memory, launches, k per cycle), the plateau
fitter's float64 device scores against its exact host scores on 20,000
ladders, the device chi-squared engine against the native core on config
3's chi-squared set, and the four entry points on the card against the
CPU on 2,000 x 6 (with the BIC's k against scikit-learn's estimator, or
the port's where scikit-learn is absent); then the reference's own fits
on the port's estimators, ops/mixture.py and ops/kmeans.py, with no
scikit-learn (phases ``cluster_fit``: ``_parameter_sweep_2`` on the first
20,000 traces as an integer track CSV, its split, the card against the
CPU on 500; ``reference_gmm``: ``_per_cycle_gmm_MP`` on the mixtures,
its split, EM rounds and operations, ``gmm_raw_photometries``, the dpgmm
path's AttributeError, the card against the CPU on 3 x 2,000); then
kernel E beyond its register form (phase
``gmm_limits``): ``per_cycle_gmm`` at max_fluors=8 (K = 9) against the
twin, the largest K, more models than one launch takes, and a sliced call
against one launch bit for bit. The sim group ends with the reference's
four inference apps as the port's compat copies (phase
``inference_apps``): simulate_peptide's batched simulation and fit on the
card against the chained simulate -> fit, lognormal_fitter_v2 on the
20,000-row track CSV against ``Pipeline.fluor_counts``, and the two host
apps. Last, the multi-device layer on the one card (group ``parallel``):
the sharded step over two entries of the card against the one-device step
bit for bit, a ``Pipeline`` over that device list on config 4's first 8
fields against the one-device CSV, and ``multihost.run_experiment`` in two
processes over gloo, each child's CSV byte for byte the one-process CSV.
Then the file front doors (group ``files``), with nothing patched: the
images are read by the port's own TIFF and PNG decoders (the line
``files_readers`` says whether imageio and Pillow are importable). Config
4 as 256 uncompressed TIFF files through ``run-experiment`` in a process
of its own and in this one (both CSVs byte for byte ``run_experiment``'s
on the array; the read time, fields/s from files, launches of A and B);
config 2 as one 32-page TIFF through ``zstack`` (rows the API's kept
fits); the timetrace movie as one 24-page TIFF and as 24 PNG files
through ``timetrace`` (both CSVs byte for byte ``run_timetrace``'s);
``detect`` on 8 of config 2's frames (psfs artifacts against
``find_peptides`` on the card); the compat image and experiment scripts
on planted tif files, and basic_timetrace_script on the movie's frames
(on the card; on 8 frames its step fits against its own run on the CPU);
and the decoder matrix (one config-4 field uncompressed, PackBits,
Deflate, LZW, with the predictor, big-endian, tiled and as 16-bit PNG:
each read bit for bit, with its read time).
Group ``consolidate``: kernel F (the NMS) alone at the two paths' shapes,
a sequencing group's 96 x 4,096 fits (8 fields x 12 cycles of 512x512,
2,000 spots a field) and a z-stack group's 8 x 8,192 (config 2), each
fitted by kernel B: its keep mask and rounds against the plain twin's on
the card, both timed, the kernel beside its bound.
``--phases`` names the groups to run, of headline, consolidate,
experiment, objects, zstack, timetrace, fluor, sim, mixtures, parallel
and files (default: all, in that order);
the kernel summary then lists the kernels those groups drove.
``--profile`` adds the device's busy
share and its largest operations over three headline steps and over one
run_experiment, and a cProfile of one group's host half. Prints one
JSON line per phase, then the nvidia-smi name/power-limit line, the
kernel summary and, last, ``{"ok": true, "device": {...}}``. Any failed
check raises, so the exit code is non-zero; so is a process that sees no
CUDA device. Imports no jax.
"""

import argparse
import ast
import collections
import csv
import json
import math
import os
import platform
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

F, C, HW = 8, 4, 512
MAX_CANDIDATES, NUM_ITERS, UPSAMPLE = 2048, 40, 20
B_CENTER, B_R2, B_RMSE_REL, B_MODEL = 1e-3, 1e-4, 1e-4, 1e-3
SWEEP = [(48, 100), (33, 257), (70, 130), (96, 384)]
KERNELS = ("candidate_map", "fit_quality", "v8_score", "mc_fit", "gmm_em",
           "consolidate")
HOST_CORES = ("tracklink", "stepchain", "chisqfit", "trackcsv", "randsiggen")
# Groups of phases, in the order they run; --phases names a subset.
PHASES = ("headline", "consolidate", "experiment", "objects", "zstack",
          "timetrace", "fluor", "sim", "mixtures", "parallel", "files")
# Config 4 (bench.py's experiment workload): fields, cycles, candidate and
# spot buckets, timed runs after one warm-up.
EXP_F, EXP_C, EXP_K, EXP_S, EXP_REPS = 32, 8, 4096, 3072, 3
# The object layer's class path (the objects group): config 4's first
# OBJ_F fields on the card, the first OBJ_CPU_F of them on the CPU too; its
# rows against run_experiment's at the bound of
# tests/test_fast_experiment.py; the compat apps on planted 512x512 tif
# files of OBJ_APP_FIELDS fields x OBJ_APP_CYCLES cycles.
OBJ_F, OBJ_CPU_F = 8, 1
CLASS_RTOL, CLASS_ATOL = 1e-5, 1e-2
OBJ_APP_FIELDS, OBJ_APP_CYCLES, OBJ_APP_HW, OBJ_APP_SPOTS = 2, 3, 512, 300
# The file front doors (group files), each cell at its full size: config 4
# as 256 uncompressed TIFFs (a directory a cycle), config 2 as one 32-page
# TIFF, the timetrace movie as one 24-page TIFF and as 24 PNGs; detect on
# FILES_DETECT_T of config 2's frames; basic_timetrace_script on the card
# and the CPU on the movie's first FILES_TT_CPU_T frames; one config-4
# field in each entry of the decoder matrix, read FILES_READ_REPS times.
FILES_DETECT_T, FILES_TT_CPU_T, FILES_READ_REPS = 8, 8, 3
# Card against CPU on a reduced experiment: 2 fields x 8 cycles of 256x256
# at config 4's spot density.
EXP_SMALL = dict(F=2, C=8, H=256, W=256, spots_per_field=500, seed=1)
EXP_SMALL_K = 1024
# Config 2 (bench.py's z-stack workload): frames, candidate and lean spot
# buckets, timed runs after one warm-up; frames of the exhaustive run.
Z_T, Z_K, Z_S, Z_REPS, Z_EXH_T = 32, 8192, 2048, 3, 8
# Card against CPU on a reduced z-stack, and the background's bound
# against the float64 host oracle (share of the background's scale).
Z_SMALL = dict(T=4, H=256, W=256, n_spots=200, seed=2)
Z_SMALL_K = 2048
BG_BOUND = 5e-5
# A planted spot counts as isolated when no other lies within the
# consolidation radius (4 px) plus the 1 px tolerance.
ISOLATED_PX = 5.0
# Config 3 (bench.py::bench_stepfit) and bench.py::bench_chisq: traces,
# frames, timed runs after one warm-up, traces held against the host chain.
SF_N, SF_T, SF_REPS, SF_HOST_SAMPLE = 4096, 100, 3, 24
SF_KW = dict(mirror_start=10, chung_kennedy=1, p_threshold=0.01)
CHI_N, CHI_T, CHI_STEPS, CHI_HOST_SAMPLE = 2048, 100, 10, 12
# The timetrace movie (bench.py::bench_timetrace): frames and planted
# spots of a 512x512 field; the card against the CPU on a reduced movie.
TT_T, TT_SPOTS, TT_REPS = 24, 800, 3
TT_SMALL = dict(T=12, H=128, W=128, n_spots=30, seed=1)
# A trace starts at a rounded center (up to half a pixel of rounding on
# each axis), so its start is held within 1 px of the planted spot on each
# axis; a tracked position within 1.5 px (Euclidean) in every live frame.
TT_START_PX, TT_STAY_PX, TT_UNNAMED_SHARE = 1.0, 1.5, 0.10
CLI_STEPFIT_N = 256
# Config 5, fluor counting (bench.py::bench_v8): traces, cycles and the
# most fluors (C(17, 12) = 6,188 sequences), timed runs after one warm-up,
# traces held against the per-trace host oracle and against the CPU run;
# rows of the synthetic track CSV and traces of each control fit.
V8_T, V8_F, V8_K, V8_REPS, V8_ORACLE, V8_CPU = 100_000, 12, 5, 5, 150, 4096
V8_BETA, V8_BETA_SIGMA, V8_MAX_DEVIATION = 30000.0, 0.2, 3
FC_ROWS, FC_REPS, FC_CONTROL_ROWS = 20_000, 3, 5_000
# Traces per chunk of the plain twin and of the matmul form on the card:
# both build (chunk, 6188) float32 arrays.
V8_TWIN_CHUNK, V8_MATMUL_CHUNK = 4096, 8192
# Simulation, config 5's second half (bench.py::bench_simulation and
# bench_sim_fit: simulate_peptide.py's CLI defaults on the two-colour
# 18-mer): molecules, mock and Edman cycles, timed runs after one warm-up,
# molecules of the host event loop for the distribution gate and its TVD
# bound, molecules of the card-vs-CPU check and of the chained = two-step
# check, samples per peptide of the native sampler, molecules of the CLI.
SIM_SEQ = "ACKDYECAGKHSECAMKR"
SIM_N, SIM_MOCKS, SIM_EDMANS, SIM_REPS = 100_000, 3, 8, 3
SIM_PARAMS = dict(p=0.90, b=-math.log(1.0 - 0.1), u=0.50, s=0.30, sc=4,
                  s2=0.10)
SIM_BETA, SIM_BETA_SIGMA = 70000.0, 0.20
SIM_DDIF = [0.0, 0.30] + [0.30] * 5
SIM_HOST_SAMPLE, SIM_TVD = 3000, 0.05
SIM_CPU_N, SIM_FIT_TWO_STEP, SIM_SIGNALS, CLI_SIM_N = (20_000, 20_000,
                                                      100_000, 20_000)
# The Monte-Carlo detector on frame 0 of config 2: samples per candidate
# (pflib's default), the candidate bucket (the default call caps at 4096),
# the planted-spot distance reported; the card against the CPU on a crop.
MC_N_ITER, MC_K, MC_WITHIN_PX = 1000, 8192, 1.5
MC_CPU_HW, MC_CPU_K, MC_CPU_ITER = 256, 2048, 200
# The mixtures group: config 5's traces as per-cycle photometries
# (make_gmm_photometries) through the per-cycle mixture fit at the
# reference's defaults (MCsimlib.py:3307: 1-5 fluors, so k = 2-6 components,
# 10 restarts, 100 EM rounds), timed calls after one warm-up; kernel E
# against its twin after 3 rounds, model by model, at the CPU parity tests'
# tolerances (log-likelihood relative, means, weights, variances relative
# or of the second moment: the sums run in another order), and after
# n_iter rounds a restart may differ only where the twin's own
# log-likelihoods of the two tie within E_TIE_REL (unconverged float32 EM
# restarts end that close); the plateau fitter at config 5's CSV size; the
# card against the CPU on a small set.
GMM_T, GMM_F, GMM_KS, GMM_N_INIT, GMM_N_ITER, GMM_REPS = (
    100_000, 12, (2, 3, 4, 5, 6), 10, 100, 3)
E_LL_REL, E_MEAN_ABS, E_W_ABS, E_VAR_REL, E_VAR_OF_MOMENT = (
    1e-5, 1e-3, 1e-3, 1e-3, 1e-5)
E_TIE_REL = 1e-3
PL_T, PL_DROPS = 20_000, 3
MIX_SMALL_T, MIX_SMALL_F = 2_000, 6
# The reference's own mixture and cluster fits on the port's estimators
# (ops/mixture.py, ops/kmeans.py; phases reference_gmm and cluster_fit):
# _per_cycle_gmm_MP on the mixtures cell above; the cluster-fit sweep
# (_parameter_sweep_2 at its defaults) on the cell's first SWEEP_T traces
# as a 20-field integer track CSV; the card against the CPU on REF_SMALL_F
# cycles x REF_SMALL_T traces and on the sweep's first SWEEP_SMALL_T
# traces, floats within REF_RTOL.
SWEEP_T, SWEEP_SMALL_T = 20_000, 500
REF_SMALL_T, REF_SMALL_F = 2_000, 3
REF_RTOL = 1e-9
# Kernel E beyond its register form (phase gmm_limits): per_cycle_gmm at
# max_fluors=8 (k 2-9, K = 9: the shared-memory form) on config 5's
# photometries; the form's largest K (gmm::KMAX) on the same data, n_init
# restarts; one group of LIM_N points with LIM_KS x LIM_N_INIT models
# (more than BMAX: two launches) and LIM_N_ITER rounds; a call of the
# config-5 models run in slices of LIM_SLICE against one launch.
LIM_MAX_FLUORS, LIM_KMAX_N_INIT = 8, 2
LIM_N, LIM_KS, LIM_N_INIT, LIM_N_ITER, LIM_SLICE = 10_000, (2, 3), 2100, 20, 25
# Kernel E's work a point, model and pass, from _em_batched's arithmetic
# (an FMA counts 2): per active component the difference, its scaled
# square, the log-probability, the maximum, the shifted exponent, the sum,
# the responsibility and the three statistics (13); per model the
# log-sum-exp's add and the log-likelihood's sum (2). Special-function
# operations: one exp per active component and one log per model.
E_OPS_PER_COMPONENT, E_OPS_PER_MODEL = 13, 2
# Kernel D, per pixel and sample, from csrc/mc_fit.cuh (an FMA counts 2):
# the row and column squares amortised (0.8), a + b (1), the quotient (a
# multiply and two FMAs: 5), the exp (1), A * e + H (2), the maximum (1),
# the normalising quotient (5), the difference, its square and the sum (3).
D_OPS_PER_PIXEL = 19
# The parallel group: the sharded step on a mesh of PAR_SHARDS entries of
# one card; config 4's first PAR_F fields through a Pipeline over that
# device list and through multihost.run_experiment in PAR_PROCS processes
# (gloo, one card), each child given PAR_CHILD_TIMEOUT_S seconds.
PAR_SHARDS, PAR_F, PAR_PROCS, PAR_CHILD_TIMEOUT_S = 2, 8, 2, 300
# Samples a peptide of simulate_signals on a device list (host work).
PAR_SIM_SIGNALS = 20_000
# Photometry of the card against the CPU: float32 sums of ~2e4 in another
# order differ by a few ulp (2e-3 each), which a value near 0 cannot absorb
# relatively.
PHOT_RTOL, PHOT_ATOL = 1e-4, 5e-2
# RMSE of one fit on the card against the CPU: the two evaluate exp and the
# LM's sums by other routines, and their centers differ by ~1e-4 px. The
# residual of a clean spot (RMSE ~6 under an amplitude of ~3000) moves by
# 0.5% for that, so the difference is held against the spot's amplitude as
# well (B_RMSE_REL holds a kernel against its twin on one card).
CARD_CPU_RMSE_REL, CARD_CPU_RMSE_OF_AMPLITUDE = 1e-3, 1e-4

# Published peaks of one H100 SXM at its 700 W limit: float32 outside the
# tensor cores (an FMA counts 2) and HBM3 bandwidth.
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
# Special-function operations (exp2, log2, reciprocal): 16 a clock on each
# of the 132 SMs (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) at the 1.98 GHz behind 67 TFLOP/s.
PEAK_SFU_OPS = 132 * 16 * 1.98e9
# Operations each kernel's function needs, counted from its arithmetic.
# Kernel A, per pixel: the median (csrc/median25.cuh: 174 min/max),
# mf = x - min(med, x) (2), 25 taps (25 FMAs = 50) and the clamp (1).
A_OPS_PER_PIXEL = 174 + 2 + 50 + 1
# Kernel B, per fit and start: num_iters x (25 pixels x ~130 flops: ~110
# for the model, Jacobian, gradient and 28 normal-matrix entries, ~20 for
# the trial cost; plus ~250 for the damped 7x7 Cholesky solve).
B_FLOPS_PER_PIXEL_ITER, B_FLOPS_SOLVE = 130, 250

# The JAX package's experiment_step_sharded schema on a device (dims:
# F fields, C cycles, K candidates, S spot slots).
SCHEMA = {
    "offsets_h": ("FC", "float32"), "offsets_w": ("FC", "float32"),
    "params": ("FCK7", "float32"), "keep": ("FCK", "bool"),
    "center_h": ("FCK", "float32"), "center_w": ("FCK", "float32"),
    "cand_count": ("FC", "int32"), "spot_h": ("FCS", "float32"),
    "spot_w": ("FCS", "float32"), "spot_cand_idx": ("FCS", "int32"),
    "spot_valid": ("FCS", "bool"), "spot_rh": ("FCS", "int16"),
    "spot_rw": ("FCS", "int16"), "spot_state": ("FCS", "int8"),
    "spot_cand_c": ("FCS", "int16"), "spot_count": ("FC", "int32"),
    "spot_overflow": ("FC", "bool"), "photometry": ("FCS", "float32"),
    "photometry_interior": ("FCS", "bool"),
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError("check failed: " + what)


def time_ms(fn, reps):
    """Per-run device times (ms) of ``fn`` with CUDA events, each run
    bracketed by synchronisation, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def host_ms(fn, reps):
    """Median host-clock time (ms) of ``fn`` with the device synchronised
    before and after each run, after one warm-up run."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def profile_steps(run, steps):
    """Device activity of ``steps`` calls of ``run`` under torch.profiler:
    the busy share of the host-clock window (merged device intervals), the
    device operations (kernels, copies, memsets) per step, and the largest
    ones by total device time."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t) * 1e6
    spans, by_name = [], collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name[:80]] += e.time_range.elapsed_us()
    check(spans, "the profiler saw device activity")
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return {"steps": steps, "window_us": window_us, "device_busy_us": busy,
            "device_busy_share": busy / window_us,
            "device_ops_per_step": len(spans) / steps,
            "top_device_us": [[n, us] for n, us in by_name.most_common(12)]}


def bound(nbytes, ops):
    """The least time (ms) the card could take: bytes over the memory rate
    or operations over the float32 rate, whichever is longer, and which."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_b_report(imgs, hs, ws, valid, num_iters, ts, reps, plain_reps):
    """Kernel B against its twin on (B, K) candidates of ``imgs``: the
    parameters bit for bit and the other outputs within their tolerances
    (raises otherwise), then both timed. Returns the statistics."""
    from fluorosequencingimageanalysis_torch.ops.candidates import (
        gather_patches)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality, fit_quality_plain)
    from fluorosequencingimageanalysis_torch.ops.gaussian import (
        gauss2d_image)

    patch_max = gather_patches(imgs, hs, ws).abs().amax(dim=(-2, -1))
    got = fit_quality(imgs, hs, ws, num_iters, ts)
    ref = fit_quality_plain(imgs, hs, ws, num_iters, ts)
    torch.cuda.synchronize()
    m = valid & (ref[4] >= 0.7)
    dc = torch.maximum((got[1] - ref[1]).abs(), (got[2] - ref[2]).abs())
    dr2 = (got[4] - ref[4]).abs()
    drm = (got[3] - ref[3]).abs() / ref[3].abs()
    dm = (gauss2d_image(got[0][m].double(), dtype=torch.float64) -
          gauss2d_image(ref[0][m].double(), dtype=torch.float64)
          ).abs().amax(dim=(-2, -1))
    rel_m = dm / patch_max[m].double()
    stats = {"fits": int(hs.numel()), "compared": int(m.sum()),
             "params_bitwise_equal": float(
                 (got[0] == ref[0]).all(dim=-1).float().mean()),
             "max_center_err": float(dc[m].max()),
             "max_r2_err": float(dr2[m].max()),
             "max_rmse_err_rel": float(drm[m].max()),
             "max_model_err_rel": float(rel_m.max()),
             # Over params, centers, RMSE, R^2 and S/N of those fits.
             "max_abs_err_all_outputs": max(
                 float((g[m] - r[m]).abs().max()) for g, r in
                 zip(got, ref)),
             "over_center_tol": int((dc[m] > B_CENTER).sum()),
             "over_r2_tol": int((dr2[m] > B_R2).sum()),
             "over_rmse_tol": int((drm[m] > B_RMSE_REL).sum()),
             "over_model_tol": int((rel_m > B_MODEL).sum())}
    check(stats["params_bitwise_equal"] == 1.0 and
          stats["over_center_tol"] == 0 and stats["over_r2_tol"] == 0
          and stats["over_rmse_tol"] == 0 and stats["over_model_tol"] == 0,
          f"kernel B vs twin at {tuple(hs.shape)}, theta_starts={ts}, "
          f"{num_iters} iterations: {stats}")
    del got, ref
    ms = time_ms(lambda: fit_quality(imgs, hs, ws, num_iters, ts), reps)
    plain = time_ms(lambda: fit_quality_plain(imgs, hs, ws, num_iters, ts),
                    plain_reps)
    # Per fit: its 25 pixels and 2 coordinates in, 12 floats out.
    fits = hs.numel()
    b_bound, b_by = bound(
        fits * (25 * 4 + 2 * 4 + 12 * 4),
        fits * min(ts, 2) * num_iters *
        (25 * B_FLOPS_PER_PIXEL_ITER + B_FLOPS_SOLVE))
    b_med = statistics.median(ms)
    return dict(stats, ms_median=b_med,
                plain_ms_median=statistics.median(plain), bound_ms=b_bound,
                bound_by=b_by, share_of_bound=b_bound / b_med, ms_runs=ms,
                plain_ms_runs=plain)


def nvidia_smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, "nvidia-smi ran: " + proc.stderr)
    return proc.stdout.strip().splitlines()[0]


def run_cli(argv):
    """One subcommand in a process of its own: (its JSON line, seconds)."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fluorosequencingimageanalysis_torch", *argv],
        capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"the {argv[0]} subcommand exits 0: " +
          proc.stderr[-2000:])
    return (json.loads(proc.stdout.strip().splitlines()[-1]),
            time.perf_counter() - t)


def planted(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(400, 10, (h, w)).astype(np.float32)
    hh, ww = np.indices((h, w)).astype(np.float32)
    img += 3000 * np.exp(-(((hh - h // 2) ** 2) + ((ww - w // 2) ** 2)) / 3.0)
    return img


def experiment_phase(tmpl, dev, profile_host=False):
    """Config 4 through ``Pipeline(device="cuda").run_experiment``: one
    warm-up and EXP_REPS timed runs (launch counts set to 0 before each
    and read after), the CSVs, the recovery of planted spots, both kernels
    against their twins at this path's shapes, the device time of one
    group's step and its stages, and the card against the CPU on a
    reduced stack. Emits the "experiment" line (and, with
    ``profile_host``, the "experiment_host_profile" line and the
    device's busy share over one run); returns the
    kernels' launches per run, their numbers at this path's shapes and the
    text of the track CSV."""
    from fluorosequencingimageanalysis_torch.api import (GROUP_FIELDS,
                                                         Pipeline)
    from fluorosequencingimageanalysis_torch.ops.candidates import (
        _threshold_and_extract_batch)
    from fluorosequencingimageanalysis_torch.ops.consolidate import (
        consolidate)
    from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
        candidate_map_fused, candidate_map_plain)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality)
    from fluorosequencingimageanalysis_torch.ops.photometry import (
        mexican_hat_batch)
    from fluorosequencingimageanalysis_torch.ops.registration import (
        phase_correlate_stack)
    from fluorosequencingimageanalysis_torch.parallel.mesh import (
        experiment_step)
    from fluorosequencingimageanalysis_torch.pipeline.fast_experiment import (
        gather_windows, photometry_ops)
    from fluorosequencingimageanalysis_torch.utils import profiling
    from fluorosequencingimageanalysis_torch.utils.synth import (
        experiment_recovery, make_experiment_stack)

    t = time.perf_counter()
    stack, pos, present, drift = make_experiment_stack(EXP_F, EXP_C,
                                                       return_truth=True)
    stack = np.clip(stack, 0, 65535).astype(np.uint16)
    synth_s = time.perf_counter() - t
    H, W = stack.shape[2:]
    pipe = Pipeline(device=dev, profile=True)
    kw = dict(max_candidates=EXP_K, max_spots=EXP_S)
    n_iters = pipe.config.detect.num_iters
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        paths = dict(csv_path=os.path.join(tmp, "tracks.csv"),
                     category_csv_path=os.path.join(tmp, "categories.csv"))
        t = time.perf_counter()
        pipe.run_experiment(stack, **paths, **kw)
        warm_s = time.perf_counter() - t
        for _ in range(EXP_REPS):
            profiling.reset_timings()
            profiling.reset_counters()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            candidate_map_fused.launches = 0
            fit_quality.launches = 0
            consolidate.launches = 0
            t = time.perf_counter()
            res = pipe.run_experiment(stack, **paths, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = {"candidate_map": candidate_map_fused.launches,
                        "fit_quality": fit_quality.launches,
                        "consolidate": consolidate.launches}
            st = {k: v["total"] for k, v in profiling.timings().items()}
            runs.append({
                "wall_s": wall, "launches": launches,
                "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
                "stages_s": st, "counters": profiling.counters(),
                "overlap_s": (st["api/run_stack"] +
                              st["api/run_experiment/track+photometry"] -
                              st["api/run_experiment/groups"])})
        n_groups = -(-EXP_F // GROUP_FIELDS)
        for r in runs:
            check(r["launches"] == {"candidate_map": n_groups,
                                    "fit_quality": n_groups,
                                    "consolidate": n_groups},
                  f"each group's step launched kernels A, B and F once: "
                  f"{r['launches']}")
        rows = res["rows"]
        check(len(rows) > 0, "run_experiment returned rows")
        check(all(np.isfinite(np.asarray(r[5], np.float64)).all()
                  for r in rows), "every row's photometry is finite")
        with open(paths["csv_path"], newline="") as fh:
            track_csv = fh.read()
        table = list(csv.reader(track_csv.splitlines()))
        check(table[0] == ["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
              [f"FRAME {i}" for i in range(EXP_C)] and
              len(table) == len(rows) + 1 and
              all(len(t) == 5 + EXP_C for t in table[1:]),
              "the track CSV parses with the track-rows header")
        with open(paths["category_csv_path"], newline="") as fh:
            cats = list(csv.reader(fh))
        check(cats[0] == ["Pattern", "Channel", "Count"] and
              sum(int(c[2]) for c in cats[1:]) ==
              sum(n for by_f in res["filtered_category_counts"].values()
                  for d in by_f.values() for n in d.values()),
              "the category CSV parses and sums to the filtered counts")

    # Planted spots: those the step keeps in every cycle must come back
    # as all-ones rows (tracking and fill-in); the raw recovery of every
    # spot planted in every cycle is reported beside it.
    step_out = pipe.run_stack(stack, keys=("spot_rh", "spot_rw",
                                           "spot_state", "cand_count"),
                              photometry_min=None, **kw)
    rec = experiment_recovery(rows, step_out, pos, present, drift)
    check(rec["recovered_of_detected"] >= 0.90,
          f"spots kept in every cycle come back as all-ones rows: {rec}")

    # Both kernels against their twins at one group's shapes, and the
    # device time of that group's step and of its stages.
    g0 = torch.from_numpy(stack[:GROUP_FIELDS]).to(dev)
    imgs = g0.reshape(-1, H, W).to(torch.float32)
    a_shape = list(imgs.shape)
    cm = candidate_map_fused(imgs, tmpl)
    err_a = float((cm - candidate_map_plain(imgs, tmpl)).abs().max())
    check(err_a == 0.0, f"kernel A vs twin at {tuple(imgs.shape)} "
                        f"(max abs err {err_a})")
    a_ms = time_ms(lambda: candidate_map_fused(imgs, tmpl), 10)
    a_plain = time_ms(lambda: candidate_map_plain(imgs, tmpl), 3)
    a_bound, a_by = bound(2 * imgs.numel() * 4,
                          imgs.numel() * A_OPS_PER_PIXEL)
    hs, ws, valid, _ = _threshold_and_extract_batch(cm, EXP_K, 2.0)
    b = kernel_b_report(imgs, hs, ws, valid, n_iters, 1, reps=5,
                        plain_reps=2)
    step_kw = pipe._step_kwargs(EXP_K, photometry_min=None)
    fq = fit_quality(imgs, hs, ws, n_iters, 1)
    passed = valid & ~(fq[4] < 0.7)
    # A group's share of the run's interpolated holes.
    holes = max(1, sum(not p for r in rows for p in r[4]) // n_groups)
    rng = np.random.default_rng(0)
    hole_idx = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, imgs.shape[0], holes),
        rng.integers(9, H - 9, holes), rng.integers(9, W - 9, holes))]
    reduce = photometry_ops.patch_reduction("mexican_hat", 9)
    with torch.no_grad():
        group_ms = {
            "step_best": 1e3 * profiling.device_time(
                experiment_step, g0, max_spots=EXP_S, iters=3,
                **step_kw)[0],
            "registration": statistics.median(time_ms(
                lambda: phase_correlate_stack(g0.to(torch.float32), 20), 3)),
            "candidate_map_kernel": statistics.median(a_ms),
            "extraction": statistics.median(time_ms(
                lambda: _threshold_and_extract_batch(cm, EXP_K, 2.0), 3)),
            "fit_quality_kernel": b["ms_median"],
            "consolidate": statistics.median(time_ms(
                lambda: consolidate(fq[1], fq[2], fq[4], passed, 4.0), 3)),
            "mexican_hat_photometry": statistics.median(time_ms(
                lambda: mexican_hat_batch(imgs, hs[:, :EXP_S].clamp(9, H - 10),
                                          ws[:, :EXP_S].clamp(9, W - 10)),
                3)),
            f"hole_gather_{holes}": statistics.median(time_ms(
                lambda: reduce(gather_windows(g0.reshape(-1, H, W),
                                              *hole_idx, 9)), 3)),
        }
    del fq, passed, g0, imgs, cm

    # The card against the CPU on a reduced stack.
    small = np.clip(make_experiment_stack(**EXP_SMALL), 0,
                    65535).astype(np.uint16)
    on_card = Pipeline(device=dev).run_experiment(
        small, max_candidates=EXP_SMALL_K)
    t = time.perf_counter()
    on_cpu = Pipeline(device="cpu").run_experiment(
        small, max_candidates=EXP_SMALL_K)
    cpu_s = time.perf_counter() - t
    check(len(on_card["rows"]) == len(on_cpu["rows"]) > 0,
          f"rows on the card and the CPU: {len(on_card['rows'])}, "
          f"{len(on_cpu['rows'])}")
    worst = 0.0
    for i, (g, c) in enumerate(zip(on_card["rows"], on_cpu["rows"])):
        check(g[:5] == c[:5], f"row {i}: card {g[:5]}, CPU {c[:5]}")
        gv, cv = np.asarray(g[5]), np.asarray(c[5])
        check(np.allclose(gv, cv, rtol=PHOT_RTOL, atol=PHOT_ATOL),
              f"row {i} photometry: card {gv}, CPU {cv}")
        worst = max(worst, float(np.max(np.abs(gv - cv))))
    check(on_card["category_counts"] == on_cpu["category_counts"],
          "category counts equal on the card and the CPU")

    walls = [r["wall_s"] for r in runs]
    emit("experiment", shape=list(stack.shape), dtype=str(stack.dtype),
         max_candidates=EXP_K, max_spots=EXP_S, num_iters=n_iters,
         group_fields=GROUP_FIELDS, synth_s=synth_s, warmup_s=warm_s,
         fields_per_s=EXP_F / statistics.median(walls),
         wall_s_median=statistics.median(walls), runs=runs,
         rows=len(rows), traces=res["summary"]["ch1"]["trace_count"],
         summary=res["summary"]["ch1"],
         cand_count_mean=float(step_out["cand_count"].mean()),
         cand_overflow_images=int((step_out["cand_count"] > EXP_K).sum()),
         recovery_1px=rec, group_device_ms=group_ms,
         card_vs_cpu={"shape": [EXP_SMALL[k] for k in ("F", "C", "H", "W")],
                      "max_candidates": EXP_SMALL_K,
                      "rows": len(on_cpu["rows"]),
                      "max_abs_phot_diff": worst, "cpu_s": cpu_s},
         note="wall = run_experiment from a host uint16 stack to rows and "
              "both CSVs; stages_s are host-clock stage totals; overlap_s "
              "= run_stack + track+photometry - groups; group_device_ms "
              "are device times of one group of GROUP_FIELDS fields "
              "(step_best: best of 3, the others medians of 3)")
    if profile_host:
        host_profile(pipe, stack, kw)
        prof = profile_steps(lambda: pipe.run_experiment(stack, **kw), 1)
        prof["device_busy_share_of_unprofiled_run"] = (
            prof["device_busy_us"] / 1e6 / statistics.median(walls))
        emit("experiment_profile", **prof)
    return {
        "launches": runs[0]["launches"], "track_csv": track_csv,
        "stack": stack,
        "kernels": {
            "candidate_map": {
                "shape": a_shape,
                "max_abs_err": err_a, "ms": statistics.median(a_ms),
                "plain_ms": statistics.median(a_plain), "bound_ms": a_bound,
                "bound_by": a_by,
                "share_of_bound": a_bound / statistics.median(a_ms)},
            "fit_quality": {
                "fits": b["fits"], "num_iters": n_iters,
                "max_abs_err": b["max_abs_err_all_outputs"],
                "ms": b["ms_median"], "plain_ms": b["plain_ms_median"],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "share_of_bound": b["share_of_bound"]}}}


def objects_phases(tmpl, dev, stack=None):
    """The object layer's class path (tools/class_path.py: detection
    through kernels A and B, registration, tracking, the batched
    photometry, the track CSV) on config 4's first OBJ_F fields with the
    card as the process default device: one warm-up field, then one timed
    run (launch counts set to 0 just before it and read just after). Gate
    1: its rows equal ``run_experiment``'s on the same fields. Gate 2: the
    card equals the CPU on the first OBJ_CPU_F fields. Both kernels against
    their twins at this path's shapes (one field's cycles). Emits the
    "objects" and "objects_card_vs_cpu" lines; returns the
    kernels' launches and numbers. ``stack``: the experiment group's
    config-4 stack, else made here."""
    from fluorosequencingimageanalysis_torch import _device
    from fluorosequencingimageanalysis_torch.api import Pipeline
    from fluorosequencingimageanalysis_torch.ops.candidates import (
        _threshold_and_extract_batch)
    from fluorosequencingimageanalysis_torch.ops.consolidate import (
        consolidate)
    from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
        candidate_map_fused, candidate_map_plain)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality)
    from fluorosequencingimageanalysis_torch.tools.class_path import (
        class_path, read_rows)
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_experiment_stack)

    synth_s = 0.0
    if stack is None:
        t = time.perf_counter()
        stack = np.clip(make_experiment_stack(EXP_F, EXP_C), 0,
                        65535).astype(np.uint16)
        synth_s = time.perf_counter() - t
    stack = np.ascontiguousarray(stack[:OBJ_F])
    F, C, H, W = stack.shape
    n_iters = Pipeline(device=dev).config.detect.num_iters
    _device.set_default_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        class_path(stack[:1], os.path.join(tmp, "warm.csv"),
                   max_candidates=EXP_K)
        warm_s = time.perf_counter() - t
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        candidate_map_fused.launches = 0
        fit_quality.launches = 0
        consolidate.launches = 0
        t = time.perf_counter()
        mfmc, stages = class_path(stack, os.path.join(tmp, "card.csv"),
                                  max_candidates=EXP_K,
                                  sync=torch.cuda.synchronize)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {"candidate_map": candidate_map_fused.launches,
                    "fit_quality": fit_quality.launches,
                    "consolidate": consolidate.launches}
        peak = int(torch.cuda.max_memory_allocated())
        check(launches == {"candidate_map": F, "fit_quality": F,
                           "consolidate": F},
              f"each field's detection launched kernels A, B and F once: "
              f"{launches}")
        header, rows = read_rows(os.path.join(tmp, "card.csv"))
        check(header == ["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
              [f"FRAME {i}" for i in range(C)] and len(rows) > 0 and
              all(len(r) == 5 + C for r in rows),
              "the class path's track CSV parses with its header")
        values = np.array([[float(x) for x in r[5:]] for r in rows])
        check(np.isfinite(values).all(), "every class-path photometry is "
                                         "finite")
        check(len({r[4] for r in rows}) > 2, "the rows hold more than two "
                                             "categories")

        # Gate 1: run_experiment on the same fields (one warm-up run).
        pipe = Pipeline(device=dev)
        kw = dict(max_candidates=EXP_K, max_spots=EXP_S)
        pipe.run_experiment(stack, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = pipe.run_experiment(stack, **kw)
        torch.cuda.synchronize()
        exp_wall = time.perf_counter() - t
        fast = res["rows"]
        check(len(fast) == len(rows), f"rows of the class path and "
              f"run_experiment: {len(rows)}, {len(fast)}")
        worst = 0.0
        for i, ((ch, f, h, w, cat, ph), row) in enumerate(zip(fast, rows)):
            check([str(ch), str(f), str(h), str(w), str(cat)] == row[:5],
                  f"row {i}: run_experiment {(ch, f, h, w, cat)}, class "
                  f"path {row[:5]}")
            ph = np.asarray(ph, np.float64)
            check(np.allclose(ph, values[i], rtol=CLASS_RTOL,
                              atol=CLASS_ATOL),
                  f"row {i} photometry: run_experiment {ph}, class path "
                  f"{values[i]}")
            worst = max(worst, float(np.abs(ph - values[i]).max()))

        # Both kernels against their twins at this path's shapes.
        imgs = torch.from_numpy(stack[0]).to(dev).to(torch.float32)
        cm = candidate_map_fused(imgs, tmpl)
        err_a = float((cm - candidate_map_plain(imgs, tmpl)).abs().max())
        check(err_a == 0.0, f"kernel A vs twin at {tuple(imgs.shape)} "
                            f"(max abs err {err_a})")
        a_ms = time_ms(lambda: candidate_map_fused(imgs, tmpl), 10)
        a_plain = time_ms(lambda: candidate_map_plain(imgs, tmpl), 3)
        a_bound, a_by = bound(2 * imgs.numel() * 4,
                              imgs.numel() * A_OPS_PER_PIXEL)
        hs, ws, valid, _ = _threshold_and_extract_batch(cm, EXP_K, 2.0)
        b = kernel_b_report(imgs, hs, ws, valid, n_iters, 1, reps=5,
                            plain_reps=2)
        del cm, imgs

        # Gate 2: the card against the CPU on the first OBJ_CPU_F fields.
        part = stack[:OBJ_CPU_F]
        class_path(part, os.path.join(tmp, "card1.csv"),
                   max_candidates=EXP_K)
        _device.set_default_device("cpu")
        t = time.perf_counter()
        _, cpu_stages = class_path(part, os.path.join(tmp, "cpu1.csv"),
                                   max_candidates=EXP_K)
        cpu_s = time.perf_counter() - t
        _device.set_default_device(dev)
        card1 = read_rows(os.path.join(tmp, "card1.csv"))[1]
        cpu1 = read_rows(os.path.join(tmp, "cpu1.csv"))[1]
        check(len(card1) == len(cpu1) > 0, f"class-path rows on the card "
              f"and the CPU: {len(card1)}, {len(cpu1)}")
        worst_cpu = 0.0
        for i, (g, c) in enumerate(zip(card1, cpu1)):
            check(g[:5] == c[:5], f"row {i}: card {g[:5]}, CPU {c[:5]}")
            gv = np.array([float(x) for x in g[5:]])
            cv = np.array([float(x) for x in c[5:]])
            check(np.allclose(gv, cv, rtol=PHOT_RTOL, atol=PHOT_ATOL),
                  f"row {i} photometry: card {gv}, CPU {cv}")
            worst_cpu = max(worst_cpu, float(np.abs(gv - cv).max()))
    emit("objects", shape=[F, C, H, W], dtype=str(stack.dtype),
         max_candidates=EXP_K, num_iters=n_iters, cut="config 4's 32 "
         f"fields cut to the first {F}", synth_s=synth_s, warmup_s=warm_s,
         wall_s=wall, wall_per_field_s=wall / F, stages_s=stages,
         unnamed_s=wall - sum(v for k, v in stages.items()
                              if k != "photometry"),
         peak_mem_bytes=peak, launches=launches, rows=len(rows),
         spot_count=mfmc.spot_count()["ch1"],
         trace_count=mfmc.trace_count()["ch1"],
         run_experiment_wall_s=exp_wall,
         run_experiment_wall_per_field_s=exp_wall / F,
         max_abs_phot_diff_vs_run_experiment=worst,
         note="wall = the class path from a host uint16 stack to its "
              "track CSV (one timed run after a one-field warm-up); "
              "stages_s are host-clock stage totals, the device "
              "synchronised at each stage's end; photometry is the part "
              "of discard and csv inside Image's batched photometry; "
              "run_experiment's wall is one run after one warm-up")
    emit("objects_card_vs_cpu", shape=list(part.shape),
         rows=len(cpu1), max_abs_phot_diff=worst_cpu, cpu_s=cpu_s,
         cpu_stages_s=cpu_stages, cpu_threads=torch.get_num_threads())
    _device.set_default_device(None)
    return {
        "launches": {"objects": launches},
        "kernels": {
            "candidate_map": {"objects": {
                "shape": [C, H, W], "max_abs_err": err_a,
                "ms": statistics.median(a_ms),
                "plain_ms": statistics.median(a_plain), "bound_ms": a_bound,
                "bound_by": a_by,
                "share_of_bound": a_bound / statistics.median(a_ms)}},
            "fit_quality": {"objects": {
                "fits": b["fits"], "num_iters": n_iters,
                "max_abs_err": b["max_abs_err_all_outputs"],
                "ms": b["ms_median"], "plain_ms": b["plain_ms_median"],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "share_of_bound": b["share_of_bound"]}}}}


def objects_apps(dev):
    """compat.basic_image_script and compat.basic_experiment_script on
    planted 512x512 tif files written by Pillow (one directory a cycle, one
    file a field), with ``--device`` naming the card; the experiment script
    reuses the image script's psfs pickles, as the reference's flow does.
    The apps read the files with the port's own decoder. Needs Pillow (the
    apps write their PNGs with it): where it is missing the "objects_apps"
    line says so and nothing runs. Returns the launches of kernels A and B
    in the two apps."""
    import contextlib
    import glob
    import importlib.util
    import io
    import pickle
    if importlib.util.find_spec("PIL") is None:
        emit("objects_apps", ran=False, missing=["PIL"],
             note="the compat apps write their PNGs with Pillow, which "
                  "this machine lacks")
        return {}
    from PIL import Image as PILImage

    from fluorosequencingimageanalysis_torch.compat import (
        basic_experiment_script, basic_image_script)
    from fluorosequencingimageanalysis_torch.ops.consolidate import (
        consolidate)
    from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
        candidate_map_fused)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality)
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_experiment_stack)

    stack = np.clip(make_experiment_stack(
        OBJ_APP_FIELDS, OBJ_APP_CYCLES, OBJ_APP_HW, OBJ_APP_HW,
        spots_per_field=OBJ_APP_SPOTS, seed=3), 0, 65535).astype(np.uint16)
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for c in range(OBJ_APP_CYCLES):
            d = os.path.join(tmp, "images", f"cycle_{c:02d}")
            os.makedirs(d)
            for f in range(OBJ_APP_FIELDS):
                path = os.path.join(d, f"field_{f:02d}.tif")
                PILImage.fromarray(stack[f, c]).save(path)
                files.append(path)
        out = os.path.join(tmp, "out")
        printed = io.StringIO()
        candidate_map_fused.launches = 0
        fit_quality.launches = 0
        consolidate.launches = 0
        with contextlib.redirect_stdout(printed):
            t = time.perf_counter()
            processed = basic_image_script.main(
                ["--device", str(dev), "-L",
                 os.path.join(tmp, "i.log"), os.path.join(tmp, "images")])
            image_s = time.perf_counter() - t
            t = time.perf_counter()
            mfmc = basic_experiment_script.main(
                ["--peptide_files", *files, "--output_directory", out,
                 "--no_sanity_check_images", "--device", str(dev),
                 "-L", os.path.join(tmp, "e.log")])
            exp_s = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = {"candidate_map": candidate_map_fused.launches,
                    "fit_quality": fit_quality.launches,
                    "consolidate": consolidate.launches}
        check(len(processed) == len(files), f"the image script processed "
              f"{len(processed)} of {len(files)} images")
        check(launches["candidate_map"] >= 1 and
              launches["fit_quality"] >= 1,
              f"both kernels launched under the compat apps: {launches}")
        for path in files:
            check(all(len(glob.glob(path + f"*_psfs_*.{ext}")) == 1
                      for ext in ("pkl", "csv", "png")),
                  f"psfs pkl, csv and png beside {path}")
        with open(glob.glob(files[0] + "*_psfs_*.pkl")[0], "rb") as fh:
            psfs = pickle.load(fh)
        check(len(psfs) > 0.8 * OBJ_APP_SPOTS and
              all(len(v) == 12 for v in psfs.values()),
              f"the image script's psfs of {files[0]}: {len(psfs)} spots")
        (track,) = glob.glob(os.path.join(
            out, "track_photometries_NO_NONES_*.csv"))
        with open(track, newline="") as fh:
            table = list(csv.reader(fh))
        check(len(table) > 1 and len(table[0]) == 5 + OBJ_APP_CYCLES,
              f"the experiment script's track CSV: {len(table)} lines")
        (offsets,) = glob.glob(os.path.join(out, "offsets_dict_*.pkl"))
        with open(offsets, "rb") as fh:
            by_frame = pickle.load(fh)
        check(sorted(by_frame) == list(range(OBJ_APP_CYCLES)),
              "the offsets dict holds every cycle")
        check(glob.glob(os.path.join(out, "category_counts_*.csv")),
              "the experiment script wrote its category counts")
    emit("objects_apps", ran=True, reader="port", writer="Pillow",
         images=len(files), processed=len(processed),
         shape=[OBJ_APP_FIELDS, OBJ_APP_CYCLES, OBJ_APP_HW, OBJ_APP_HW],
         spots_per_field=OBJ_APP_SPOTS, image_script_s=image_s,
         experiment_script_s=exp_s, psfs_image0=len(psfs),
         track_rows=len(table) - 1, launches=launches,
         trace_count=mfmc.trace_count()["ch1"],
         printed_lines=len(printed.getvalue().splitlines()))
    return launches


def in_process_cli(argv):
    """One subcommand through ``__main__.main`` in this process: (its JSON
    line, seconds, launches of kernels A, B and F), the counts set to 0
    just before it and read just after."""
    import contextlib
    import io

    from fluorosequencingimageanalysis_torch.__main__ import main as cli
    from fluorosequencingimageanalysis_torch.ops.consolidate import (
        consolidate)
    from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
        candidate_map_fused)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality)

    printed = io.StringIO()
    torch.cuda.synchronize()
    candidate_map_fused.launches = 0
    fit_quality.launches = 0
    consolidate.launches = 0
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {"candidate_map": candidate_map_fused.launches,
                "fit_quality": fit_quality.launches,
                "consolidate": consolidate.launches}
    check(rc == 0, f"the {argv[0]} subcommand returns 0 in process")
    return (json.loads(printed.getvalue().strip().splitlines()[-1]),
            seconds, launches)


def files_phases(tmpl, dev, stack4=None):
    """The file front doors on the card, nothing patched: every image is
    read by the port's own decoders (utils/imageio.py). Inputs are written
    by the port's TIFF/PNG writers, or by Pillow where the line says so.
    Each subcommand runs in this process (launch counts set to 0 just
    before it and read just after); run-experiment and timetrace from the
    TIFF also in a process of their own (the wall a user sees, start-up
    included). Each output is held against the API's on the array. Kernels A and B against their twins on the first group of
    the config-4 stack as read from its files. Emits "files_readers",
    "files_decoders", "files_experiment", "files_zstack",
    "files_timetrace", "files_detect", "objects_apps" and
    "files_timetrace_script"; returns the launches and kernel numbers.
    ``stack4``: the experiment group's config-4 stack, else made here."""
    import importlib.util
    import pickle

    from fluorosequencingimageanalysis_torch import _device
    from fluorosequencingimageanalysis_torch import __main__ as cli_module
    from fluorosequencingimageanalysis_torch.api import (GROUP_FIELDS,
                                                         GROUP_FRAMES,
                                                         Pipeline)
    from fluorosequencingimageanalysis_torch.compat import (
        basic_timetrace_script)
    from fluorosequencingimageanalysis_torch.config import (DetectConfig,
                                                            PipelineConfig)
    from fluorosequencingimageanalysis_torch.models.detect import (
        find_peptides)
    from fluorosequencingimageanalysis_torch.ops.candidates import (
        _threshold_and_extract_batch)
    from fluorosequencingimageanalysis_torch.ops.consolidate import (
        consolidate)
    from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
        candidate_map_fused, candidate_map_plain)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality)
    from fluorosequencingimageanalysis_torch.utils import (
        imageio as port_io)
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_experiment_stack, make_movie, make_zstack)

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("imageio", "PIL")}
    emit("files_readers", imageio_importable=have["imageio"],
         pil_importable=have["PIL"], reader="port",
         decoder="fluorosequencingimageanalysis_torch/utils/imageio.py")
    warm = stack4 is not None  # the experiment group ran run_experiment
    if stack4 is None:
        stack4 = np.clip(make_experiment_stack(EXP_F, EXP_C), 0,
                         65535).astype(np.uint16)
    F_, C_, H, W = stack4.shape
    launches = {}

    def read_back(path, want, read, what=None, reps=FILES_READ_REPS):
        """The median ms of ``reps`` reads of ``path``; the array read
        must be ``want`` bit for bit, with its dtype and shape."""
        ms = []
        for _ in range(reps):
            t = time.perf_counter()
            got = read(path)
            ms.append((time.perf_counter() - t) * 1e3)
        check(got.dtype == want.dtype and got.shape == want.shape and
              np.array_equal(got, want),
              f"{what or os.path.basename(path)} reads back bit for bit "
              f"({got.dtype} {got.shape})")
        return statistics.median(ms)

    with tempfile.TemporaryDirectory() as tmp:
        # The decoder matrix: one config-4 field in each form.
        field = stack4[0, 0]
        forms = {"tiff_uncompressed": {}, "tiff_packbits":
                 {"compression": "packbits"},
                 "tiff_deflate": {"compression": "deflate"},
                 "tiff_lzw": {"compression": "lzw"},
                 "tiff_deflate_predictor": {"compression": "deflate",
                                            "predictor": True},
                 "tiff_lzw_predictor": {"compression": "lzw",
                                        "predictor": True},
                 "tiff_big_endian": {"byteorder": ">"},
                 "tiff_tiled": {"tile": (128, 128)}}
        decoders = {}
        for name, kw in forms.items():
            path = os.path.join(tmp, name + ".tif")
            port_io.write_tiff(path, field, **kw)
            decoders[name] = {"bytes": os.path.getsize(path), "read_ms":
                              read_back(path, field,
                                        port_io.read_image_array)}
        path = os.path.join(tmp, "png_16bit.png")
        port_io.write_png(path, field)
        decoders["png_16bit"] = {"bytes": os.path.getsize(path), "read_ms":
                                 read_back(path, field,
                                           port_io.read_image_array)}
        if have["PIL"]:
            from PIL import Image as PILImage
            path = os.path.join(tmp, "png_16bit_pillow.png")
            PILImage.fromarray(field).save(path)
            decoders["png_16bit_pillow_filtered"] = {
                "bytes": os.path.getsize(path),
                "read_ms": read_back(path, field, port_io.read_image_array)}
        emit("files_decoders", shape=[H, W], dtype=str(field.dtype),
             reads=FILES_READ_REPS, formats=decoders,
             note="read_ms: median wall of read_image_array on the host, "
                  "file in the page cache; every form bit-equal")

        # Config 4 from 256 files: run-experiment against run_experiment
        # on the array.
        files = []
        t = time.perf_counter()
        for c in range(C_):
            d = os.path.join(tmp, "config4", f"cycle_{c:02d}")
            os.makedirs(d)
            for f in range(F_):
                files.append(os.path.join(d, f"field_{f:02d}.tif"))
                port_io.write_tiff(files[-1], stack4[f, c])
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded, _ = cli_module._load_stack(files)
        read_s = time.perf_counter() - t
        check(loaded.dtype == np.uint16 and np.array_equal(loaded, stack4),
              "_load_stack returns the config-4 stack from its files")
        pipe = Pipeline(device=dev)
        kw = dict(max_candidates=EXP_K, max_spots=EXP_S)
        mem = {k: os.path.join(tmp, f"mem_{k}.csv")
               for k in ("tracks", "categories")}
        if not warm:
            pipe.run_experiment(stack4, **kw)
            torch.cuda.synchronize()
        t = time.perf_counter()
        pipe.run_experiment(stack4, csv_path=mem["tracks"],
                            category_csv_path=mem["categories"], **kw)
        torch.cuda.synchronize()
        mem_s = time.perf_counter() - t
        argv = ["run-experiment", "--peptide-files", *files,
                "--max-candidates", str(EXP_K), "--max-spots", str(EXP_S),
                "--device", str(dev)]
        summary, in_s, exp_launches = in_process_cli(
            argv + ["--output-dir", os.path.join(tmp, "exp_in")])
        n_groups = -(-F_ // GROUP_FIELDS)
        check(exp_launches == {"candidate_map": n_groups,
                               "fit_quality": n_groups,
                               "consolidate": n_groups},
              f"run-experiment from files launched kernels A, B and F once "
              f"a group: {exp_launches}")
        sub, cli_s = run_cli(argv + ["--output-dir",
                                     os.path.join(tmp, "exp_cli")])
        for what, out in (("in process", summary), ("own process", sub)):
            for key, ref in (("csv", "tracks"),
                             ("category_csv", "categories")):
                with open(out[key], "rb") as a, open(mem[ref], "rb") as b:
                    check(a.read() == b.read(),
                          f"run-experiment's {key} ({what}) is byte for "
                          f"byte run_experiment's on the array")
        launches["files_run_experiment"] = exp_launches
        emit("files_experiment", files=len(files), shape=[F_, C_, H, W],
             dtype="uint16", file_form="uncompressed TIFF, one strip",
             bytes_per_file=os.path.getsize(files[0]), write_s=write_s,
             read_s=read_s, read_ms_per_file=read_s * 1e3 / len(files),
             in_process_wall_s=in_s, fields_per_s_from_files=F_ / in_s,
             in_memory_wall_s=mem_s, fields_per_s_in_memory=F_ / mem_s,
             cli_wall_s=cli_s, rows=summary["rows"],
             launches=exp_launches, csvs_byte_equal=True,
             note="read_s: _load_stack alone in this process; "
                  "in_process_wall_s: the subcommand through "
                  "__main__.main, files to both CSVs; in_memory_wall_s: "
                  "run_experiment on the host array with both CSVs, "
                  "warm; cli_wall_s: the subcommand in a "
                  "process of its own, start-up included")

        # Kernels A and B against their twins on the first group of the
        # stack as read from its files.
        imgs = torch.from_numpy(loaded[:GROUP_FIELDS]).to(dev).reshape(
            -1, H, W).to(torch.float32)
        cm = candidate_map_fused(imgs, tmpl)
        err_a = float((cm - candidate_map_plain(imgs, tmpl)).abs().max())
        check(err_a == 0.0, f"kernel A vs twin at {tuple(imgs.shape)} "
                            f"(max abs err {err_a})")
        a_ms = statistics.median(time_ms(
            lambda: candidate_map_fused(imgs, tmpl), 10))
        a_plain = statistics.median(time_ms(
            lambda: candidate_map_plain(imgs, tmpl), 3))
        a_bound, a_by = bound(2 * imgs.numel() * 4,
                              imgs.numel() * A_OPS_PER_PIXEL)
        hs, ws, valid, _ = _threshold_and_extract_batch(cm, EXP_K, 2.0)
        n_iters = pipe.config.detect.num_iters
        b = kernel_b_report(imgs, hs, ws, valid, n_iters, 1, reps=3,
                            plain_reps=1)
        del imgs, cm, hs, ws, valid

        # Config 2 as one 32-page TIFF through zstack.
        zs = make_zstack(Z_T)
        ztif = os.path.join(tmp, "zstack.tif")
        port_io.write_tiff(ztif, zs)
        z_read_ms = read_back(ztif, zs, port_io.read_stack_array)
        api = Pipeline(PipelineConfig(detect=DetectConfig(
            max_candidates=Z_K)), device=dev).run_zstack(
                zs, box_size=10, filter_size=10)
        want = [[str(t_), str(api["center_h"][t_, i]),
                 str(api["center_w"][t_, i])]
                for t_ in range(Z_T) for i in np.nonzero(api["keep"][t_])[0]]
        summary, zin_s, z_launches = in_process_cli(
            ["zstack", ztif, "--max-candidates", str(Z_K), "--device",
             str(dev), "--output", os.path.join(tmp, "z.csv")])
        with open(os.path.join(tmp, "z.csv"), newline="") as fh:
            table = list(csv.reader(fh))
        check([r[:3] for r in table[1:]] == want,
              f"zstack's rows are the API's kept fits ({len(table) - 1}, "
              f"{len(want)})")
        check(summary["frames"] == Z_T and
              z_launches["candidate_map"] >= 1 and
              z_launches["fit_quality"] >= 1 and
              z_launches["consolidate"] == -(-Z_T // GROUP_FRAMES),
              f"zstack from a {Z_T}-page TIFF: {summary}, {z_launches}")
        launches["files_zstack"] = z_launches
        emit("files_zstack", frames=Z_T, file_form=f"one {Z_T}-page "
             "uncompressed TIFF", bytes=os.path.getsize(ztif),
             read_ms=z_read_ms, in_process_wall_s=zin_s, rows=len(want),
             launches=z_launches, rows_equal_api=True)

        # The movie as one 24-page TIFF and as 24 PNGs through timetrace.
        movie = make_movie(T=TT_T, n_spots=TT_SPOTS)
        mtif = os.path.join(tmp, "movie.tif")
        port_io.write_tiff(mtif, movie)
        pngs = []
        for f in range(TT_T):
            pngs.append(os.path.join(tmp, f"frame_{f:02d}.png"))
            if have["PIL"]:
                PILImage.fromarray(movie[f]).save(pngs[-1])
            else:
                port_io.write_png(pngs[-1], movie[f])
        tif_read_ms = read_back(mtif, movie, port_io.read_stack_array,
                                reps=1)
        png_read_ms = read_back(pngs, movie, lambda ps: np.concatenate(
            [port_io.read_stack_array(p) for p in ps]), "the movie's PNGs",
            reps=1)
        mem_csv = os.path.join(tmp, "tt_mem.csv")
        ref_out = Pipeline(device=dev).run_timetrace(
            movie, csv_path=mem_csv, max_candidates=None,
            photometry_min=None, **SF_KW)
        with open(mem_csv, "rb") as fh:
            mem_bytes = fh.read()
        flags = ["--mirror-start", str(SF_KW["mirror_start"]),
                 "--chung-kennedy", str(SF_KW["chung_kennedy"]),
                 "--p-threshold", str(SF_KW["p_threshold"]),
                 "--device", str(dev)]
        tt = {}
        for form, frames in (("tiff", [mtif]), ("png", pngs)):
            summary, tin_s, t_launches = in_process_cli(
                ["timetrace", "--frames", *frames, *flags, "--output-dir",
                 os.path.join(tmp, f"tt_in_{form}")])
            outs, tt[form] = [summary], {"in_process_wall_s": tin_s,
                                         "launches": t_launches}
            if form == "tiff":
                sub, tt[form]["cli_wall_s"] = run_cli(
                    ["timetrace", "--frames", *frames, *flags,
                     "--output-dir", os.path.join(tmp, "tt_cli")])
                outs.append(sub)
            for out in outs:
                with open(out["csv"], "rb") as fh:
                    check(fh.read() == mem_bytes,
                          f"timetrace's CSV from {form} is byte for byte "
                          f"run_timetrace's on the array")
            check(summary["traces"] == ref_out["trace_count"] and
                  t_launches["candidate_map"] >= 1 and
                  t_launches["fit_quality"] >= 1,
                  f"timetrace from {form}: {summary}, {t_launches}")
            launches[f"files_timetrace_{form}"] = t_launches
        tt["tiff"].update(read_ms=tif_read_ms, bytes=os.path.getsize(mtif))
        tt["png"].update(read_ms=png_read_ms,
                         writer="Pillow" if have["PIL"] else "port",
                         bytes=sum(os.path.getsize(p) for p in pngs))
        emit("files_timetrace", shape=list(movie.shape),
             traces=ref_out["trace_count"], csv_bytes_equal=True,
             by_form=tt, note="read_ms: the whole movie, this process")

        # detect on FILES_DETECT_T of config 2's frames.
        det = []
        for i in range(FILES_DETECT_T):
            det.append(os.path.join(tmp, "detect", f"frame_{i:02d}.tif"))
            os.makedirs(os.path.dirname(det[-1]), exist_ok=True)
            port_io.write_tiff(det[-1], zs[i])
        t = time.perf_counter()
        for p in det:
            port_io.read_image(p)
        d_read_s = time.perf_counter() - t
        d_in, din_s, d_launches = in_process_cli(
            ["detect", "--device", str(dev), *det])
        worst = 0.0
        for i, p in enumerate(det):
            want = find_peptides(zs[i], device=dev)
            with open(d_in["artifacts"][p][0], "rb") as fh:
                got = pickle.load(fh)
            check(list(got) == list(want) and len(want) > 0,
                  f"detect's psfs keys of {p} are find_peptides'")
            for key, r in want.items():
                g = got[key]
                worst = max(worst, float(np.abs(
                    np.subtract(g[:2], r[:2])).max()))
                check(np.allclose(g[:2], r[:2], rtol=0, atol=B_CENTER)
                      and np.allclose(g[2:6], r[2:6], rtol=5e-3, atol=5e-3)
                      and np.allclose(g[9:], r[9:], rtol=5e-3, atol=5e-3)
                      and np.array_equal(g[7], r[7]),
                      f"detect's psfs {key} of {p}: {g[:7]} against "
                      f"{r[:7]}")
        check(d_launches["candidate_map"] >= 1 and
              d_launches["fit_quality"] >= 1,
              f"both kernels launched under detect: {d_launches}")
        launches["files_detect"] = d_launches
        emit("files_detect", images=FILES_DETECT_T, shape=[H, W],
             read_s=d_read_s, in_process_wall_s=din_s,
             spots=[d_in["spots"][p] for p in det],
             launches=d_launches, max_center_diff=worst)

        # The reference scripts: the image and experiment scripts on
        # planted tif files, then basic_timetrace_script on the movie's
        # frames as per-frame TIFFs.
        launches["objects_apps"] = objects_apps(dev)

        def timetrace_script(device, count, name):
            frames = []
            for f in range(count):
                frames.append(os.path.join(tmp, name, f"frame_{f:03d}.tif"))
                os.makedirs(os.path.dirname(frames[-1]), exist_ok=True)
                port_io.write_tiff(frames[-1], movie[f])
            out = os.path.join(tmp, name, "out")
            torch.cuda.synchronize()
            candidate_map_fused.launches = 0
            fit_quality.launches = 0
            consolidate.launches = 0
            t = time.perf_counter()
            tte = basic_timetrace_script.main(
                ["--output_directory", out, "--no_sanity_check_images",
                 "-L", os.path.join(tmp, name + ".log"), "--device",
                 device, *frames])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            with open(os.path.join(out, "test.csv"), newline="") as fh:
                rows = list(csv.reader(fh))
            with open(os.path.join(out, "test.pkl"), "rb") as fh:
                fits = pickle.load(fh)
            return {"wall_s": wall, "rows": rows, "fits": fits,
                    "traces": len(tte.spot_traces),
                    "launches": {"candidate_map": candidate_map_fused.launches,
                                 "fit_quality": fit_quality.launches,
                                 "consolidate": consolidate.launches}}

        full = timetrace_script(str(dev), TT_T, "tts_full")
        check(full["traces"] > 0 and
              len(full["rows"]) == 1 + full["traces"] * TT_T and
              full["launches"]["candidate_map"] >= 1 and
              full["launches"]["fit_quality"] >= 1,
              f"basic_timetrace_script on {TT_T} frames: "
              f"{full['traces']} traces, {len(full['rows'])} rows, "
              f"{full['launches']}")
        launches["files_timetrace_script"] = full["launches"]
        card = timetrace_script(str(dev), FILES_TT_CPU_T, "tts_card")
        cpu = timetrace_script("cpu", FILES_TT_CPU_T, "tts_cpu")
        _device.set_default_device(None)
        (fc, ic), (fp, ip) = cpu["fits"], card["fits"]
        check(card["rows"][0] == cpu["rows"][0] and
              len(card["rows"]) == len(cpu["rows"]) and
              fc.keys() == fp.keys() and ic.keys() == ip.keys(),
              "basic_timetrace_script: the card's rows and step-fit keys "
              "are the CPU's")
        worst_tt = 0.0
        for a, b_ in zip(card["rows"][1:], cpu["rows"][1:]):
            check(a[:4] == b_[:4] and a[5] == b_[5],
                  f"basic_timetrace_script row {a[:6]} against {b_[:6]}")
            for x, y in zip(a[4:], b_[4:]):
                if x == "None" or y == "None":
                    check(x == y, f"None cells agree: {x}, {y}")
                    continue
                xv = np.asarray(ast.literal_eval(x), float)
                yv = np.asarray(ast.literal_eval(y), float)
                worst_tt = max(worst_tt, float(np.abs(xv - yv).max()))
                check(np.allclose(xv, yv, rtol=CLASS_RTOL, atol=CLASS_ATOL),
                      f"basic_timetrace_script cell {x} against {y}")
        for k in fc:
            check([q[:2] for q in fp[k].trace] ==
                  [q[:2] for q in fc[k].trace],
                  f"trace {k}'s positions on the card and the CPU")
        emit("files_timetrace_script", frames=TT_T, shape=[H, W],
             file_form="per-frame uncompressed TIFF", wall_s=full["wall_s"],
             traces=full["traces"], launches=full["launches"],
             card_vs_cpu={"frames": FILES_TT_CPU_T,
                          "card_wall_s": card["wall_s"],
                          "cpu_wall_s": cpu["wall_s"],
                          "traces": card["traces"],
                          "max_abs_cell_diff": worst_tt})

    return {
        "launches": launches,
        "kernels": {
            "candidate_map": {"files": {
                "shape": [GROUP_FIELDS * C_, H, W], "max_abs_err": err_a,
                "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
                "bound_by": a_by, "share_of_bound": a_bound / a_ms}},
            "fit_quality": {"files": {
                "fits": b["fits"], "num_iters": n_iters,
                "max_abs_err": b["max_abs_err_all_outputs"],
                "ms": b["ms_median"], "plain_ms": b["plain_ms_median"],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "share_of_bound": b["share_of_bound"]}}}}


def psfs_card_vs_cpu(card, cpu, what):
    """Two psfs dicts of one image: equal keys in equal order, equal
    sub_img, centers within B_CENTER px, R^2 within B_R2, RMSE within
    CARD_CPU_RMSE_REL of itself or CARD_CPU_RMSE_OF_AMPLITUDE of the
    amplitude. Returns the largest center difference."""
    check(list(card) == list(cpu) and len(cpu) > 0,
          f"{what}: psfs keys on the card and the CPU "
          f"({len(card)}, {len(cpu)})")
    worst = 0.0
    for key, c in cpu.items():
        g = card[key]
        d = max(abs(g[0] - c[0]), abs(g[1] - c[1]))
        check(d <= B_CENTER and abs(g[10] - c[10]) <= B_R2 and
              abs(g[9] - c[9]) <= max(CARD_CPU_RMSE_REL * abs(c[9]),
                                      CARD_CPU_RMSE_OF_AMPLITUDE * abs(c[3]))
              and
              np.array_equal(g[7], c[7]),
              f"{what}: psf {key}: card {g[:2]}, {g[9:]}; CPU {c[:2]}, "
              f"{c[9:]}")
        worst = max(worst, d)
    return worst


def zstack_phases(tmpl, dev):
    """The z-stack and single-image front doors on the card; emits the
    "background", "zstack", "zstack_exhaustive", "find_peptides", "cli" and
    "zstack_card_vs_cpu" lines and returns the kernels' launches on each
    path and their numbers at these paths' shapes."""
    from fluorosequencingimageanalysis_torch.api import GROUP_FRAMES, Pipeline
    from fluorosequencingimageanalysis_torch.models.detect import (
        EXHAUSTIVE_CHUNK, detect_and_fit_batch, find_peptides,
        find_peptides_batch, pack_spot_buckets)
    from fluorosequencingimageanalysis_torch.ops.background import (
        stack_background, widen)
    from fluorosequencingimageanalysis_torch.ops.candidates import (
        _threshold_and_extract_batch)
    from fluorosequencingimageanalysis_torch.ops.consolidate import (
        consolidate, consolidate_host)
    from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
        candidate_map_fused, candidate_map_plain)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality)
    from fluorosequencingimageanalysis_torch.pipeline.spots import (
        _mesh_background)
    from fluorosequencingimageanalysis_torch.utils import profiling
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_stack, make_zstack, zstack_recall)

    def reset_launches():
        candidate_map_fused.launches = 0
        fit_quality.launches = 0
        consolidate.launches = 0

    def read_launches():
        return {"candidate_map": candidate_map_fused.launches,
                "fit_quality": fit_quality.launches,
                "consolidate": consolidate.launches}

    t = time.perf_counter()
    stack, pos = make_zstack(Z_T, return_truth=True)
    synth_s = time.perf_counter() - t
    T, H, W = stack.shape
    g = GROUP_FRAMES

    # Background: the card against the float64 host oracle and the CPU.
    g0 = torch.from_numpy(stack[:g]).to(dev)
    whole = torch.from_numpy(stack).to(dev)
    with torch.no_grad():
        bg = stack_background(g0)
        check(bg.dtype == torch.float32 and tuple(bg.shape) == (g, H, W),
              f"background {tuple(bg.shape)} {bg.dtype}")
        t = time.perf_counter()
        oracle = np.stack([_mesh_background(f, 10, 10) for f in stack[:4]])
        oracle_s = (time.perf_counter() - t) / 4
        scale = np.abs(oracle).max()
        err_oracle = float(np.abs(bg[:4].cpu().numpy() - oracle).max()
                           / scale)
        on_cpu = stack_background(stack[:4], device="cpu").numpy()
        err_cpu = float(np.abs(bg[:4].cpu().numpy() - on_cpu).max() / scale)
        check(err_oracle < BG_BOUND and err_cpu < BG_BOUND,
              f"background vs float64 oracle {err_oracle}, vs CPU {err_cpu}")
        bg_ms = time_ms(lambda: stack_background(g0), 5)
        bg_whole_ms = time_ms(lambda: stack_background(whole), 3)
    emit("background", shape=[g, H, W], dtype=str(stack.dtype),
         box_size=10, filter_size=10, max_rel_err_vs_float64_oracle=err_oracle,
         max_rel_err_vs_cpu=err_cpu, bound=BG_BOUND,
         ms_median=statistics.median(bg_ms), ms_runs=bg_ms,
         ms_median_32_frames=statistics.median(bg_whole_ms),
         host_oracle_s_per_frame=oracle_s)
    del whole

    # Config 2 through the user's entry point.
    pipe = Pipeline(device=dev, profile=True)
    kw = dict(max_candidates=Z_K, lean=True, max_spots=Z_S)
    n_iters = pipe.config.detect.num_iters
    t = time.perf_counter()
    pipe.run_zstack(stack, **kw)
    warm_s = time.perf_counter() - t
    runs = []
    for _ in range(Z_REPS):
        profiling.reset_timings()
        profiling.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t = time.perf_counter()
        lean = pipe.run_zstack(stack, **kw)
        torch.cuda.synchronize()
        runs.append({"wall_s": time.perf_counter() - t,
                     "launches": read_launches(),
                     "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
                     "stage_s": profiling.timings()["api/run_zstack"]["total"],
                     "counters": profiling.counters()})
    n_groups = -(-T // g)
    for r in runs:
        check(r["launches"] == {"candidate_map": n_groups,
                                "fit_quality": n_groups,
                                "consolidate": n_groups},
              f"each group launched kernels A, B and F once: "
              f"{r['launches']}")
    full = pipe.run_zstack(stack, max_candidates=Z_K)
    check(full["keep"].shape == (T, Z_K) and lean["keep"].shape == (T, Z_S)
          and full["cand_count"].dtype == np.int32,
          f"run_zstack shapes {full['keep'].shape}, {lean['keep'].shape}")
    check(bool((lean["spot_count"] <= Z_S).all()),
          f"spot_count <= max_spots: {lean['spot_count'].max()}")
    for t_ in range(T):
        first = np.nonzero(full["keep"][t_])[0]
        n = len(first)
        check(n == lean["spot_count"][t_] and lean["keep"][t_, :n].all()
              and not lean["keep"][t_, n:].any(),
              f"frame {t_}: lean keeps {lean['spot_count'][t_]}, full {n}")
        for k in ("cand_h", "cand_w", "center_h", "center_w", "rmse", "r2",
                  "s_n", "params"):
            check(np.array_equal(lean[k][t_, :n], full[k][t_][first]),
                  f"frame {t_}: lean {k} equals the full schema's kept "
                  "slots bit for bit")
    check(np.isfinite(lean["params"][lean["keep"]]).all() and
          np.isfinite(lean["center_h"][lean["keep"]]).all(),
          "kept fits are finite")
    recall_all = zstack_recall(pos, lean)
    near = np.array([np.sort(np.hypot(*(pos - p).T))[1] for p in pos])
    isolated = pos[near > ISOLATED_PX]
    recall_iso = zstack_recall(isolated, lean)
    check(recall_iso.min() >= 0.95,
          f"isolated planted spots within 1 px in every frame: "
          f"{recall_iso.min()}")

    # One group's stages on the device, and both kernels against their
    # twins at the group's shapes.
    with torch.no_grad():
        sub = widen(g0) - stack_background(g0)
        cm = candidate_map_fused(sub, tmpl)
        err_a = float((cm - candidate_map_plain(sub, tmpl)).abs().max())
        check(err_a == 0.0, f"kernel A vs twin at {tuple(sub.shape)} "
                            f"(max abs err {err_a})")
        a_ms = time_ms(lambda: candidate_map_fused(sub, tmpl), 10)
        a_plain = time_ms(lambda: candidate_map_plain(sub, tmpl), 3)
        a_bound, a_by = bound(2 * sub.numel() * 4,
                              sub.numel() * A_OPS_PER_PIXEL)
        hs, ws, valid, _ = _threshold_and_extract_batch(cm, Z_K, 2.0)
        b = kernel_b_report(sub, hs, ws, valid, n_iters, 1, reps=5,
                            plain_reps=2)
        hs_c, ws_c, valid_c = (x[:, :EXHAUSTIVE_CHUNK].contiguous()
                               for x in (hs, ws, valid))
        b_chunk = kernel_b_report(sub, hs_c, ws_c, valid_c, n_iters, 1,
                                  reps=5, plain_reps=2)
        fq = fit_quality(sub, hs, ws, n_iters, 1)
        passed = valid & ~(fq[4] < 0.7)
        res = detect_and_fit_batch(sub, max_candidates=Z_K,
                                   num_iters=n_iters)
        packed = pack_spot_buckets(res, Z_S)
        pinned = torch.from_numpy(stack[:g]).pin_memory()
        group_ms = {
            "upload_pinned_host_clock": host_ms(
                lambda: pinned.to(dev, non_blocking=True), 5),
            "background": statistics.median(bg_ms),
            "subtract": statistics.median(time_ms(
                lambda: widen(g0) - bg, 5)),
            "candidate_map_kernel": statistics.median(a_ms),
            "extraction": statistics.median(time_ms(
                lambda: _threshold_and_extract_batch(cm, Z_K, 2.0), 5)),
            "fit_quality_kernel": b["ms_median"],
            "consolidate": statistics.median(time_ms(
                lambda: consolidate(fq[1], fq[2], fq[4], passed, 4.0), 3)),
            "detect_and_fit_batch": statistics.median(time_ms(
                lambda: detect_and_fit_batch(sub, max_candidates=Z_K,
                                             num_iters=n_iters), 3)),
            "lean_pack": statistics.median(time_ms(
                lambda: pack_spot_buckets(res, Z_S), 5)),
            "lean_fetch_host_clock": host_ms(
                lambda: [x.cpu() for x in packed], 5),
            "full_fetch_host_clock": host_ms(
                lambda: [x.cpu() for x in res], 5),
        }
    del fq, passed, res, packed, cm
    walls = [r["wall_s"] for r in runs]
    emit("zstack", shape=list(stack.shape), dtype=str(stack.dtype),
         max_candidates=Z_K, max_spots=Z_S, num_iters=n_iters,
         group_frames=g, synth_s=synth_s, warmup_s=warm_s,
         frames_per_s=T / statistics.median(walls),
         wall_s_median=statistics.median(walls), runs=runs,
         kept_per_frame_mean=float(lean["spot_count"].mean()),
         kept_per_frame_minmax=[int(lean["spot_count"].min()),
                                int(lean["spot_count"].max())],
         cand_count_mean=float(lean["cand_count"].mean()),
         cand_overflow_frames=int((lean["cand_count"] > Z_K).sum()),
         planted=len(pos), recall_1px_min=float(recall_all.min()),
         recall_1px_mean=float(recall_all.mean()),
         isolated_planted=len(isolated),
         isolated_recall_1px_min=float(recall_iso.min()),
         lean_equals_full_kept_slots=True, group_device_ms=group_ms,
         note="wall = run_zstack from a host uint16 stack to host numpy "
              "outputs; group_device_ms are device times (CUDA events, "
              "medians) of one group of GROUP_FRAMES frames, each stage "
              "alone, except the *_host_clock entries; isolated = no other "
              "planted spot within ISOLATED_PX")

    # The exhaustive path on the first frames against the capped run.
    few = stack[:Z_EXH_T]
    pipe.run_zstack(few, max_candidates="exhaustive")
    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    exh = pipe.run_zstack(few, max_candidates="exhaustive")
    torch.cuda.synchronize()
    exh_s = time.perf_counter() - t
    exh_launches = read_launches()
    check(exh_launches["candidate_map"] > 0 and
          exh_launches["fit_quality"] > 0 and
          exh_launches["consolidate"] == 0,
          f"kernels A and B launched on the exhaustive path, F not (its "
          f"NMS is consolidate_host): {exh_launches}")
    over = full["cand_count"][:Z_EXH_T] > Z_K
    # The host NMS alone, on the fetched arrays of each frame.
    t = time.perf_counter()
    for t_ in range(Z_EXH_T):
        passed_np = exh["cand_valid"][t_] & ~(exh["r2"][t_] < 0.7)
        check(np.array_equal(
            consolidate_host(exh["center_h"][t_], exh["center_w"][t_],
                             exh["r2"][t_], passed_np, radius=4.0),
            exh["keep"][t_]), f"frame {t_}: host NMS reproduces keep")
    nms_s = (time.perf_counter() - t) / Z_EXH_T
    same_keep = 0
    for t_ in range(Z_EXH_T):
        ke, kc = ({(int(h_), int(w_)) for h_, w_ in
                   zip(o["cand_h"][t_][o["keep"][t_]],
                       o["cand_w"][t_][o["keep"][t_]])} for o in (exh, full))
        check(exh["cand_count"][t_] == full["cand_count"][t_],
              f"frame {t_}: candidate counts {exh['cand_count'][t_]}, "
              f"{full['cand_count'][t_]}")
        if over[t_]:
            check(kc <= ke or len(kc - ke) <= 0.02 * len(kc),
                  f"frame {t_} overflows {Z_K}: capped keeps not in the "
                  f"exhaustive set: {len(kc - ke)}")
        else:
            check(ke == kc, f"frame {t_}: exhaustive keep set differs from "
                            f"the capped run's ({len(ke ^ kc)} fits)")
            same_keep += 1
    emit("zstack_exhaustive", frames=Z_EXH_T, chunk=EXHAUSTIVE_CHUNK,
         K=int(exh["keep"].shape[1]), wall_s=exh_s, launches=exh_launches,
         chunks_per_group=int(exh["keep"].shape[1]) // EXHAUSTIVE_CHUNK,
         nms_host_s_per_frame=nms_s,
         cand_count=exh["cand_count"].tolist(),
         frames_over_capped_bucket=int(over.sum()),
         frames_with_equal_keep_sets=same_keep,
         kept_per_frame=exh["keep"].sum(axis=1).tolist())
    del sub, g0

    # find_peptides and find_peptides_batch: the card against the CPU.
    fields, _ = make_stack(2, 1, HW, HW, seed=3)
    fields = fields[:, 0]
    reset_launches()
    t = time.perf_counter()
    card = find_peptides(fields[0])
    fp_s = time.perf_counter() - t
    card_b = find_peptides_batch(fields)
    fp_launches = read_launches()
    check(fp_launches["candidate_map"] > 0 and
          fp_launches["fit_quality"] > 0 and fp_launches["consolidate"] == 0,
          f"kernels A and B launched under find_peptides, F not (uncapped: "
          f"consolidate_host): {fp_launches}")
    t = time.perf_counter()
    cpu = find_peptides(fields[0], device="cpu")
    fp_cpu_s = time.perf_counter() - t
    cpu_b = find_peptides_batch(fields, device="cpu")
    worst = psfs_card_vs_cpu(card, cpu, "find_peptides")
    for i in range(2):
        worst = max(worst, psfs_card_vs_cpu(card_b[i], cpu_b[i],
                                            f"find_peptides_batch[{i}]"))
    check(list(card_b[0]) == list(card), "find_peptides_batch[0] has "
                                         "find_peptides' keys")
    emit("find_peptides", shape=[HW, HW], psfs=len(card),
         psfs_batch=[len(p) for p in card_b], launches=fp_launches,
         max_center_diff_card_vs_cpu=worst, card_s=fp_s, cpu_s=fp_cpu_s)

    # The zstack subcommand in a process of its own.
    with tempfile.TemporaryDirectory() as tmp:
        npy, out_csv = os.path.join(tmp, "frames.npy"), os.path.join(
            tmp, "spots.csv")
        np.save(npy, few)
        summary, cli_s = run_cli(["zstack", npy, "--output", out_csv,
                                  "--max-candidates", str(Z_K)])
        with open(out_csv, newline="") as fh:
            table = list(csv.reader(fh))
    want = [[str(t_), str(full["center_h"][t_, i]),
             str(full["center_w"][t_, i])]
            for t_ in range(Z_EXH_T) for i in np.nonzero(full["keep"][t_])[0]]
    check(summary["frames"] == Z_EXH_T and summary["spots"] == len(want)
          and [r[:3] for r in table[1:]] == want,
          f"the CSV's rows are the API's kept fits ({len(table) - 1}, "
          f"{len(want)})")
    emit("cli", command="zstack", frames=Z_EXH_T, rows=len(table) - 1,
         wall_s=cli_s)

    # run_zstack: the card against the CPU on a reduced stack.
    small = make_zstack(**Z_SMALL)
    on_card = Pipeline(device=dev).run_zstack(small,
                                              max_candidates=Z_SMALL_K)
    t = time.perf_counter()
    on_cpu = Pipeline(device="cpu").run_zstack(small,
                                               max_candidates=Z_SMALL_K)
    cpu_s = time.perf_counter() - t
    for k in ("cand_h", "cand_w", "keep", "cand_valid", "cand_count"):
        check(np.array_equal(on_card[k], on_cpu[k]),
              f"run_zstack {k} equal on the card and the CPU")
    kept = on_cpu["keep"]
    dc = max(float(np.abs(on_card[k][kept] - on_cpu[k][kept]).max())
             for k in ("center_h", "center_w"))
    dr2 = float(np.abs(on_card["r2"][kept] - on_cpu["r2"][kept]).max())
    check(kept.sum() > 0 and dc <= B_CENTER and dr2 <= B_R2,
          f"run_zstack kept fits card vs CPU: centers {dc}, R^2 {dr2}")
    emit("zstack_card_vs_cpu", shape=list(small.shape),
         max_candidates=Z_SMALL_K, kept=int(kept.sum()),
         max_center_diff=dc, max_r2_diff=dr2, cpu_s=cpu_s)

    def b_numbers(rep):
        return {"fits": rep["fits"], "num_iters": n_iters,
                "max_abs_err": rep["max_abs_err_all_outputs"],
                "ms": rep["ms_median"], "plain_ms": rep["plain_ms_median"],
                "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                "share_of_bound": rep["share_of_bound"]}

    return {
        "launches": {"zstack": runs[0]["launches"],
                     "zstack_exhaustive": exh_launches,
                     "find_peptides": fp_launches},
        "kernels": {
            "candidate_map": {"zstack_group": {
                "shape": [g, H, W], "max_abs_err": err_a,
                "ms": statistics.median(a_ms),
                "plain_ms": statistics.median(a_plain), "bound_ms": a_bound,
                "bound_by": a_by,
                "share_of_bound": a_bound / statistics.median(a_ms)}},
            "fit_quality": {"zstack_group": b_numbers(b),
                            "exhaustive_chunk": b_numbers(b_chunk)}}}


def same_result(a, b):
    """Two results of one function equal bit for bit: containers item by
    item, arrays with their dtypes and shapes, NaN where NaN."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b) and
                all(same_result(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b) and
                all(same_result(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and
                a.shape == b.shape and
                np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"))
    if isinstance(a, (float, np.floating)) and np.isnan(a):
        return isinstance(b, (float, np.floating)) and bool(np.isnan(b))
    return type(a) is type(b) and bool(a == b)


def same_plateaus(a, b):
    """Two plateau lists: starts and stops equal, heights within 1e-9."""
    return ([p[:2] for p in a] == [p[:2] for p in b] and
            np.allclose([p[2] for p in a], [p[2] for p in b], rtol=1e-9,
                        atol=0))


def cpu_model():
    """The host CPU's name from /proc/cpuinfo, else its architecture."""
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return platform.machine()


def timetrace_phases(tmpl, dev):
    """The movie front door and both step fitters on the card; emits the
    "stepfit", "chi_squared", "timetrace", "timetrace_card_vs_cpu" and
    "cli" (stepfit) lines and returns the kernels' launches per
    run_timetrace and their numbers at this path's shapes."""
    from fluorosequencingimageanalysis_torch import stepfitting as sf
    from fluorosequencingimageanalysis_torch.api import Pipeline
    from fluorosequencingimageanalysis_torch.config import (PipelineConfig,
                                                            StepfitConfig)
    from fluorosequencingimageanalysis_torch.models.detect import (
        EXHAUSTIVE_CHUNK)
    from fluorosequencingimageanalysis_torch.native.stepchain import (
        default_threads)
    from fluorosequencingimageanalysis_torch.ops.background import widen
    from fluorosequencingimageanalysis_torch.ops.candidates import (
        extract_candidates_chunk)
    from fluorosequencingimageanalysis_torch.ops.consolidate import (
        consolidate)
    from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
        candidate_map_fused, candidate_map_plain)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality)
    from fluorosequencingimageanalysis_torch.ops.stepfit_batch import (
        _ck_and_masks)
    from fluorosequencingimageanalysis_torch.pipeline.fast_timetrace import (
        _lc_track_scan, _start_states)
    from fluorosequencingimageanalysis_torch.utils import profiling
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_chisq_traces, make_movie, make_step_traces)

    host = {"cpu": cpu_model(), "cpu_count": os.cpu_count(),
            "native_threads": default_threads()}

    # Config 3: batched step fitting through the user's entry point.
    traces, drops = make_step_traces(SF_N, SF_T, return_truth=True)
    cfg = PipelineConfig(stepfit=StepfitConfig(**SF_KW))
    pipe = Pipeline(cfg, device=dev, profile=True)
    t = time.perf_counter()
    pipe.stepfit(traces)
    warm_s = time.perf_counter() - t
    runs = []
    for _ in range(SF_REPS):
        profiling.reset_timings()
        profiling.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        fits = pipe.stepfit(traces)
        torch.cuda.synchronize()
        runs.append({"wall_s": time.perf_counter() - t,
                     "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
                     "stages_s": {k: v["total"] for k, v in
                                  profiling.timings().items()},
                     "counters": profiling.counters()})
    mirrored = np.concatenate([traces[:, :SF_KW["mirror_start"]][:, ::-1],
                               traces], axis=1)
    on_dev = torch.from_numpy(np.ascontiguousarray(mirrored)).to(dev)
    with torch.no_grad():
        ck_ms = time_ms(lambda: _ck_and_masks(
            on_dev, p_threshold=SF_KW["p_threshold"]), 5)
    del on_dev
    t = time.perf_counter()
    on_cpu = Pipeline(cfg, device="cpu").stepfit(traces)
    cpu_s = time.perf_counter() - t
    check(len(fits) == len(on_cpu) == SF_N, f"{len(fits)} step fits")
    worst_ck = 0.0
    for i, (g, c) in enumerate(zip(fits, on_cpu)):
        check(g[0] == c[0] and same_plateaus(g[2], c[2]) and
              same_plateaus(g[3], c[3]),
              f"trace {i}: card {g[3]}, CPU {c[3]}")
        worst_ck = max(worst_ck, float(np.max(np.abs(
            np.asarray(g[1]) - np.asarray(c[1])))))
    check(worst_ck <= 1e-6, f"CK traces card vs CPU: {worst_ck}")
    t = time.perf_counter()
    for i in range(SF_HOST_SAMPLE):
        m = sf.mirror_photometries(tuple(traces[i].tolist()),
                                   mirror_size=SF_KW["mirror_start"])
        ck = sf.chung_kennedy_filter(luminosities=m,
                                     window_lengths=(2, 4, 8, 16))
        pl = sf.sliding_t_fitter(
            luminosity_sequence=ck, window_radius=6,
            p_threshold=SF_KW["p_threshold"], median_filter_size=None,
            downsteps_only=False, min_step_magnitude=None)
        pl = sf.refit_plateaus(m, pl)
        tf = sf.t_test_filter(luminosities=m, plateaus=pl,
                              p_threshold=SF_KW["p_threshold"],
                              drop_sort=True,
                              no_merge_start=SF_KW["mirror_start"])
        want = sf.unmirror_plateaus(tf, mirror_size=SF_KW["mirror_start"])
        check(same_plateaus(fits[i][3], want),
              f"trace {i}: card {fits[i][3]}, host chain {want}")
    host_chain_s = (time.perf_counter() - t) / SF_HOST_SAMPLE
    check(any(len(f[3]) > 1 for f in fits), "some trace has a step")
    walls = [r["wall_s"] for r in runs]
    emit("stepfit", shape=[SF_N, SF_T], **SF_KW, dtype="float64",
         warmup_s=warm_s, wall_s_median=statistics.median(walls),
         traces_per_s=SF_N / statistics.median(walls), runs=runs,
         ck_masks_device_ms_median=statistics.median(ck_ms),
         ck_masks_device_ms_runs=ck_ms,
         equal_to_cpu_run=SF_N, max_ck_diff_card_vs_cpu=worst_ck,
         cpu_run_s=cpu_s, equal_to_host_chain=SF_HOST_SAMPLE,
         host_chain_s_per_trace=host_chain_s,
         plateaus_mean=float(np.mean([len(f[3]) for f in fits])),
         planted_step_count_recovered=float(np.mean(
             [len(f[3]) - 1 == len(d) for f, d in zip(fits, drops)])),
         host=host,
         note="wall = Pipeline.stepfit from a host float64 array to the "
              "Python result lists; stages_s are host-clock totals "
              "(stepfit/ck+masks is the enqueueing, stepfit/fetch the wait "
              "for the device); ck_masks_device_ms is the device time of "
              "the CK filter and the detector alone (CUDA events)")

    # The chi-squared fitter: host work, whatever the Pipeline's device.
    chi = make_chisq_traces(CHI_N, CHI_T)
    pipe.chi_squared_stepfit(chi[:64], num_steps=CHI_STEPS)
    chi_walls = []
    for _ in range(3):
        t = time.perf_counter()
        chi_fits = pipe.chi_squared_stepfit(chi, num_steps=CHI_STEPS)
        chi_walls.append(time.perf_counter() - t)
    t = time.perf_counter()
    for i in range(CHI_HOST_SAMPLE):
        want = sf.chi_squared_step_fitter(tuple(float(v) for v in chi[i]),
                                          num_steps=CHI_STEPS)
        check(chi_fits[i] == [tuple(p) for p in want],
              f"chi-squared trace {i}: {chi_fits[i]}, oracle {want}")
    emit("chi_squared", shape=[CHI_N, CHI_T], num_steps=CHI_STEPS,
         wall_s_median=statistics.median(chi_walls), wall_s_runs=chi_walls,
         traces_per_s=CHI_N / statistics.median(chi_walls),
         equal_to_host_oracle=CHI_HOST_SAMPLE,
         host_oracle_s_per_trace=(time.perf_counter() - t) /
         CHI_HOST_SAMPLE,
         plateaus_mean=float(np.mean([len(f) for f in chi_fits])),
         host=host, note="host work only: the native core's threads on "
                         "the machine's CPU; nothing runs on the card")

    # The movie front door at full width.
    t = time.perf_counter()
    movie, truth = make_movie(T=TT_T, n_spots=TT_SPOTS, return_truth=True)
    synth_s = time.perf_counter() - t
    T, H, W = movie.shape
    pipe = Pipeline(device=dev, profile=True)
    n_iters = pipe.config.detect.num_iters
    kw = dict(max_candidates=None, **SF_KW)
    stages = ["api/run_timetrace/" + s for s in
              ("upload", "detect", "track+photometry", "stepfit",
               "assemble", "csv")]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "tt.csv")
        t = time.perf_counter()
        pipe.run_timetrace(movie, csv_path=csv_path, **kw)
        warm_s = time.perf_counter() - t
        for _ in range(TT_REPS):
            profiling.reset_timings()
            profiling.reset_counters()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            candidate_map_fused.launches = 0
            fit_quality.launches = 0
            consolidate.launches = 0
            t = time.perf_counter()
            out = pipe.run_timetrace(movie, csv_path=csv_path, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = {"candidate_map": candidate_map_fused.launches,
                        "fit_quality": fit_quality.launches,
                        "consolidate": consolidate.launches}
            st = {k: v["total"] for k, v in profiling.timings().items()}
            runs.append({
                "wall_s": wall, "launches": launches,
                "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
                "stages_s": st, "counters": profiling.counters(),
                "unnamed_share": 1.0 - sum(st[k] for k in stages) / wall})
        with open(csv_path, newline="") as fh:
            table = list(csv.reader(fh))
    n = out["trace_count"]
    check(n > 100, f"run_timetrace found {n} traces")
    for r in runs:
        check(r["launches"]["candidate_map"] == 1 and
              r["launches"]["fit_quality"] >= 1 and
              r["launches"]["consolidate"] == 0,
              f"frame 0's uncapped detection launched both kernels, and "
              f"kernel F not (consolidate_host): {r['launches']}")
        check(r["unnamed_share"] < TT_UNNAMED_SHARE,
              f"share of the wall no stage names: {r['unnamed_share']}")
    check(len(table) == 1 + n * T and
          table[0][:5] == ["Trace #", "Hcoord", "Wcoord", "Frame #",
                           "Photometry"],
          f"the timetrace CSV has {len(table)} rows for {n} traces")
    phot = out["photometries"]
    check(phot.shape == (n, T) and np.isfinite(phot).all(),
          "finite (N, T) photometries")
    rec_h, rec_w = out["traces"]["rec_h"], out["traces"]["rec_w"]
    present = out["traces"]["present"]
    check(rec_h.shape == (T, n) and present[0].all(), "tracks of T frames")

    # Planted spots with no planted neighbour within ISOLATED_PX.
    pos, levels = truth["positions"], truth["levels"]
    p0 = pos[:, 0]
    h0 = np.asarray(out["traces"]["h"], np.float64)
    w0 = np.asarray(out["traces"]["w"], np.float64)
    near = np.array([np.sort(np.hypot(*(p0 - p).T))[1] for p in p0])
    iso = np.nonzero(near > ISOLATED_PX)[0]
    dh = np.abs(p0[iso, None, 0] - h0[None])
    dw = np.abs(p0[iso, None, 1] - w0[None])
    cheb = np.maximum(dh, dw)
    nearest = cheb.argmin(axis=1)
    started = cheb.min(axis=1) <= TT_START_PX
    started_euclid = np.hypot(dh, dw).min(axis=1) <= TT_START_PX
    stayed, steps_equal = [], []
    for s, j in zip(iso[started], nearest[started]):
        live = levels[s] > 0
        d = np.hypot(rec_h[live, j] - pos[s, live, 0],
                     rec_w[live, j] - pos[s, live, 1])
        stayed.append(bool(present[live, j].all() and
                           d.max() <= TT_STAY_PX))
        fit = out["step_fits"][(out["traces"]["h"][j],
                                out["traces"]["w"][j])].trace
        downs = sum(b[2] < a[2] for a, b in zip(fit, fit[1:]))
        steps_equal.append(downs == len(truth["drops"][s]))
    check(started.mean() >= 0.95,
          f"isolated planted spots with a trace starting within "
          f"{TT_START_PX} px on each axis: {started.mean()}")
    check(np.mean(stayed) >= 0.90,
          f"of those traces, within {TT_STAY_PX} px in every live frame: "
          f"{np.mean(stayed)}")

    # The tracker loop alone: device time, and its device operations.
    movie_f = widen(torch.from_numpy(movie).to(dev))
    _, states = _start_states(out["traces"]["h"], out["traces"]["w"], dev)
    with torch.no_grad():
        track_ms = time_ms(lambda: _lc_track_scan(movie_f, *states), 5)
        track_host_ms = host_ms(lambda: _lc_track_scan(movie_f, *states), 5)
        prof = profile_steps(lambda: _lc_track_scan(movie_f, *states), 3)

    # Both kernels against their twins at this path's shapes: frame 0,
    # and the exhaustive path's first chunk of it.
    img = movie_f[:1].contiguous()
    cm = candidate_map_fused(img, tmpl)
    err_a = float((cm - candidate_map_plain(img, tmpl)).abs().max())
    check(err_a == 0.0, f"kernel A vs twin at {tuple(img.shape)} "
                        f"(max abs err {err_a})")
    a_ms = time_ms(lambda: candidate_map_fused(img, tmpl), 20)
    a_plain = time_ms(lambda: candidate_map_plain(img, tmpl), 5)
    a_bound, a_by = bound(2 * img.numel() * 4, img.numel() * A_OPS_PER_PIXEL)
    excluded = torch.zeros((1, H * W), dtype=torch.bool, device=dev)
    hs, ws, valid, remaining, _ = extract_candidates_chunk(
        cm, excluded, EXHAUSTIVE_CHUNK, 2.0)
    b = kernel_b_report(img, hs, ws, valid, n_iters, 1, reps=10,
                        plain_reps=2)
    cand = int(remaining[0])
    check(runs[0]["launches"]["fit_quality"] ==
          max(1, -(-cand // EXHAUSTIVE_CHUNK)),
          f"{cand} candidates in chunks of {EXHAUSTIVE_CHUNK}: "
          f"{runs[0]['launches']}")
    del movie_f, cm

    walls = [r["wall_s"] for r in runs]
    emit("timetrace", shape=list(movie.shape), dtype=str(movie.dtype),
         planted=TT_SPOTS, **SF_KW, max_candidates=None, num_iters=n_iters,
         synth_s=synth_s, warmup_s=warm_s,
         wall_s_median=statistics.median(walls),
         traces_per_s=n / statistics.median(walls), trace_count=n,
         candidates_frame_0=cand, csv_rows=len(table), runs=runs,
         tracker_loop={"frames": T - 1, "tracks": n,
                       "device_ms_median": statistics.median(track_ms),
                       "device_ms_runs": track_ms,
                       "host_clock_ms_median": track_host_ms,
                       "device_ops_per_frame":
                           prof["device_ops_per_step"] / (T - 1),
                       "device_busy_share": prof["device_busy_share"],
                       "top_device_us": prof["top_device_us"][:6]},
         isolated_planted=len(iso),
         started_within_1px_each_axis=float(started.mean()),
         started_within_1px_euclidean=float(started_euclid.mean()),
         stayed_within_1p5px=float(np.mean(stayed)),
         planted_step_count_recovered=float(np.mean(steps_equal)),
         note="wall = run_timetrace from a host uint16 movie to the result "
              "dict and the CSV; stages_s are host-clock totals and "
              "unnamed_share what the api/run_timetrace/* stages leave of "
              "the wall; tracker_loop is _lc_track_scan alone on the "
              "resident float32 movie (CUDA events; device operations and "
              "busy share from torch.profiler over 3 calls)")

    # The card against the CPU on a reduced movie.
    small = make_movie(**TT_SMALL)
    on_card = Pipeline(device=dev).run_timetrace(small, **kw)
    t = time.perf_counter()
    on_cpu = Pipeline(device="cpu").run_timetrace(small, **kw)
    cpu_s = time.perf_counter() - t
    for k in ("h", "w", "rec_h", "rec_w", "present"):
        check(np.array_equal(on_card["traces"][k], on_cpu["traces"][k]),
              f"run_timetrace {k} equal on the card and the CPU")
    pc, pp = on_card["photometries"], on_cpu["photometries"]
    check(np.allclose(pc, pp, rtol=1e-6, atol=PHOT_ATOL),
          f"photometries card vs CPU: {np.abs(pc - pp).max()}")
    big = np.abs(pp) > 1e3
    for key, fit in on_cpu["step_fits"].items():
        got = on_card["step_fits"][key].trace
        check([p[:2] for p in got] == [p[:2] for p in fit.trace],
              f"trace {key}: card {got}, CPU {fit.trace}")
    emit("timetrace_card_vs_cpu", shape=list(small.shape),
         traces=on_cpu["trace_count"],
         max_abs_phot_diff=float(np.abs(pc - pp).max()),
         max_rel_phot_diff_above_1e3=float(
             (np.abs(pc - pp)[big] / np.abs(pp)[big]).max()),
         plateau_boundaries_equal=True, cpu_s=cpu_s)

    # The stepfit subcommand in a process of its own.
    with tempfile.TemporaryDirectory() as tmp:
        npy = os.path.join(tmp, "phot.npy")
        np.save(npy, traces[:CLI_STEPFIT_N])
        summary, cli_s = run_cli(
            ["stepfit", "--npy", npy, "--output-dir", tmp, "--mirror-start",
             str(SF_KW["mirror_start"]), "--chung-kennedy",
             str(SF_KW["chung_kennedy"]), "--p-threshold",
             str(SF_KW["p_threshold"])])
        with open(summary["csv"], newline="") as fh:
            table = list(csv.reader(fh))
    want_steps = sum(len(f[3]) - 1 for f in fits[:CLI_STEPFIT_N])
    check(summary["traces"] == CLI_STEPFIT_N and
          len(table) == 1 + CLI_STEPFIT_N * SF_T and
          summary["steps"] == want_steps,
          f"the stepfit CSV: {len(table)} rows, {summary['steps']} steps "
          f"(the API's: {want_steps})")
    emit("cli", command="stepfit", traces=CLI_STEPFIT_N,
         rows=len(table) - 1, steps=summary["steps"], wall_s=cli_s)

    return {
        "launches": {"timetrace": runs[0]["launches"]},
        "kernels": {
            "candidate_map": {"timetrace": {
                "shape": list(img.shape), "max_abs_err": err_a,
                "ms": statistics.median(a_ms),
                "plain_ms": statistics.median(a_plain), "bound_ms": a_bound,
                "bound_by": a_by,
                "share_of_bound": a_bound / statistics.median(a_ms)}},
            "fit_quality": {"timetrace": {
                "fits": b["fits"], "num_iters": n_iters,
                "max_abs_err": b["max_abs_err_all_outputs"],
                "ms": b["ms_median"], "plain_ms": b["plain_ms_median"],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "share_of_bound": b["share_of_bound"]}}}}


def matmul_form(contrib, invalid, tab_t, seq_ok):
    """The JAX package's form of the scorer in library calls, for a timing
    beside kernel C (the port never calls it): two (n, F*nv) @ (F*nv, S)
    float32 products with the one-hot membership of the table, and a masked
    argmax, in chunks of V8_MATMUL_CHUNK traces."""
    T, F, nv = contrib.shape
    onehot = torch.nn.functional.one_hot(tab_t.long(), nv)      # (F, S, nv)
    M = onehot.permute(0, 2, 1).reshape(F * nv, -1).to(torch.float32)
    ok = seq_ok.bool()[None, :]
    best = []
    for lo in range(0, T, V8_MATMUL_CHUNK):
        c = contrib[lo:lo + V8_MATMUL_CHUNK].reshape(-1, F * nv)
        v = invalid[lo:lo + V8_MATMUL_CHUNK].reshape(-1, F * nv)
        scores = c @ M
        valid = ((v.to(torch.float32) @ M) < 0.5) & ok
        key = torch.where(valid, scores.clamp_min(-1e30),
                          scores.new_full((), float("-inf")))
        best.append(torch.argmax(key, dim=-1))
    return torch.cat(best)


def write_v8_tracks_csv(path, intensities, categories, rows_per_field=1000):
    """A track CSV of integer intensities (OFF tails as written by the
    workload: zeros), 1,000 rows a field, unique (field, h, w)."""
    ints = np.rint(intensities).astype(np.int64)
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                   [f"FRAME {i}" for i in range(ints.shape[1])])
        for i, (cat, row) in enumerate(zip(categories.tolist(),
                                           ints.tolist())):
            w.writerow(["ch1", i // rows_per_field, i % rows_per_field,
                        (7 * i) % rows_per_field, str(tuple(cat))] + row)


def fluor_phases(dev, ptxas, experiment_csv):
    """Fluor counting on the card, config 5: the scorer at full width
    through ``score_traces`` (kernel C against its twin bit for bit, the
    host oracle, the CPU run, the matmul form beside it), a synthetic track
    CSV through ``Pipeline.fluor_counts`` on both ingestion paths and
    through ``fluor_counts_calibrated``, the experiment's own track CSV
    (``experiment_csv``; a reduced experiment is run where that group did
    not), and the four subcommands each in a process of its own. Emits the
    "v8", "fluor_counts" and "cli" lines; returns kernel C's launches on
    each path and its numbers."""
    import contextlib
    import io
    import pickle

    from fluorosequencingimageanalysis_torch.__main__ import main as cli_main
    from fluorosequencingimageanalysis_torch.api import Pipeline
    from fluorosequencingimageanalysis_torch.config import (LognormalConfig,
                                                            PipelineConfig)
    from fluorosequencingimageanalysis_torch.inference.lognormal import (
        _intensities_to_signal_lognormal_v8)
    from fluorosequencingimageanalysis_torch.inference.photometries import (
        read_track_photometries_csv)
    from fluorosequencingimageanalysis_torch.native.trackcsv import (
        read_track_photometries_arrays)
    from fluorosequencingimageanalysis_torch.ops import lognormal as ln
    from fluorosequencingimageanalysis_torch.ops.fused_lognormal import (
        v8_score_fused, v8_score_plain)
    from fluorosequencingimageanalysis_torch.utils import profiling
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_experiment_stack, make_v8_workload)

    # The scorer at full width through its entry point.
    T, F, K = V8_T, V8_F, V8_K
    ints, cats, lfm = make_v8_workload(T, F, K, beta=V8_BETA,
                                       beta_sigma=V8_BETA_SIGMA)
    kw = dict(log_fluor_means=lfm, beta_sigma=V8_BETA_SIGMA, max_possible=K,
              allow_multidrop=True, max_deviation=V8_MAX_DEVIATION)
    t = time.perf_counter()
    ln.score_traces(ints, cats, device=dev, **kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    runs = []
    for _ in range(V8_REPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        v8_score_fused.launches = 0
        t = time.perf_counter()
        seqs, found, best_ls = ln.score_traces(ints, cats, device=dev, **kw)
        torch.cuda.synchronize()
        runs.append({"wall_s": time.perf_counter() - t,
                     "launches": {"v8_score": v8_score_fused.launches},
                     "peak_mem_bytes": int(torch.cuda.max_memory_allocated())})
    chunks = [(lo, min(lo + ln.CUDA_CHUNK, T))
              for lo in range(0, T, ln.CUDA_CHUNK)]
    for r in runs:
        check(r["launches"]["v8_score"] == len(chunks),
              f"score_traces launched kernel C once per chunk of "
              f"{ln.CUDA_CHUNK}: {r['launches']}")
    S = ln.sequence_table(F, K).shape[0]
    check(seqs.shape == (T, F) and found.shape == (T,) and
          best_ls.dtype == np.float64 and np.isfinite(best_ls[found]).all()
          and (np.diff(seqs[found], axis=1) <= 0).all(),
          "score_traces returns finite scores and non-increasing sequences")
    check(found.mean() > 0.95, f"found.mean() = {found.mean()}")

    # Kernel C against its twin, bit for bit, at the main path's shapes.
    table = ln.device_table(F, K, False, True, dev)
    log_int = np.where(ints > 0, np.log(np.maximum(ints, 1e-300)),
                       -10000.0).astype(np.float32)
    lfm_dev = torch.from_numpy(np.asarray(lfm[:K], np.float32)).to(dev)
    contrib, invalid = ln._contrib_invalid(
        torch.from_numpy(log_int).to(dev), torch.from_numpy(cats).to(dev),
        lfm_dev, V8_BETA_SIGMA, float(V8_MAX_DEVIATION))

    def kernel():
        return [v8_score_fused(contrib[lo:hi], invalid[lo:hi], *table)
                for lo, hi in chunks]

    def twin():
        return [v8_score_plain(contrib[lo:lo + V8_TWIN_CHUNK],
                               invalid[lo:lo + V8_TWIN_CHUNK], *table)
                for lo in range(0, T, V8_TWIN_CHUNK)]

    got = [torch.cat(x) for x in zip(*kernel())]
    ref = [torch.cat(x) for x in zip(*twin())]
    torch.cuda.synchronize()
    mismatches = {
        "best_idx": int((got[0] != ref[0]).sum()),
        "found": int((got[1] != ref[1]).sum()),
        "best_logscore_bits": int((got[2].view(torch.int32) !=
                                   ref[2].view(torch.int32)).sum())}
    err_c = float((got[2] - ref[2]).abs().max())
    check(not any(mismatches.values()) and err_c == 0.0,
          f"kernel C vs twin at T={T}, F={F}, nv={K + 1}, S={S}: "
          f"{mismatches}, max abs score err {err_c}")
    check(np.array_equal(ln.sequence_table(F, K)[got[0].cpu().numpy()], seqs)
          and np.array_equal(got[1].cpu().numpy(), found),
          "score_traces returns kernel C's winners")
    c_ms = time_ms(kernel, 10)
    twin_ms = time_ms(twin, 2)
    mm_best = matmul_form(contrib, invalid, *table)
    mm_differ = int((mm_best != got[0])[got[1]].sum())
    mm_ms = time_ms(lambda: matmul_form(contrib, invalid, *table), 3)
    nbytes = (contrib.numel() * 4 + invalid.numel() + S * F + S +
              T * (4 + 1 + 4))
    c_bound, c_by = bound(nbytes, T * S * F)
    c_med = statistics.median(c_ms)

    # score_chunk_device: everything stays on the card (float32 log there).
    ints_dev = torch.from_numpy(ints.astype(np.float32)).to(dev)
    counts_dev = torch.from_numpy(cats).to(dev)
    v8_score_fused.launches = 0
    chunk_out = ln.score_chunk_device(ints_dev, counts_dev, table, lfm_dev,
                                      V8_BETA_SIGMA, float(V8_MAX_DEVIATION))
    chunk_launches = v8_score_fused.launches
    check(all(o.device.type == "cuda" for o in chunk_out) and
          chunk_launches == 1, "score_chunk_device keeps its results on the "
          f"card and launches kernel C once ({chunk_launches})")
    chunk_same = float((chunk_out[0] == got[0]).float().mean())
    check(chunk_same > 0.999 and torch.equal(chunk_out[1], got[1]),
          f"score_chunk_device's winners against score_traces': {chunk_same}")
    chunk_ms = time_ms(lambda: ln.score_chunk_device(
        ints_dev, counts_dev, table, lfm_dev, V8_BETA_SIGMA,
        float(V8_MAX_DEVIATION)), 5)
    prep_ms = time_ms(lambda: ln._contrib_invalid(
        torch.from_numpy(log_int[:ln.CUDA_CHUNK]).to(dev),
        torch.from_numpy(cats[:ln.CUDA_CHUNK]).to(dev), lfm_dev,
        V8_BETA_SIGMA, float(V8_MAX_DEVIATION)), 5)
    del contrib, invalid, got, ref, ints_dev, counts_dev, chunk_out

    # The per-trace float64 host oracle, and the CPU run.
    t = time.perf_counter()
    for i in range(V8_ORACLE):
        want = _intensities_to_signal_lognormal_v8(
            ints[i].tolist(), beta=V8_BETA, beta_sigma=V8_BETA_SIGMA,
            max_possible=K, allow_multidrop=True,
            max_deviation=V8_MAX_DEVIATION, categories=cats[i].tolist(),
            log_fluor_means=lfm.tolist())[2]
        have = tuple(int(v) for v in seqs[i]) if found[i] else None
        check(have == want, f"trace {i}: card {have}, host oracle {want}")
    oracle_s = (time.perf_counter() - t) / V8_ORACLE
    t = time.perf_counter()
    on_cpu = ln.score_traces(ints[:V8_CPU], cats[:V8_CPU], device="cpu", **kw)
    cpu_s = time.perf_counter() - t
    check(np.array_equal(on_cpu[0], seqs[:V8_CPU]) and
          np.array_equal(on_cpu[1], found[:V8_CPU]) and
          np.allclose(on_cpu[2], best_ls[:V8_CPU], rtol=1e-6, atol=0),
          "score_traces on the card against device='cpu'")
    walls = [r["wall_s"] for r in runs]
    numbers = {
        "shape": {"T": T, "F": F, "nv": K + 1, "S": S}, "max_abs_err": err_c,
        "ms": c_med, "plain_ms": statistics.median(twin_ms),
        "bound_ms": c_bound, "bound_by": c_by,
        "share_of_bound": c_bound / c_med,
        "matmul_composition_ms": statistics.median(mm_ms),
        "matmul_composition_winners_differing": mm_differ}
    emit("v8", **numbers, **ptxas["v8_score"], warmup_s=warm_s,
         wall_s_median=statistics.median(walls),
         traces_per_s=T / statistics.median(walls), runs=runs,
         launches_per_call=len(chunks), chunk=ln.CUDA_CHUNK,
         found_share=float(found.mean()), ms_runs=c_ms,
         plain_ms_runs=twin_ms, matmul_composition_ms_runs=mm_ms,
         mismatches_vs_twin=mismatches, bound_bytes=nbytes,
         bound_adds=T * S * F,
         contrib_invalid_ms_per_chunk=statistics.median(prep_ms),
         score_chunk_device={"ms_median": statistics.median(chunk_ms),
                             "launches": chunk_launches,
                             "winners_equal_to_score_traces": chunk_same},
         equal_to_host_oracle=V8_ORACLE, host_oracle_s_per_trace=oracle_s,
         card_vs_cpu={"traces": V8_CPU, "cpu_s": cpu_s,
                      "max_abs_score_diff": float(np.abs(
                          on_cpu[2] - best_ls[:V8_CPU]).max())},
         note="wall = score_traces from host float64 arrays to host "
              "results; ms = kernel C alone on resident contributions, its "
              "launches per call back to back (CUDA events, median of 10); "
              "plain_ms = the twin in chunks of V8_TWIN_CHUNK; the matmul "
              "form is a composition of library calls (two float32 "
              "products and a masked argmax in chunks of V8_MATMUL_CHUNK), "
              "not one call, and nothing in the port calls it")

    # A synthetic track CSV through Pipeline.fluor_counts, both ingestion
    # paths, against device="cpu".
    # The subcommand's configuration: multidrop allowed, as the reference
    # fitter's default.
    cfg = PipelineConfig(lognormal=LognormalConfig(max_possible=K,
                                                   allow_multidrop=True))
    pipe = Pipeline(cfg, device=dev, profile=True)
    cpu_pipe = Pipeline(cfg, device="cpu")
    launches = {"v8": runs[0]["launches"]}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tracks.csv")
        t = time.perf_counter()
        write_v8_tracks_csv(path, *make_v8_workload(FC_ROWS, F, K, seed=1)[:2])
        write_s = time.perf_counter() - t
        fit_kw = dict(beta=V8_BETA, beta_sigma=V8_BETA_SIGMA)
        pipe.fluor_counts(path, **fit_kw)
        fc_runs = []
        for _ in range(FC_REPS):
            profiling.reset_timings()
            v8_score_fused.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            fit = pipe.fluor_counts(path, **fit_kw)
            torch.cuda.synchronize()
            fc_runs.append({
                "wall_s": time.perf_counter() - t,
                "launches": {"v8_score": v8_score_fused.launches},
                "stage_s": profiling.timings()["api/fluor_counts"]["total"]})
        launches["fluor_counts"] = fc_runs[0]["launches"]
        check(all(r["launches"]["v8_score"] == 1 for r in fc_runs),
              f"fluor_counts launched kernel C once: {fc_runs}")
        # The pieces of the arrays path, each alone.
        t = time.perf_counter()
        arrs = read_track_photometries_arrays(path)
        parse_s = time.perf_counter() - t
        t = time.perf_counter()
        ln.score_traces(arrs["intensities"].astype(np.float64),
                        arrs["categories"], device=dev, **kw)
        score_s = time.perf_counter() - t
        t = time.perf_counter()
        photometries, _ = read_track_photometries_csv(path)
        dict_read_s = time.perf_counter() - t
        v8_score_fused.launches = 0
        t = time.perf_counter()
        via_dict = pipe.fluor_counts(photometries, **fit_kw)
        dict_fit_s = time.perf_counter() - t
        launches["fluor_counts_dict"] = {"v8_score": v8_score_fused.launches}
        t = time.perf_counter()
        on_cpu = cpu_pipe.fluor_counts(path, **fit_kw)
        cpu_s = time.perf_counter() - t
        check(fit[1] == FC_ROWS and fit[:3] == via_dict[:3] == on_cpu[:3]
              and sorted(fit[3]) == sorted(via_dict[3]) and
              [i[:11] for i in fit[3]] == [i[:11] for i in on_cpu[3]],
              f"fluor_counts: arrays path {fit[1:3]}, dict path "
              f"{via_dict[1:3]}, CPU {on_cpu[1:3]}")
        check(fit[2] < 0.05 * FC_ROWS and launches["fluor_counts_dict"] ==
              {"v8_score": 1}, f"{fit[2]} of {FC_ROWS} traces unfit")

        # The calibrated flow on the same CSV.
        v8_score_fused.launches = 0
        t = time.perf_counter()
        cal = pipe.fluor_counts_calibrated(path)
        cal_s = time.perf_counter() - t
        launches["fluor_counts_calibrated"] = {
            "v8_score": v8_score_fused.launches}
        t = time.perf_counter()
        cal_cpu = cpu_pipe.fluor_counts_calibrated(path)
        cal_cpu_s = time.perf_counter() - t
        check(cal[4] == cal_cpu[4] and cal[:3] == cal_cpu[:3] and
              launches["fluor_counts_calibrated"] == {"v8_score": 2},
              f"fluor_counts_calibrated: card {cal[1:3]}, {cal[4]}; CPU "
              f"{cal_cpu[1:3]}, {cal_cpu[4]}")
        check(abs(cal[4]["beta"] - V8_BETA) < 0.1 * V8_BETA,
              f"recovered beta {cal[4]['beta']}")

        # The experiment's own track CSV: not lognormal ladders, so it must
        # run and equal the CPU run, no more.
        if experiment_csv is None:
            small = np.clip(make_experiment_stack(**EXP_SMALL), 0,
                            65535).astype(np.uint16)
            exp_path = os.path.join(tmp, "experiment.csv")
            Pipeline(device=dev).run_experiment(
                small, max_candidates=EXP_SMALL_K, csv_path=exp_path)
            with open(exp_path) as fh:
                experiment_csv = fh.read()
        exp_path = os.path.join(tmp, "experiment.csv")
        with open(exp_path, "w") as fh:
            fh.write(experiment_csv)
        exp_arrs = read_track_photometries_arrays(exp_path)
        on = exp_arrs["intensities"][exp_arrs["categories"]]
        exp_kw = dict(beta=float(np.median(on)), beta_sigma=0.3)
        v8_score_fused.launches = 0
        exp_fit = pipe.fluor_counts(exp_path, **exp_kw)
        launches["fluor_counts_experiment_csv"] = {
            "v8_score": v8_score_fused.launches}
        exp_cpu = cpu_pipe.fluor_counts(exp_path, **exp_kw)
        # Rows whose rounded (field, h, w) collide count once (first wins).
        check(0 < exp_fit[1] <= len(exp_arrs["channels"]) and
              exp_fit[:3] == exp_cpu[:3] and
              launches["fluor_counts_experiment_csv"]["v8_score"] >= 1,
              f"the experiment's track CSV: card {exp_fit[1:3]}, CPU "
              f"{exp_cpu[1:3]}")
        fc_walls = [r["wall_s"] for r in fc_runs]
        emit("fluor_counts", rows=FC_ROWS, frames=F, max_possible=K,
             csv_write_s=write_s, wall_s_median=statistics.median(fc_walls),
             traces_per_s=FC_ROWS / statistics.median(fc_walls),
             runs=fc_runs, none_count=fit[2], distinct_signals=len(fit[0]),
             pieces_s={"native_parse": parse_s, "score_traces": score_s,
                       "rest_dedupe_meta_decode":
                           statistics.median(fc_walls) - parse_s - score_s},
             dict_path={"read_s": dict_read_s, "fit_s": dict_fit_s},
             cpu_s=cpu_s, launches=launches,
             calibrated={"wall_s": cal_s, "cpu_s": cal_cpu_s,
                         "calibration": cal[4], "none_count": cal[2],
                         "traces": cal[1]},
             experiment_csv={"rows": len(exp_arrs["channels"]),
                             "traces": exp_fit[1], "none_count": exp_fit[2],
                             "distinct_signals": len(exp_fit[0]), **exp_kw},
             note="wall = Pipeline.fluor_counts from a track CSV path to "
                  "(signals, total, none_count, fit_info); pieces_s are "
                  "the native parse and score_traces each run alone, and "
                  "what they leave of the median wall; all results equal "
                  "the device='cpu' run's")

        # The four subcommands, each in a process of its own.
        pkls = [os.path.join(tmp, f"signals_{i}.pkl") for i in range(3)]
        summary, cli_s = run_cli(
            ["fluor-counts", path, "--beta", str(V8_BETA), "--beta-sigma",
             str(V8_BETA_SIGMA), "--signals-pkl", pkls[0]])
        with open(pkls[0], "rb") as fh:
            check(pickle.load(fh) == fit[0] and
                  (summary["traces"], summary["none"],
                   summary["distinct_signals"]) == (fit[1], fit[2],
                                                    len(fit[0])),
                  f"fluor-counts prints and pickles the API's counts: "
                  f"{summary}")
        emit("cli", command="fluor-counts", traces=summary["traces"],
             none=summary["none"], wall_s=cli_s)
        summary, cli_s = run_cli(["fluor-counts", path, "--auto-calibrate"])
        check(summary["calibration"] == json.loads(json.dumps(cal[4])) and
              (summary["traces"], summary["none"]) == (cal[1], cal[2]),
              f"fluor-counts --auto-calibrate prints the API's "
              f"calibration: {summary}")
        emit("cli", command="fluor-counts --auto-calibrate",
             traces=summary["traces"], calibration=summary["calibration"],
             wall_s=cli_s)
        for i in (1, 2):  # two control fits through the dict path
            c_ints, c_cats, _ = make_v8_workload(FC_CONTROL_ROWS, F, K,
                                                 seed=1 + i)
            control = {"ch1": {0: {
                (j, j): (tuple(c), tuple(x), j) for j, (c, x) in enumerate(
                    zip(c_cats.tolist(),
                        np.rint(c_ints).astype(np.int64).tolist()))}}}
            with open(pkls[i], "wb") as fh:
                pickle.dump(pipe.fluor_counts(control, **fit_kw)[0], fh)
        for argv in (
                # Signals up to cycle 8 without multidrop: the peak
                # finder's cost grows steeply with the signals it is given.
                ["background-correct", pkls[0], "--control-pkls", pkls[1],
                 pkls[2], "--num-cycles", str(F), "--omit-multidrop",
                 "--total", "8", "--control-total", "8"],
                ["remainder-correct", path, "--method", "4"]):
            out_dir = os.path.join(tmp, argv[0])
            extra = (["--output-dir", out_dir] if argv[0] ==
                     "background-correct" else
                     ["--output", os.path.join(tmp, "adjusted.csv")])
            summary, cli_s = run_cli(argv + extra)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                check(cli_main(argv + extra) == 0,
                      f"{argv[0]} in this process exits 0")
            check(summary == json.loads(buf.getvalue()),
                  f"{argv[0]}: the subcommand prints what this process "
                  f"computes: {summary}, {buf.getvalue()}")
            emit("cli", command=argv[0], wall_s=cli_s, **{
                k: v for k, v in summary.items() if k in (
                    "signals_in", "signals_out", "counts_in", "counts_out",
                    "rows", "method")})
    return {"launches": launches, "kernels": {"v8_score": numbers},
            "calibrated": {"result": cal, "wall_s": cal_s,
                           "launches": launches["fluor_counts_calibrated"]}}


def _tvd(a, b):
    """Total variation distance of two {value: count} histograms."""
    na, nb = sum(a.values()), sum(b.values())
    return 0.5 * sum(abs(a.get(k, 0) / na - b.get(k, 0) / nb)
                     for k in set(a) | set(b))


def _hist(*cols):
    return collections.Counter(zip(*(np.asarray(c).tolist() for c in cols)))


def sim_phases(tmpl, dev, ptxas):
    """Simulation and the Monte-Carlo detector on the card: config 5's
    simulation half (``bench.py::bench_simulation``: 100,000 molecules of
    the two-colour 18-mer, 12 count cycles) and its simulate -> fit chain
    (``bench_sim_fit``: kernel C), the native signal sampler, frame 0 of
    config 2 through ``find_peptides(fit_type="monte_carlo")`` (kernels A
    and D; D against its twin bit for bit, beside its bound), the card
    against the CPU on identical draws, and the ``simulate`` subcommand in
    a process of its own. Emits the "simulation", "sim_fit",
    "simulate_signals", "mc_detect" and "cli" lines; returns the kernels'
    launches on each path and their numbers."""
    import pickle

    from fluorosequencingimageanalysis_torch.api import Pipeline
    from fluorosequencingimageanalysis_torch.inference.lognormal import (
        photometries_lognormal_fit_v8)
    from fluorosequencingimageanalysis_torch.models import detect
    from fluorosequencingimageanalysis_torch.ops.candidates import (
        find_candidates, gather_patches)
    from fluorosequencingimageanalysis_torch.ops.consolidate import (
        consolidate)
    from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
        candidate_map_fused, candidate_map_plain)
    from fluorosequencingimageanalysis_torch.ops.fused_lognormal import (
        v8_score_fused)
    from fluorosequencingimageanalysis_torch.ops.fused_mc_fit import mc_fit
    from fluorosequencingimageanalysis_torch.ops.mc_fit import (
        mc_fit_plain, normalise_patches, sample_params)
    from fluorosequencingimageanalysis_torch.sim import dye_sim
    from fluorosequencingimageanalysis_torch.sim.events import (
        simulate_dye_counts)
    from fluorosequencingimageanalysis_torch.utils.synth import make_zstack

    seq, labels2, n = SIM_SEQ, {"C", "K"}, SIM_N
    n_cycles = SIM_MOCKS + SIM_EDMANS
    sim_kw = dict(num_mocks=SIM_MOCKS, num_edmans=SIM_EDMANS, **SIM_PARAMS)

    # -- simulation: bench_simulation's workload, intensities as float32.
    def simulate(seed):
        counts, _ = dye_sim.simulate_dye_counts_batched(
            seq, labels2, num_simulations=n, seed=seed, device_out=True,
            device=dev, **sim_kw)
        intens = [dye_sim.simulate_photometries_batched(
                      counts[:, :, k], SIM_BETA, SIM_BETA_SIGMA,
                      seed=seed + 7919 * (k + 1), ddif=SIM_DDIF,
                      device_out=True) for k in range(2)]
        return counts, intens

    def simulate_and_fetch(seed):
        counts, intens = simulate(seed)
        return counts.cpu().numpy(), [i.cpu().numpy() for i in intens]

    simulate_and_fetch(0)
    runs = []
    for rep in range(SIM_REPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        counts, intens = simulate_and_fetch(rep + 1)
        runs.append({"wall_s": time.perf_counter() - t,
                     "peak_mem_bytes": int(torch.cuda.max_memory_allocated())})
    walls = [r["wall_s"] for r in runs]
    check(counts.shape == (n, n_cycles + 1, 2) and counts.dtype == np.int32
          and (np.diff(counts, axis=1) <= 0).all(),
          "simulated counts are (N, cycles + 1, 2) int32 and never rise")
    check(all(x.dtype == np.float32 and x.shape == (n, n_cycles + 1) and
              np.array_equal(x == 0, counts[:, :, k] == 0) and
              np.isfinite(x).all() for k, x in enumerate(intens)),
          "intensities are finite float32, exactly 0 where a count is 0")
    device_ms = time_ms(lambda: simulate(9), 5)
    prof = profile_steps(lambda: simulate(9), 3)
    host = simulate_dye_counts(seq, labels2, num_simulations=SIM_HOST_SAMPLE,
                               random_seed=3, **sim_kw)
    host_counts = {a: np.array([r[1][a] for r in host]) for a in ("C", "K")}
    tvd = max(max(_tvd(_hist(counts[:, c, k]),
                       _hist(host_counts[a][:, c]))
                  for k, a in enumerate(("C", "K"))) for c in
              range(n_cycles + 1))
    joint_tvd = max(_tvd(_hist(counts[:, c, 0], counts[:, c, 1]),
                         _hist(host_counts["C"][:, c], host_counts["K"][:, c]))
                    for c in range(n_cycles + 1))
    check(tvd < SIM_TVD and joint_tvd < SIM_TVD,
          f"per-cycle count histograms against {SIM_HOST_SAMPLE} molecules "
          f"of the host event loop: TVD {tvd}, joint {joint_tvd}")
    # The card against the CPU on identical draws, made on the host.
    draws = dye_sim.draw_simulation(SIM_CPU_N, len(seq), n_cycles, 5, "cpu")
    normals = dye_sim.draw_normals((SIM_CPU_N, n_cycles + 1), 6, "cpu")
    color_ids = [0 if a == "C" else 1 if a == "K" else -1 for a in seq]
    model = dict(num_mocks=SIM_MOCKS, n_colors=2, p=SIM_PARAMS["p"],
                 per_cycle_b=math.exp(-SIM_PARAMS["b"]), u=SIM_PARAMS["u"],
                 s=SIM_PARAMS["s"], sc=SIM_PARAMS["sc"], s2=SIM_PARAMS["s2"])
    on_cpu = dye_sim.simulate_from_draws(draws, color_ids, **model)
    on_card = dye_sim.simulate_from_draws(
        dye_sim.SimDraws(*(d.to(dev) for d in draws)), color_ids, **model)
    check(all(torch.equal(a, b.cpu()) for a, b in zip(on_cpu, on_card)),
          "counts, loss cycles and duds on the card equal the CPU's on "
          "identical draws")
    phot = [dye_sim.photometries_from_normals(
                normals.to(c.device), c[:, :, 0], math.log(SIM_BETA),
                SIM_BETA_SIGMA, torch.tensor(SIM_DDIF, device=c.device)
            ).cpu().numpy() for c in (on_cpu[0], on_card[0])]
    phot_rel = float(np.max(np.abs(phot[1] - phot[0]) /
                            np.maximum(np.abs(phot[0]), 1e-30)))
    check(phot_rel <= 2e-6, f"photometries card vs CPU on identical normals: "
                            f"max rel {phot_rel}")
    emit("simulation", molecules=n, sequence=seq, labels=sorted(labels2),
         cycles=n_cycles + 1, wall_s_median=statistics.median(walls),
         molecules_per_s=n / statistics.median(walls), runs=runs,
         device_ms_median=statistics.median(device_ms),
         device_ms_runs=device_ms, device_ops_per_run=prof[
             "device_ops_per_step"], device_busy_share=prof[
             "device_busy_share"], top_device_us=prof["top_device_us"][:6],
         fetch_bytes=int(counts.nbytes + sum(x.nbytes for x in intens)),
         tvd_vs_host=tvd, joint_tvd_vs_host=joint_tvd,
         host_sample=SIM_HOST_SAMPLE, card_vs_cpu_molecules=SIM_CPU_N,
         photometry_card_vs_cpu_max_rel=phot_rel,
         note="wall = simulate_dye_counts_batched + both colours' "
              "simulate_photometries_batched on the card, then counts "
              "(int32) and intensities (float32) fetched to the host")
    del on_card, phot

    # -- sim_fit: bench_sim_fit's simulate -> fit chain (kernel C).
    fit_kw = dict(num_simulations=n, beta=SIM_BETA, beta_sigma=SIM_BETA_SIGMA,
                  ddif=SIM_DDIF, error_signals=False, device=dev, **sim_kw)
    dye_sim.simulate_and_fit_batched(seq, {"K"}, seed=0, **fit_kw)
    fit_runs = []
    for rep in range(SIM_REPS):
        torch.cuda.synchronize()
        v8_score_fused.launches = 0
        t = time.perf_counter()
        out = dye_sim.simulate_and_fit_batched(seq, {"K"}, seed=rep + 1,
                                               **fit_kw)
        torch.cuda.synchronize()
        fit_runs.append({"wall_s": time.perf_counter() - t, "launches": {
            "v8_score": v8_score_fused.launches}})
        check(sum(out["signals"].values()) + out["none_count"] ==
              out["total_count"] == n, "sum(signals) + none == N")
    from fluorosequencingimageanalysis_torch.ops import lognormal as ln
    check(all(r["launches"]["v8_score"] == -(-n // ln.CUDA_CHUNK)
              for r in fit_runs), f"kernel C once per chunk: {fit_runs}")
    # Chained = two-step on the card (the JAX package's closure test).
    two_n = SIM_FIT_TWO_STEP
    two_kw = dict(fit_kw, num_simulations=two_n, error_signals=True)
    chained = dye_sim.simulate_and_fit_batched(seq, {"K"}, seed=5, **two_kw)
    results = dye_sim.peptide_simulation_batched(
        seq, {"K"}, num_simulations=two_n, seed=5, beta=SIM_BETA,
        beta_sigma=SIM_BETA_SIGMA, ddif=SIM_DDIF, device=dev, **sim_kw)
    mes2 = collections.defaultdict(int)
    photometries = {"ch1": {0: {}}}
    for t_i, (decs, dye_counts, _, ci) in enumerate(results):
        category, (ints,) = ci["K"]
        photometries["ch1"][0][(t_i, t_i)] = (category, ints, t_i)
        s_k = dye_counts["K"]
        mes2[(decs, s_k[-1] == 0, s_k[0])] += 1
    signals2, total2, none2, _ = photometries_lognormal_fit_v8(
        photometries, SIM_BETA, SIM_BETA_SIGMA, max_possible=5,
        allow_upsteps=False, allow_multidrop=True, max_deviation=3,
        quench_factors=SIM_DDIF, device=dev)
    check((chained["signals"], chained["none_count"], chained["total_count"],
           chained["molecular_error_signals"]) ==
          (signals2, none2, total2, dict(mes2)),
          f"chained = two-step on the card at N = {two_n}")
    fit_walls = [r["wall_s"] for r in fit_runs]
    emit("sim_fit", molecules=n, labels=["K"],
         wall_s_median=statistics.median(fit_walls),
         molecules_per_s=n / statistics.median(fit_walls), runs=fit_runs,
         none_count=out["none_count"], distinct_signals=len(out["signals"]),
         two_step_equal_at=two_n)

    # -- simulate_signals: the native sampler into a trie (host work).
    pipe = Pipeline(device=dev)
    peptides = {"P1": ((seq, ""),), "P2": (("AKCAKDCKA", "KC"),)}
    windows = {"C": tuple(range(1, n_cycles + 1)),
               "K": tuple(range(1, n_cycles + 1))}
    args = (peptides, SIM_PARAMS["p"], SIM_PARAMS["b"], SIM_PARAMS["u"],
            windows)
    t = time.perf_counter()
    trie = pipe.simulate_signals(*args, sample_size=SIM_SIGNALS,
                                 random_seed=1)
    sig_s = time.perf_counter() - t
    leaves = sorted((sig, sorted(dict(c).items()))
                    for sig, c, _ in trie.leaf_iterator())
    again = sorted((sig, sorted(dict(c).items())) for sig, c, _ in
                   pipe.simulate_signals(*args, sample_size=SIM_SIGNALS,
                                         random_seed=1).leaf_iterator())
    total = sum(v for _, counts in leaves for _, v in counts)
    check(leaves == again and 0 < total <= 2 * SIM_SIGNALS,
          f"simulate_signals is seeded and fills a trie ({total} signals)")
    emit("simulate_signals", samples=2 * SIM_SIGNALS, wall_s=sig_s,
         samples_per_s=2 * SIM_SIGNALS / sig_s, leaves=len(leaves),
         signals=total, cpu=cpu_model(), threads=os.cpu_count())

    # -- mc_detect: frame 0 of config 2 through the Monte-Carlo detector.
    frames, truth = make_zstack(Z_T, HW, HW, n_spots=800, seed=4,
                                return_truth=True)
    frame = frames[0]
    mc_kw = dict(fit_type="monte_carlo", N_iter=MC_N_ITER)
    detect.find_peptides(frame, max_candidates=MC_K, **mc_kw)
    mc_runs = []
    for rep in range(SIM_REPS):
        torch.cuda.synchronize()
        candidate_map_fused.launches = 0
        mc_fit.launches = 0
        consolidate.launches = 0
        t = time.perf_counter()
        psfs = detect.find_peptides(frame, max_candidates=MC_K, **mc_kw)
        torch.cuda.synchronize()
        mc_runs.append({"wall_s": time.perf_counter() - t, "launches": {
            "candidate_map": candidate_map_fused.launches,
            "mc_fit": mc_fit.launches,
            "consolidate": consolidate.launches}, "psfs": len(psfs)})
    check(all(r["launches"] == {"candidate_map": 1, "mc_fit": 1,
                                "consolidate": 1}
              for r in mc_runs), f"one launch each of A, D and F (the "
                                 f"window gate): {mc_runs}")
    candidate_map_fused.launches = 0
    mc_fit.launches = 0
    consolidate.launches = 0
    t = time.perf_counter()
    psfs_default = detect.find_peptides(frame, **mc_kw)  # the 4096 cap
    torch.cuda.synchronize()
    default_s = time.perf_counter() - t
    default_launches = {"candidate_map": candidate_map_fused.launches,
                        "mc_fit": mc_fit.launches,
                        "consolidate": consolidate.launches}
    check(default_launches == {"candidate_map": 1, "mc_fit": 1,
                               "consolidate": 1},
          f"the capped call launches A, D and F once: {default_launches}")
    # Recovery (reported, not gated): isolated planted spots with a kept
    # Monte-Carlo fit whose model peak (center + 0.5, the p + h - 2.5
    # convention) lies within MC_WITHIN_PX.
    peaks = np.array([(v[0] + 0.5, v[1] + 0.5) for v in psfs.values()])
    d_truth = np.sqrt(((truth[:, None, :] - truth[None, :, :]) ** 2)
                      .sum(-1)) + np.eye(len(truth)) * 1e9
    isolated = truth[d_truth.min(axis=1) > ISOLATED_PX]
    near = np.sqrt(((isolated[:, None, :] - peaks[None, :, :]) ** 2)
                   .sum(-1)).min(axis=1) <= MC_WITHIN_PX
    check(len(psfs) > 300 and all(np.isfinite(v[:7]).all() and
                                  v[7].shape == v[8].shape == (5, 5)
                                  for v in psfs.values()),
          f"finite Monte-Carlo psfs of the reference's shape ({len(psfs)})")
    # Kernel D alone at this path's shapes, against its twin.
    img = torch.from_numpy(frame.astype(np.float32)).to(dev)
    hs, ws, valid, count = find_candidates(img, max_candidates=MC_K)
    patches = normalise_patches(gather_patches(img, hs, ws))
    samples = sample_params(patches, detect.draw_mc_normals(
        MC_N_ITER, MC_K, 0, dev)).contiguous()
    got = mc_fit(patches, samples)
    ref = mc_fit_plain(patches, samples)
    torch.cuda.synchronize()
    diff = {"params": int((got[0].view(torch.int32) !=
                           ref[0].view(torch.int32)).any(dim=1).sum()),
            "norm": int((got[1].view(torch.int32) !=
                         ref[1].view(torch.int32)).sum())}
    finite = torch.isfinite(ref[1])
    err_d = float((got[1] - ref[1])[finite].abs().max())
    check(not any(diff.values()) and err_d == 0.0,
          f"kernel D vs twin on all {MC_K} candidates x {MC_N_ITER} samples: "
          f"{diff}")
    d_ms = time_ms(lambda: mc_fit(patches, samples), 10)
    d_plain = time_ms(lambda: mc_fit_plain(patches, samples), 2)
    d_bytes = samples.numel() * 4 + patches.numel() * 4 + MC_K * 7 * 4
    d_bound, d_by = bound(d_bytes, MC_K * MC_N_ITER * 25 * D_OPS_PER_PIXEL)
    d_med = statistics.median(d_ms)
    # Kernel A at this path's shape (one 512x512 frame).
    one = img[None]
    err_a = float((candidate_map_fused(one, tmpl) -
                   candidate_map_plain(one, tmpl)).abs().max())
    check(err_a == 0.0, f"kernel A vs twin at {tuple(one.shape)}: {err_a}")
    a_ms = time_ms(lambda: candidate_map_fused(one, tmpl), 20)
    a_plain = time_ms(lambda: candidate_map_plain(one, tmpl), 5)
    a_bound, a_by = bound(2 * one.numel() * 4, one.numel() * A_OPS_PER_PIXEL)
    del samples, got, ref
    # The card against the CPU on identical draws, on a reduced crop.
    crop = torch.from_numpy(frame[:MC_CPU_HW, :MC_CPU_HW].astype(np.float32))
    z = torch.randn((6, MC_CPU_ITER, MC_CPU_K),
                    generator=torch.Generator().manual_seed(0))
    small = dict(max_candidates=MC_CPU_K, n_iter=MC_CPU_ITER, normals=z)
    card = detect._detect_and_fit_monte_carlo(crop.to(dev), **small)
    cpu = detect._detect_and_fit_monte_carlo(crop, **small)
    same_cands = all(torch.equal(getattr(card, f).cpu(), getattr(cpu, f))
                     for f in ("cand_h", "cand_w", "cand_valid",
                               "cand_count"))
    v = cpu.cand_valid
    param_share = float(torch.isclose(card.params.cpu(), cpu.params,
                                      rtol=1e-5, atol=1e-5).all(dim=1)[v]
                        .float().mean())
    keep_differ = int((card.keep.cpu() != cpu.keep).sum())
    check(same_cands and param_share > 0.98 and
          keep_differ <= 0.01 * int(v.sum()),
          f"card vs CPU on identical draws: candidates equal {same_cands}, "
          f"params equal on {param_share}, keep differs on {keep_differ}")
    mc_walls = [r["wall_s"] for r in mc_runs]
    d_numbers = {"shape": {"K": MC_K, "n_iter": MC_N_ITER},
                 "max_abs_err": err_d, "ms": d_med,
                 "plain_ms": statistics.median(d_plain), "bound_ms": d_bound,
                 "bound_by": d_by, "share_of_bound": d_bound / d_med}
    a_numbers = {"shape": list(one.shape), "max_abs_err": err_a,
                 "ms": statistics.median(a_ms),
                 "plain_ms": statistics.median(a_plain), "bound_ms": a_bound,
                 "bound_by": a_by,
                 "share_of_bound": a_bound / statistics.median(a_ms)}
    emit("mc_detect", shape=list(frame.shape), candidates=int(count),
         max_candidates=MC_K, n_iter=MC_N_ITER,
         wall_s_median=statistics.median(mc_walls), runs=mc_runs,
         kept_psfs=len(psfs), default_cap={
             "max_candidates": 4096, "wall_s": default_s,
             "kept_psfs": len(psfs_default), "launches": default_launches},
         isolated_planted=int(len(isolated)),
         isolated_within_px_share=float(near.mean()),
         within_px=MC_WITHIN_PX, kernel_d={
             **d_numbers, **ptxas["mc_fit"], "ms_runs": d_ms,
             "plain_ms_runs": d_plain, "bound_bytes": d_bytes,
             "mismatches_vs_twin": diff, "exp_per_sample": 25,
             "note": "25 expf a sample run on the special-function unit"},
         kernel_a=a_numbers, card_vs_cpu={
             "crop": MC_CPU_HW, "max_candidates": MC_CPU_K,
             "n_iter": MC_CPU_ITER, "candidates_equal": same_cands,
             "params_equal_share": param_share, "keep_differing": keep_differ})

    # -- cli: the simulate subcommand in a process of its own.
    with tempfile.TemporaryDirectory() as tmp:
        pkl = os.path.join(tmp, "sims.pkl")
        argv = ["simulate", seq, "K", "--num-sims", str(CLI_SIM_N),
                "--num-mocks", str(SIM_MOCKS), "--num-edmans",
                str(SIM_EDMANS), "--fluor-intensity", str(SIM_BETA),
                "--edman-efficiency", "0.9", "--dye-destruction", "0.1",
                "--dud-dyes", "0.5", "--surface-degradation-1", "0.3",
                "--surface-degradation-1-num-cycles", "4",
                "--surface-degradation-2", "0.1", "--ddif", "0.3",
                "--results-pkl", pkl]
        summary, cli_s = run_cli(argv)
        with open(pkl, "rb") as fh:
            sims = pickle.load(fh)
        api = dye_sim.peptide_simulation_batched(
            seq, "K", num_simulations=CLI_SIM_N, seed=0, beta=SIM_BETA,
            beta_sigma=SIM_BETA_SIGMA, ddif=(0.0,) + (0.3,) * seq.count("K"),
            device=dev, **sim_kw)
        check(summary["simulations"] == len(sims) == CLI_SIM_N and
              [s[:2] for s in sims] == [s[:2] for s in api],
              f"simulate pickles the API's molecules: {summary}")
    emit("cli", command="simulate", simulations=summary["simulations"],
         distinct_patterns=summary["distinct_patterns"], wall_s=cli_s)
    apps = inference_apps_phase(dev)
    return {"launches": {"mc_detect": mc_runs[0]["launches"],
                         "mc_detect_default": default_launches,
                         "sim_fit": fit_runs[0]["launches"], **apps},
            "kernels": {"mc_fit": {"mc_detect": d_numbers},
                        "candidate_map": {"mc_detect": a_numbers}}}


def inference_apps_phase(dev):
    """The reference's four inference apps as the port's compat copies,
    each through its ``main`` in this process: simulate_peptide at config
    5's simulation parameters (one colour, K) with the batched simulation
    on the card, against the chained simulate -> fit of the same draws
    (the app's seed is the clock's, pinned here); lognormal_fitter_v2 on
    config 5's 20,000-row track CSV with its beta given and no ON/OFF
    adjustment, its signals against ``Pipeline.fluor_counts`` on that CSV
    with the app's alpha; then the host apps iterative_background_v2 (the
    app's signals against two control fits, up to cycle 8 without
    multidrop, as the background-correct phase restricts them) and
    remainder_correction. Emits "inference_apps"; returns kernel C's
    launches in each device app."""
    import pickle

    from fluorosequencingimageanalysis_torch import _device
    from fluorosequencingimageanalysis_torch.api import Pipeline
    from fluorosequencingimageanalysis_torch.compat import (
        iterative_background_v2, lognormal_fitter_v2, remainder_correction,
        simulate_peptide)
    from fluorosequencingimageanalysis_torch.config import (LognormalConfig,
                                                            PipelineConfig)
    from fluorosequencingimageanalysis_torch.ops.fused_lognormal import (
        v8_score_fused)
    from fluorosequencingimageanalysis_torch.sim import dye_sim
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_v8_workload)

    epoch = 1_700_000_000.0
    out, launches = {}, {}
    ddif = (0.0,) + (0.30,) * 6
    with tempfile.TemporaryDirectory() as tmp:
        # simulate_peptide: 3 imaged mocks (4 - 1 omitted) and 8 Edmans.
        argv = [SIM_SEQ, "K", "-N", str(SIM_N), "-m", str(SIM_MOCKS + 1),
                "-o", "1", "-e", str(SIM_EDMANS), "--edman_efficiency",
                str(SIM_PARAMS["p"]), "--dye_destruction", "0.1",
                "--dud_dyes", str(SIM_PARAMS["u"]),
                "--surface_degradation_1", str(SIM_PARAMS["s"]),
                "--surface_degradation_1_num_cycles", str(SIM_PARAMS["sc"]),
                "--surface_degradation_2", str(SIM_PARAMS["s2"]),
                "--fluor_intensity", str(SIM_BETA), "--beta_sigma",
                str(SIM_BETA_SIGMA), "--batched_simulation", "on",
                "--no_csv", "--output_directory", os.path.join(tmp, "sim"),
                "--device", str(dev)]
        clock = simulate_peptide.time
        simulate_peptide.time = lambda: epoch
        try:
            torch.cuda.synchronize()
            v8_score_fused.launches = 0
            t = time.perf_counter()
            signals, _ = simulate_peptide.main(argv)
            torch.cuda.synchronize()
            sim_s = time.perf_counter() - t
            launches["inference_apps_simulate_peptide"] = {
                "v8_score": v8_score_fused.launches}
        finally:
            simulate_peptide.time = clock
        chained = dye_sim.simulate_and_fit_batched(
            SIM_SEQ, {"K"}, num_mocks=SIM_MOCKS, num_edmans=SIM_EDMANS,
            num_simulations=SIM_N, seed=round(epoch) % (2 ** 31),
            beta=SIM_BETA, beta_sigma=SIM_BETA_SIGMA, ddif=SIM_DDIF,
            device=dev, **{k: v for k, v in SIM_PARAMS.items()})["signals"]
        tot_a, tot_c = sum(signals.values()), sum(chained.values())
        tvd = 0.5 * sum(abs(signals.get(k, 0) / tot_a -
                            chained.get(k, 0) / tot_c)
                        for k in set(signals) | set(chained))
        out["simulate_peptide"] = {
            "molecules": SIM_N, "wall_s": sim_s, "signals": tot_a,
            "distinct_signals": len(signals), "tvd_vs_chained": tvd,
            "equal_to_chained": signals == chained,
            "launches": launches["inference_apps_simulate_peptide"]}

        # lognormal_fitter_v2 on config 5's track CSV.
        path = os.path.join(tmp, "tracks.csv")
        ints, cats, _ = make_v8_workload(FC_ROWS, V8_F, V8_K, seed=1)
        write_v8_tracks_csv(path, ints, cats)
        argv = [path, "--device", str(dev), "--no_adjustment", "--beta",
                str(V8_BETA), "--beta_sigma", str(V8_BETA_SIGMA), "-m",
                "4", "-o", "0", "-e", str(V8_F - 4)]
        clock = lognormal_fitter_v2.time
        lognormal_fitter_v2.time = lambda: epoch
        try:
            torch.cuda.synchronize()
            v8_score_fused.launches = 0
            t = time.perf_counter()
            fitted = lognormal_fitter_v2.main(argv)
            torch.cuda.synchronize()
            ln_s = time.perf_counter() - t
            launches["inference_apps_lognormal_fitter_v2"] = {
                "v8_score": v8_score_fused.launches}
        finally:
            lognormal_fitter_v2.time = clock
        stem = next(n for n in os.listdir(tmp)
                    if n.endswith("_INTERMEDIATES_v2.pkl"))
        with open(os.path.join(tmp, stem), "rb") as fh:
            (alpha, beta, _, _), _, _ = pickle.load(fh)
        cfg = PipelineConfig(lognormal=LognormalConfig(
            max_possible=5, allow_multidrop=True, max_deviation=3))
        want = Pipeline(cfg, device=dev).fluor_counts(
            path, V8_BETA, V8_BETA_SIGMA, quench_factors=ddif,
            alpha_adjust=alpha, downstep_filtered=True)[0]
        out["lognormal_fitter_v2"] = {
            "rows": FC_ROWS, "wall_s": ln_s, "alpha": alpha, "beta": beta,
            "signals": sum(fitted.values()), "distinct_signals": len(fitted),
            "equal_to_fluor_counts": fitted == want,
            "launches": launches["inference_apps_lognormal_fitter_v2"]}

        # The host apps.
        sig_pkl = os.path.join(tmp, stem.replace("INTERMEDIATES_v2",
                                                 "SIGNALS"))
        ac_rows = ["index,filepath"]
        for i in (1, 2):
            c_ints, c_cats, _ = make_v8_workload(FC_CONTROL_ROWS, V8_F,
                                                 V8_K, seed=1 + i)
            control = {"ch1": {0: {
                (j, j): (tuple(c), tuple(x), j) for j, (c, x) in enumerate(
                    zip(c_cats.tolist(),
                        np.rint(c_ints).astype(np.int64).tolist()))}}}
            pkl = os.path.join(tmp, f"control_{i}.pkl")
            with open(pkl, "wb") as fh:
                pickle.dump(Pipeline(cfg, device=dev).fluor_counts(
                    control, V8_BETA, V8_BETA_SIGMA,
                    quench_factors=ddif)[0], fh)
            ac_rows.append(f"{i},{pkl}")
        ac_csv = os.path.join(tmp, "controls.csv")
        with open(ac_csv, "w") as fh:
            fh.write("\n".join(ac_rows) + "\n")
        t = time.perf_counter()
        corrected = iterative_background_v2.main([
            "--boc_file", sig_pkl, "--ac_file", ac_csv, "--num_cycles",
            str(V8_F), "--omit_multidrop", "--boc_total", "8", "--ac_total",
            "8", "--output_directory", os.path.join(tmp, "background")])
        out["iterative_background_v2"] = {
            "wall_s": time.perf_counter() - t,
            "signals_out": len(corrected)}
        t = time.perf_counter()
        adjusted = remainder_correction.main([path, "--method", "4"])
        with open(adjusted) as fh:
            n_rows = sum(1 for _ in fh) - 1
        out["remainder_correction"] = {"wall_s": time.perf_counter() - t,
                                       "rows": n_rows}
    _device.set_default_device(None)
    emit("inference_apps", **out,
         note="each app's main() in this process, --device set to the "
              "card for the two that reach it; simulate_peptide's clock "
              "pinned so that its seed is the chained run's")
    sp, lf = out["simulate_peptide"], out["lognormal_fitter_v2"]
    check(sp["tvd_vs_chained"] <= SIM_TVD and sp["launches"]["v8_score"] >= 1,
          f"simulate_peptide's signals within TVD {SIM_TVD} of the chained "
          f"simulate -> fit, kernel C launched: {sp}")
    check(lf["equal_to_fluor_counts"] and lf["launches"]["v8_score"] >= 1,
          f"lognormal_fitter_v2's signals are Pipeline.fluor_counts': {lf}")
    check(out["iterative_background_v2"]["signals_out"] > 0 and
          out["remainder_correction"]["rows"] == FC_ROWS,
          f"the host apps ran: {out}")
    return launches


def bound_e(groups_n, ks, n_init, n_iter, nbytes):
    """Kernel E's least time (ms) and what sets it: bytes over the memory
    rate, float32 operations over the float32 rate, or special-function
    operations (the k exps and one log a point, model and pass) over the
    special-function rate, whichever is longest. The work is counted over
    each group's valid points, each model's active components and
    ``n_iter`` + 1 passes."""
    passes = n_iter + 1
    comps = sum(ks) * n_init                 # active components a group
    models = len(ks) * n_init
    points = float(sum(groups_n))
    f32 = passes * points * (E_OPS_PER_COMPONENT * comps +
                             E_OPS_PER_MODEL * models)
    sfu = passes * points * (comps + models)
    times = {"bytes": nbytes / PEAK_BYTES_S * 1e3,
             "float32": f32 / PEAK_F32_FLOPS * 1e3,
             "special_function": sfu / PEAK_SFU_OPS * 1e3}
    by = max(times, key=times.get)
    return times[by], ("bytes" if by == "bytes" else "operations"), by, \
        {"float32_ops": f32, "special_function_ops": sfu, "times_ms": times}


def sklearn_selection(GaussianMixture, small, card_scores, dev):
    """The BIC-selected k against scikit-learn's kmeans-seeded selection
    (``GaussianMixture``: scikit-learn's where it is importable, else the
    port's, ops/mixture.py, on the default device, the card):
    per cycle of the small photometries (reported: the ladder's levels
    overlap, and sklearn's seeding reaches optima that the batched EM's
    quantile seeding, the JAX package's, may not), and over the JAX
    package's sweep of 18 seeded mixtures (tests/test_gmm_batch.py:
    test_bic_model_selection_agreement_sweep, gated as there: at most 2
    different selections, each where sklearn's own BICs of the two tie
    within 0.1%)."""
    from fluorosequencingimageanalysis_torch.inference.gmm import (
        _collect_raw)
    from fluorosequencingimageanalysis_torch.ops.gmm_batch import (
        gmm_fit_batched)

    def sk_bics(x, ks, n_init, seed):
        X = x.reshape(-1, 1)
        return np.array([GaussianMixture(
            n_components=k, n_init=n_init, max_iter=GMM_N_ITER,
            random_state=seed).fit(X).bic(X) for k in ks])

    ks = list(GMM_KS)
    per_cycle = []
    for c, (_, nf, _, _) in sorted(card_scores.items()):
        bics = sk_bics(np.asarray(_collect_raw(small, c), np.float64), ks,
                       GMM_N_INIT, 0)
        per_cycle.append({"k": nf + 1, "sklearn_k": ks[int(bics.argmin())],
                          "sklearn_bic_margin": float(
                              (bics[ks.index(nf + 1)] - bics.min()) /
                              abs(bics.min()))})
    rng = np.random.default_rng(7)
    ks, flips = [1, 2, 3, 4], []
    for trial in range(18):
        true_k = int(rng.integers(1, 4))
        sep = rng.uniform(2.2, 6.0)
        means = np.cumsum(rng.uniform(sep, sep + 2, true_k)) * 1000.0
        sigmas = rng.uniform(300.0, 500.0, true_k)
        counts = rng.integers(400, 1400, true_k)
        x = np.concatenate([rng.normal(m, s, n)
                            for m, s, n in zip(means, sigmas, counts)])
        res = gmm_fit_batched([x], ks, n_init=4, n_iter=GMM_N_ITER,
                              seed=trial, device=dev)
        ours = ks[int(res["bic"][0].argmin())]
        bics = sk_bics(x, ks, 4, trial)
        if ours != ks[int(bics.argmin())]:
            flips.append({"trial": trial, "k": ours,
                          "sklearn_k": ks[int(bics.argmin())],
                          "margin": float(abs(bics[ks.index(ours)] -
                                              bics.min()) / abs(bics.min()))})
    check(len(flips) <= 2 and all(f["margin"] < 1e-3 for f in flips),
          f"BIC selection against sklearn over the sweep: {flips}")
    return {"available": True, "per_cycle": per_cycle, "sweep_trials": 18,
            "sweep_flips": flips}


def count_device_ops(fn):
    """``fn()`` and the number of aten operations it dispatched (each one
    launch or more on the card, a view none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def first_difference(a, b, rtol, path="out"):
    """Where two nested results differ (floats beyond ``rtol``, anything
    else at all, fitted mixtures in mean order), or None."""
    if hasattr(a, "means_"):
        oa, ob = (np.argsort(np.ravel(g.means_)) for g in (a, b))
        for name in ("weights_", "means_", "covariances_"):
            u, v = np.ravel(getattr(a, name)), np.ravel(getattr(b, name))
            u, v = (u, v) if u.size == 1 else (u[oa], v[ob])
            if u.shape != v.shape or not np.allclose(v, u, rtol=rtol,
                                                     atol=0):
                return f"{path}.{name}"
        if (a.n_iter_, a.converged_) != (b.n_iter_, b.converged_):
            return f"{path}.n_iter_"
        return None
    if isinstance(a, dict):
        if list(a) != list(b):
            return path + " keys"
        for k in a:
            d = first_difference(a[k], b[k], rtol, f"{path}[{k!r}]")
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            return path + " length"
        for i, (u, v) in enumerate(zip(a, b)):
            d = first_difference(u, v, rtol, f"{path}[{i}]")
            if d:
                return d
        return None
    if isinstance(a, np.ndarray) and a.dtype.kind == "f" or isinstance(
            a, (float, np.floating)):
        ok = np.shape(a) == np.shape(b) and np.allclose(
            b, a, rtol=rtol, atol=0, equal_nan=True)
        return None if ok else path
    return None if np.array_equal(a, b) else path


def _timed(module, name, store):
    """Replace ``module.name`` with a wrapper that adds its wall to
    ``store[name]``; returns the original."""
    import functools
    orig = getattr(module, name)

    @functools.wraps(orig)
    def timed(*args, **kwargs):
        t = time.perf_counter()
        outer, store["_in"] = store.get("_in"), name
        try:
            return orig(*args, **kwargs)
        finally:
            store["_in"] = outer
            store[name] = store.get(name, 0.0) + time.perf_counter() - t

    setattr(module, name, timed)
    return orig


def cluster_fit_phase(dev, phot):
    """The reference's cluster-fit sweep on the card: the mixtures cell's
    first SWEEP_T traces (noisy OFF frames, rounded) as a 20-field integer
    track CSV through ``compat.MCsimlib._parameter_sweep_2`` at its
    defaults (the pooled GMM selection over k 2-11, then
    ``_parallel_cluster_fit`` with ``_cluster_fit_2``'s 10 k-means
    restarts for each of 0-5 drops), its pickle written into a temporary
    directory. Reports the wall and its split, traces/s through
    ``_parallel_cluster_fit``, ``kmeans_batched``'s calls and device span
    in each stage (the cluster fit's, the mixtures' k-means starts), and
    the card against the CPU on the first SWEEP_SMALL_T traces. Emits
    "cluster_fit"; returns the pooled GMM's numbers for reference_gmm."""
    import pickle
    import types

    from fluorosequencingimageanalysis_torch import _device
    from fluorosequencingimageanalysis_torch.compat import MCsimlib
    from fluorosequencingimageanalysis_torch.inference import gmm as P
    from fluorosequencingimageanalysis_torch.ops import kmeans as pk

    rows = sorted((v[2], v[1], v[0]) for f in phot["ch1"].values()
                  for v in f.values())[:SWEEP_T]
    ints = np.array([r[1] for r in rows])
    cats = np.array([r[2] for r in rows])
    split, km = {}, {}
    orig_kb = pk.kmeans_batched

    def kb(*args, **kwargs):
        stage = km.setdefault(split.get("_in"), {"calls": 0,
                                                 "device_span_ms": 0.0})
        stage["calls"] += 1
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = orig_kb(*args, **kwargs)
        b.record()
        b.synchronize()
        stage["device_span_ms"] += a.elapsed_time(b)
        return out

    gmm_out = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sweep_tracks.csv")
        small_path = os.path.join(tmp, "sweep_small.csv")
        write_v8_tracks_csv(path, ints, cats)
        write_v8_tracks_csv(small_path, ints[:SWEEP_SMALL_T],
                            cats[:SWEEP_SMALL_T])
        saved = [(P, n, _timed(P, n, split)) for n in (
            "read_track_photometries_csv", "_gmm_photometries_MP",
            "_parallel_cluster_fit")]
        orig_mp = P._gmm_photometries_MP

        def mp(*args, **kwargs):
            out = orig_mp(*args, **kwargs)
            gmm_out["result"] = out
            return out

        P._gmm_photometries_MP = mp
        P.pickle = types.SimpleNamespace(
            dump=lambda *a, **k: split.__setitem__(
                "pickle", _pickle_dump_s(pickle, *a, **k)))
        pk.kmeans_batched = kb
        os.chdir(tmp)
        try:
            _device.set_default_device(dev)
            np.random.seed(0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            results, params = MCsimlib._parameter_sweep_2(
                path, fname_hash="_smoke")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            peak = int(torch.cuda.max_memory_allocated())
        finally:
            os.chdir(cwd)
            for mod, n, f in saved:
                setattr(mod, n, f)
            P.pickle = pickle
            pk.kmeans_batched = orig_kb
            _device.set_default_device(None)
        with open(os.path.join(tmp, "sweep_tracks.csv_smoke_results.pkl"),
                  "rb") as fh:
            saved_results = pickle.load(fh)
        cmp = {}
        for d in (dev, "cpu"):
            _device.set_default_device(d)
            os.chdir(tmp)
            try:
                np.random.seed(3)
                t = time.perf_counter()
                cmp[str(d)] = (MCsimlib._parameter_sweep_2(
                    small_path, fname_hash="_" + str(d).replace(":", "")),
                    time.perf_counter() - t)
            finally:
                os.chdir(cwd)
                _device.set_default_device(None)
    (card_res, _), card_s = cmp[str(dev)]
    (cpu_res, _), cpu_s = cmp["cpu"]
    differ = first_difference(cpu_res, card_res, REF_RTOL)
    fitted, collated, signals, indexed, all_indexed, none_fits = results
    fm, best_fit, best_nf, best_bic, all_fits, raw = gmm_out["result"]
    split.pop("_in", None)
    pcf = split["_parallel_cluster_fit"]
    line = dict(
        traces=SWEEP_T, cycles=ints.shape[1], wall_s=wall,
        split_s={"csv_read": split["read_track_photometries_csv"],
                 "gmm_fits": split["_gmm_photometries_MP"],
                 "parallel_cluster_fit": pcf,
                 "pickle": split.get("pickle"),
                 "rest": wall - sum(v for v in split.values())},
        cluster_fit_traces_per_s=SWEEP_T / pcf,
        kmeans_batched=dict(km, cluster_fit_fits=SWEEP_T * 6 * 10,
                            note="by stage: _parallel_cluster_fit's (one "
                                 "call a trace length and cluster count) "
                                 "and _gmm_photometries_MP's (one call a "
                                 "mixture: its restarts' starts); device "
                                 "span: CUDA events around each call, "
                                 "which ends in a host read"),
        peak_mem_bytes=peak, signals=sum(signals.values()),
        distinct_signals=len(signals), none_fits=len(none_fits),
        fitted=len(all_indexed), downstep_fits=len(indexed),
        params={k: v for k, v in params[-1].items()
                if isinstance(v, float)},
        pickle_items=len(saved_results),
        card_vs_cpu={"traces": SWEEP_SMALL_T, "card_s": card_s,
                     "cpu_s": cpu_s, "first_difference": differ,
                     "signals": [sum(card_res[2].values()),
                                 sum(cpu_res[2].values())]})
    emit("cluster_fit", **line)
    check(len(saved_results) == 5 and saved_results[0][2] == signals,
          "the sweep's pickle holds its results")
    check(sum(signals.values()) > 0 and len(all_indexed) +
          len(none_fits) == SWEEP_T,
          f"every trace fitted or counted as no fit: {line}")
    check(km["_parallel_cluster_fit"]["calls"] == 6,
          f"one kmeans_batched a cluster count: {km}")
    check(differ is None and card_res[2] == cpu_res[2],
          f"the sweep on the card against the CPU: {differ}")
    return {"k": best_nf + 1, "bic": best_bic,
            "wall_s": split["_gmm_photometries_MP"],
            "points": int(len(raw)),
            "ks": [g.n_components for g, _ in all_fits],
            "em_rounds": [g.em_rounds_ for g, _ in all_fits]}


def _pickle_dump_s(pickle, *args, **kwargs):
    t = time.perf_counter()
    pickle.dump(*args, **kwargs)
    return time.perf_counter() - t


def reference_gmm_phase(dev, phot, k_pipe, sweep):
    """The reference's per-cycle mixtures on the card:
    ``compat.MCsimlib._per_cycle_gmm_MP`` on the mixtures cell (GMM_T x
    GMM_F, k 2-6, 10 restarts, 100 rounds; its k per cycle beside
    ``Pipeline.per_cycle_gmm``'s, kernel E), the EM rounds and device
    operations of a fit, peak memory, ``_gmm_photometries_MP`` on the
    sweep's CSV (from cluster_fit), ``gmm_raw_photometries`` on cycle 0,
    the dpgmm path's AttributeError, and the card against the CPU on
    REF_SMALL_F cycles x REF_SMALL_T traces. Emits "reference_gmm"."""
    from fluorosequencingimageanalysis_torch import _device
    from fluorosequencingimageanalysis_torch.compat import MCsimlib
    from fluorosequencingimageanalysis_torch.compat import (
        jupyter_development as jd)
    from fluorosequencingimageanalysis_torch.inference import gmm as P
    from fluorosequencingimageanalysis_torch.inference.gmm import (
        _collect_raw)
    from fluorosequencingimageanalysis_torch.ops.mixture import (
        GaussianMixture)
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_gmm_photometries)

    _device.set_default_device(dev)
    split = {}
    fit_gmm = _timed(P, "_fit_gmm", split)
    bic = _timed(GaussianMixture, "bic", split)
    try:
        np.random.seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        scores, fits, raw = MCsimlib._per_cycle_gmm_MP(phot)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = int(torch.cuda.max_memory_allocated())
        P._fit_gmm = fit_gmm
        k_ref = [scores[c][1] + 1 for c in range(GMM_F)]
        every = [g for c in range(GMM_F) for g, _ in fits[c]]
        t = time.perf_counter()
        one = _collect_raw(phot, 0)
        collect_s = time.perf_counter() - t
        t = time.perf_counter()
        np.array([[p] for p in one])
        nested_s = time.perf_counter() - t
        x = np.asarray(raw[0], np.float64).reshape(-1, 1)
        np.random.seed(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        g6, ops = count_device_ops(lambda: GaussianMixture(
            max(GMM_KS), n_init=GMM_N_INIT, max_iter=GMM_N_ITER).fit(x))
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t
        np.random.seed(1)
        t = time.perf_counter()
        GaussianMixture(max(GMM_KS), n_init=GMM_N_INIT,
                        max_iter=GMM_N_ITER).fit(x)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        t = time.perf_counter()
        g, mean, std = jd.gmm_raw_photometries(raw[0])
        raw_s = time.perf_counter() - t
        try:
            MCsimlib._gmm_photometries(phot, cycle=0, dpgmm=True)
            dpgmm_error = None
        except AttributeError as e:
            dpgmm_error = str(e)
        small = make_gmm_photometries(REF_SMALL_T, REF_SMALL_F, seed=2)
        runs = {}
        for d in (dev, "cpu"):
            _device.set_default_device(d)
            np.random.seed(1)
            t = time.perf_counter()
            runs[str(d)] = (MCsimlib._per_cycle_gmm_MP(small),
                            time.perf_counter() - t)
    finally:
        P._fit_gmm = fit_gmm
        _device.set_default_device(None)
    (card, card_s), (cpu, cpu_s) = runs[str(dev)], runs["cpu"]
    k_card = [card[0][c][1] for c in range(REF_SMALL_F)]
    k_cpu = [cpu[0][c][1] for c in range(REF_SMALL_F)]
    differ = first_difference(cpu[1], card[1], REF_RTOL)
    line = dict(
        traces=GMM_T, cycles=GMM_F, ks=list(GMM_KS), n_init=GMM_N_INIT,
        n_iter=GMM_N_ITER, wall_s=wall, fits=len(every),
        wall_per_fit_s=wall / len(every),
        split_s={"fits": split["_fit_gmm"], "bic": split["bic"],
                 "copied_host_code": wall - split["_fit_gmm"] -
                 split["bic"],
                 "note": "fits: _fit_gmm (k-means starts, EM, host "
                         "reads); bic: GaussianMixture.bic on the card; "
                         "copied_host_code: the rest, the copies' Python "
                         "(each of the 60 _gmm_photometries calls "
                         "collects its cycle from the dict and builds a "
                         "nested list and an array of it)"},
        k_per_cycle=k_ref,
        k_per_cycle_kernel_e=k_pipe, peak_mem_bytes=peak,
        em_rounds={"per_fit": [g.em_rounds_ for g in every],
                   "n_iter_selected": [g.n_iter_ for g in every]},
        one_fit={"k": max(GMM_KS), "points": len(x), "wall_s": fit_s,
                 "em_rounds": g6.em_rounds_, "device_ops": ops,
                 "wall_with_op_count_s": counted_s,
                 "note": "aten operations dispatched (each one launch or "
                         "more on the card), k-means start included"},
        collect_raw_s_per_call=collect_s,
        collect_raw_calls=GMM_F * len(GMM_KS),
        nested_array_s_per_call=nested_s,
        nested_array_note="_gmm_photometries' np.array([[p] for p in "
                          "raw]), once a fit",
        gmm_photometries_mp=sweep,
        gmm_raw_photometries={"wall_s": raw_s, "mean": mean, "std": std},
        dpgmm_error=dpgmm_error,
        card_vs_cpu={"traces": REF_SMALL_T, "cycles": REF_SMALL_F,
                     "k": [k_card, k_cpu], "card_s": card_s,
                     "cpu_s": cpu_s, "first_difference": differ})
    emit("reference_gmm", **line)
    check(all(min(GMM_KS) <= k <= max(GMM_KS) for k in k_ref) and all(
        np.isfinite(scores[c][2]) for c in range(GMM_F)),
        f"a finite fit and k in range for each cycle: {k_ref}")
    check(dpgmm_error == "'BayesianGaussianMixture' object has no "
                         "attribute 'bic'",
          f"the dpgmm path raises as the JAX package's: {dpgmm_error}")
    check(np.isfinite(mean) and std > 0, "gmm_raw_photometries")
    check(k_card == k_cpu and differ is None,
          f"the per-cycle mixtures on the card against the CPU: "
          f"{k_card} {k_cpu} {differ}")


def mixtures_phases(dev, ptxas):
    """The remaining batched fitters on the card: kernel E against its twin
    at the reference's full per-cycle mixture fit, ``Pipeline.per_cycle_gmm``
    on config 5's photometries, the batched plateau fitter's device scores
    against its exact host scores, the device chi-squared engine against
    the native core, the four entry points on the card against the CPU,
    then the reference's own fits (``cluster_fit_phase``,
    ``reference_gmm_phase``). Emits the "gmm_em", "per_cycle_gmm",
    "plateau_device", "chisq_device", "mixtures_card_vs_cpu",
    "cluster_fit" and "reference_gmm" lines; returns kernel E's launches
    per ``per_cycle_gmm`` call and its numbers."""
    from fluorosequencingimageanalysis_torch import stepfitting as sf
    from fluorosequencingimageanalysis_torch.api import Pipeline
    from fluorosequencingimageanalysis_torch.inference.gmm import (
        _collect_raw, gmm_photometries_batched)
    from fluorosequencingimageanalysis_torch.ops.fused_gmm_em import gmm_em
    from fluorosequencingimageanalysis_torch.ops.plateau_batch import (
        _all_scores, _segmentations, all_plateau_fits_batched,
        plateau_fit_batched)
    from fluorosequencingimageanalysis_torch.utils import profiling
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_chisq_traces, make_gmm_photometries, make_v8_workload)

    ks, G, J = list(GMM_KS), GMM_F, len(GMM_KS)

    # -- gmm_em: kernel E against its twin, both on the card, on the
    # standardised cycles and starts that per_cycle_gmm builds.
    phot = make_gmm_photometries(GMM_T, GMM_F)
    groups = [np.asarray(_collect_raw(phot, c), np.float64)
              for c in range(G)]
    failed, e = em_against_twin(dev, groups, ks, GMM_N_INIT, GMM_N_ITER,
                                reps=5)
    kern = e["after_n_iter"]
    geo = e["geometry"]
    e_numbers = {k: e[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "share_of_bound")}
    emit("gmm_em", **e, **ptxas["gmm_em"],
         warps_per_sm=geo["blocks_per_sm"] * geo["warps"],
         note="means and weights on the standardised scale; max_abs_err "
              "is the largest |delta mean| after n_iter rounds; "
              "twin_reordered: the twin with E-step chunks of 1024 "
              "against the twin's 2048; geometry: subsets of each group's "
              "models, blocks a cluster (each a slice of the group's "
              "points), warps a block, points a staged tile, blocks an SM "
              "and clusters the card holds at once (occupancy API)")
    check(not failed, f"kernel E at K = {max(ks)} against its twin: {failed}")
    check(ptxas["gmm_em"]["spill_bytes"] == 0,
          f"kernel E spills no registers: {ptxas['gmm_em']}")

    # -- per_cycle_gmm: the user's entry point, kernel E once a call.
    pipe = Pipeline(device=dev, profile=True)
    pipe.per_cycle_gmm(phot)
    runs = []
    for _ in range(GMM_REPS):
        profiling.reset_timings()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gmm_em.launches = 0
        t = time.perf_counter()
        scores, fits, raw = pipe.per_cycle_gmm(phot)
        torch.cuda.synchronize()
        runs.append({
            "wall_s": time.perf_counter() - t,
            "launches": {"gmm_em": gmm_em.launches},
            "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
            "stages_s": {k: v["total"] for k, v in
                         profiling.timings().items()}})
    check(all(r["launches"] == {"gmm_em": 1} for r in runs),
          f"one launch of kernel E a per_cycle_gmm call: {runs}")
    k_pipe = [scores[c][1] + 1 for c in range(G)]
    check(sorted(scores) == list(range(G)) and all(
        np.isfinite(scores[c][2]) and len(fits[c]) == J and
        np.isfinite(np.ravel(scores[c][0].means_)).all() and
        len(raw[c]) == GMM_T for c in range(G)),
        "a finite fit, BIC and J models for each of the 12 cycles")
    check(k_pipe == kern["k"], f"per_cycle_gmm's k per cycle {k_pipe} is "
                               f"the kernel's {kern['k']}")
    walls = [r["wall_s"] for r in runs]
    emit("per_cycle_gmm", traces=GMM_T, cycles=G, ks=ks, n_init=GMM_N_INIT,
         n_iter=GMM_N_ITER, wall_s_median=statistics.median(walls), runs=runs,
         k_per_cycle=k_pipe,
         cycle0_means=sorted(float(m) for m in
                             np.ravel(scores[0][0].means_)),
         launches_note="1 launch of kernel E a call: the n_iter rounds and "
                       "the final log-likelihood pass are one kernel")
    try:
        from sklearn.mixture import GaussianMixture
        estimator = "scikit-learn"
    except ImportError:  # the card's machine: the port's own estimator
        from fluorosequencingimageanalysis_torch.ops.mixture import (
            GaussianMixture)
        estimator = "port (ops/mixture.py)"

    # -- plateau_device: config 5's CSV size through the plateau fitter.
    x = make_v8_workload(PL_T, seed=1)[0]
    t = time.perf_counter()
    exact = plateau_fit_batched(x, PL_DROPS, scores="exact")
    exact_s = time.perf_counter() - t
    plateau_fit_batched(x[:256], PL_DROPS, scores="device", device=dev)
    t = time.perf_counter()
    on_dev = plateau_fit_batched(x, PL_DROPS, scores="device", device=dev)
    device_s = time.perf_counter() - t
    r2_e, _, ok_e = _all_scores(x, x.shape[1], PL_DROPS, "exact")
    r2_d, _, ok_d = _all_scores(x, x.shape[1], PL_DROPS, "device",
                                device=dev)
    finite = np.isfinite(r2_e)
    check(np.array_equal(finite, np.isfinite(r2_d)),
          "the device scores are finite where the exact ones are")
    max_dr2 = float(np.abs(r2_e - r2_d)[finite].max())
    table = _segmentations(x.shape[1], PL_DROPS)[0]
    combos = {c: i for i, c in enumerate(table)}

    def combo(fit):
        return combos[tuple(np.cumsum([0] + [len(p) for p in fit])[:-1]
                            .tolist())]

    # A downstep flag may differ only where two adjacent segment means tie.
    flag_gap = 0.0
    for i, c in np.argwhere(ok_e != ok_d):
        bounds = list(table[c]) + [x.shape[1]]
        means = [np.mean(x[i, lo:hi]) for lo, hi in zip(bounds[:-1],
                                                         bounds[1:])]
        flag_gap = max(flag_gap, min(
            abs(p - q) / max(abs(p), abs(q), 1.0)
            for p, q in zip(means[:-1], means[1:])))
    differ = []
    for i, (a, b) in enumerate(zip(exact, on_dev)):
        if a[0] != b[0] or a[1] != b[1]:
            gap = float(abs(r2_e[i, combo(a[0])] - r2_e[i, combo(b[0])]))
            differ.append({"trace": i, "score_gap": gap,
                           "margin": min(gap, abs(gap - 0.05)),
                           "r2": [a[1], b[1]]})
    emit("plateau_device", traces=PL_T, cycles=x.shape[1],
         max_num_drops=PL_DROPS, exact_wall_s=exact_s,
         device_wall_s=device_s, differing_selections=len(differ),
         max_margin=max((d["margin"] for d in differ), default=0.0),
         score_gaps=collections.Counter(str(d["score_gap"])
                                        for d in differ),
         differing=differ[:10], max_abs_r2_err=max_dr2,
         downstep_flags_differing=int((ok_e != ok_d).sum()),
         downstep_flags_max_mean_gap=flag_gap,
         note="margin: the exact scores' gap between the two selections, "
              "or its distance from delta_r_2 (0.05); OFF frames are "
              "exact zeros, so segmentations that split them tie")
    check(max_dr2 <= 1e-12, f"float64 device r^2 within 1e-12: {max_dr2}")
    check(all(d["margin"] <= 1e-9 for d in differ),
          f"selections differ only at near-ties: {differ}")
    check(flag_gap <= 1e-12, f"downstep flags differ only at tied segment "
                             f"means: {flag_gap}")

    # -- chisq_device: config 3's chi-squared set, device engine.
    chi = make_chisq_traces(CHI_N, CHI_T)
    t = time.perf_counter()
    native = sf.chi_squared_fit_batch(chi, num_steps=CHI_STEPS)
    native_s = time.perf_counter() - t
    sf.chi_squared_fit_batch(chi[:64], num_steps=CHI_STEPS, engine="device",
                             device=dev)
    t = time.perf_counter()
    on_card = sf.chi_squared_fit_batch(chi, num_steps=CHI_STEPS,
                                       engine="device", device=dev)
    card_s = time.perf_counter() - t
    chi_differ = sum(not same_plateaus(a, b)
                     for a, b in zip(native, on_card))
    check(chi_differ == 0, f"device engine = native core on every trace "
                           f"({chi_differ} differ)")
    emit("chisq_device", shape=[CHI_N, CHI_T], num_steps=CHI_STEPS,
         native_wall_s=native_s, device_wall_s=card_s,
         native_traces_per_s=CHI_N / native_s,
         device_traces_per_s=CHI_N / card_s, differing_traces=chi_differ)

    # -- mixtures_card_vs_cpu: the four entry points on a small set.
    small = make_gmm_photometries(MIX_SMALL_T, MIX_SMALL_F, seed=1)
    cmp = {}
    card, cpu = (Pipeline(device=d).per_cycle_gmm(small) for d in
                 (dev, "cpu"))
    cmp["per_cycle_gmm_k"] = [[card[0][c][1] for c in range(MIX_SMALL_F)],
                              [cpu[0][c][1] for c in range(MIX_SMALL_F)]]
    cmp["per_cycle_gmm_bic_rel"] = max(
        abs(card[0][c][2] - cpu[0][c][2]) / abs(cpu[0][c][2])
        for c in range(MIX_SMALL_F))
    one = [gmm_photometries_batched(small, cycle=0, device=d)
           for d in (dev, "cpu")]
    cmp["gmm_photometries_k"] = [one[0][2], one[1][2]]
    cmp["gmm_photometries_bic_rel"] = abs(one[0][3] - one[1][3]) / abs(
        one[1][3])
    ladders = np.array([v[1] for fdict in small["ch1"].values()
                        for v in fdict.values()])
    pl = [plateau_fit_batched(ladders, PL_DROPS, scores="device", device=d)
          for d in (dev, "cpu")]
    cmp["plateau_fits_differing"] = sum(a[0] != b[0] for a, b in zip(*pl))
    cmp["plateau_r2_max_abs"] = max(abs(a[1] - b[1]) for a, b in zip(*pl))
    allp = [all_plateau_fits_batched(ladders[:200], PL_DROPS,
                                     scores="device", device=d)
            for d in (dev, "cpu")]
    cmp["all_plateau_fits_equal"] = all(
        [f[0] for f in a] == [f[0] for f in b] and np.allclose(
            [f[1:] for f in a], [f[1:] for f in b], rtol=0, atol=1e-12,
            equal_nan=True)
        for a, b in zip(*allp))
    traces = make_chisq_traces(MIX_SMALL_T, 60, seed=2)
    chis = [sf.chi_squared_fit_batch(traces, num_steps=8, engine="device",
                                     device=d) for d in (dev, "cpu")]
    cmp["chisq_differing"] = sum(not same_plateaus(a, b)
                                 for a, b in zip(*chis))
    check(cmp["per_cycle_gmm_k"][0] == cmp["per_cycle_gmm_k"][1] and
          cmp["per_cycle_gmm_bic_rel"] <= 1e-3 and
          cmp["gmm_photometries_k"][0] == cmp["gmm_photometries_k"][1] and
          cmp["gmm_photometries_bic_rel"] <= 1e-3 and
          cmp["plateau_fits_differing"] == 0 and
          cmp["plateau_r2_max_abs"] <= 1e-12 and
          cmp["all_plateau_fits_equal"] and cmp["chisq_differing"] == 0,
          f"the mixture fitters on the card against the CPU: {cmp}")
    sk_line = sklearn_selection(GaussianMixture, small, card[0], dev)
    sk_line["estimator"] = estimator
    emit("mixtures_card_vs_cpu", traces=MIX_SMALL_T, cycles=MIX_SMALL_F,
         chisq_shape=[MIX_SMALL_T, 60], **cmp, sklearn=sk_line)
    sweep = cluster_fit_phase(dev, phot)
    reference_gmm_phase(dev, phot, k_pipe, sweep)
    limits = gmm_limits_phase(dev, phot)
    return {"launches": {"per_cycle_gmm": runs[0]["launches"],
                         **limits["launches"]},
            "kernels": {"gmm_em": e_numbers}, "photometries": phot}


def em_against_twin(dev, groups, ks, n_init, n_iter, reg=1e-6, full=True,
                    reps=3):
    """Kernel E and its twin, both on the card, on ``groups`` standardised
    as gmm_fit_batched does. Returns (the gates that failed, the numbers).

    After 3 rounds each model lies within the CPU parity tests' stated
    tolerances (the sums run in another order than the twin's). After
    ``n_iter`` rounds the kernel repeats bit for bit and picks the twin's
    BIC-selected k per group; each model's log-likelihood may differ from
    the twin's, and a restart may differ where the twin's likelihoods of
    the two tie, by max(E_TIE_REL, twice what halving the twin's E-step
    chunks moves them: that is the twin's own spread, the kernel's order
    is a third). The numbers: those differences, the kernel's time over
    ``reps`` runs, the twin's and the bound. Without ``full``, the 3-round
    gate and the kernel's time only."""
    from fluorosequencingimageanalysis_torch.ops import gmm_batch as gb
    from fluorosequencingimageanalysis_torch.ops.fused_gmm_em import (
        geometry, gmm_em)
    G, J = len(groups), len(ks)
    n_valid = np.array([g.size for g in groups])
    z, _, _, starts = gb.prepare(groups, ks, n_init, 0, 2048)
    zt = torch.from_numpy(z).to(dev)
    counts = torch.from_numpy(n_valid.astype(np.int32)).to(dev)
    st = [torch.from_numpy(a).to(dev) for a in starts]
    valid = (torch.arange(z.shape[1], device=dev)[None, :] <
             counts[:, None].long()).float()
    act = starts[3]

    def host(out):
        return [t.double().cpu().numpy() for t in out]

    def twin_timed(rounds, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = gb._em_plain(zt, valid, *st, rounds, reg, **kw)
        end.record()
        torch.cuda.synchronize()
        return host(out), start.elapsed_time(end)

    def timed():
        """The kernel's time over ``reps`` runs, taken after the
        comparisons as the phase always took it, and the bound."""
        e_ms = time_ms(lambda: gmm_em(zt, counts, *st, n_iter, reg), reps)
        ms = statistics.median(e_ms)
        nbytes = zt.numel() * 4 + counts.numel() * 4 + sum(
            t.numel() * t.element_size() for t in st) + \
            3 * st[0].numel() * 4 + G * J * n_init * 4
        e_bound, e_by, e_type, e_work = bound_e(n_valid, ks, n_init,
                                                n_iter, nbytes)
        return {"shape": {"G": G, "N": int(n_valid.max()), "B": J * n_init,
                          "K": max(ks), "n_iter": n_iter},
                "ms": ms, "ms_runs": e_ms, "bound_ms": e_bound,
                "bound_by": e_by, "bound_type": e_type, **e_work,
                "share_of_bound": e_bound / ms,
                "per_model_after_3_rounds": per_model3,
                "plain_ms_3_rounds": plain3_ms,
                "geometry": geometry(G, zt.shape[1], J * n_init, max(ks))}

    failed = []
    g3 = host(gmm_em(zt, counts, *st, 3, reg))
    w3, plain3_ms = twin_timed(3)
    per_model3 = {
        "loglik_rel": float((np.abs(g3[3] - w3[3]) / np.abs(w3[3])).max()),
        "mean_abs": float(np.abs(g3[1] - w3[1])[act].max()),
        "weight_abs": float(np.abs(g3[0] - w3[0]).max()),
        "var_rel": float((np.abs(g3[2] - w3[2]) / w3[2])[act].max())}
    var_ok = (np.abs(g3[2] - w3[2]) <= np.maximum(
        E_VAR_REL * w3[2], E_VAR_OF_MOMENT * (w3[1] ** 2 + w3[2])))[act]
    if not (per_model3["loglik_rel"] <= E_LL_REL and
            per_model3["mean_abs"] <= E_MEAN_ABS and
            per_model3["weight_abs"] <= E_W_ABS and bool(var_ok.all())):
        failed.append(f"after 3 rounds, model by model: {per_model3}")
    if not full:
        return failed, timed()
    got = host(gmm_em(zt, counts, *st, n_iter, reg))
    again = host(gmm_em(zt, counts, *st, n_iter, reg))
    repeats = all(np.array_equal(a, b) for a, b in zip(got, again))
    want, twin_first = twin_timed(n_iter)
    _, twin_second = twin_timed(n_iter)
    half, _ = twin_timed(n_iter, chunk=1024)
    pen = np.array([3 * k - 1 for k in ks]) * np.log(n_valid)[:, None]

    def against_twin(r):
        """Per-model differences from the twin, the (group, k) pairs whose
        best restart differs with the twin's gap between the two, the
        BIC-selected k per group."""
        ll_r, ll_t = (a[3].reshape(G, J, n_init) for a in (r, want))
        pick_r, best_t = ll_r.argmax(-1), ll_t.max(-1)
        twin_of_pick = np.take_along_axis(ll_t, pick_r[..., None],
                                          -1)[..., 0]
        flips = [{"group": int(g), "k": ks[j],
                  "restart": int(pick_r[g, j]),
                  "twin_restart": int(ll_t[g, j].argmax()),
                  "twin_gap_rel": float(abs(best_t[g, j] -
                                            twin_of_pick[g, j]) /
                                        abs(best_t[g, j]))}
                 for g, j in np.argwhere(pick_r != ll_t.argmax(-1))]
        return {"loglik_rel": float((np.abs(r[3] - want[3]) /
                                     np.abs(want[3])).max()),
                "mean_abs": float(np.abs(r[1] - want[1])[act].max()),
                "weight_abs": float(np.abs(r[0] - want[0]).max()),
                "best_loglik_rel": float((np.abs(ll_r.max(-1) - best_t) /
                                          np.abs(best_t)).max()),
                "restart_flips": len(flips),
                "max_flip_gap_rel": max((f["twin_gap_rel"] for f in flips),
                                        default=0.0),
                "k": [ks[j] for j in (-2 * ll_r.max(-1) + pen).argmin(1)],
                "flips": flips}

    kern, reordered = against_twin(got), against_twin(half)
    k_twin = [ks[j] for j in (-2 * want[3].reshape(G, J, n_init).max(-1)
                              + pen).argmin(1)]
    tie = max(E_TIE_REL, 2 * reordered["loglik_rel"])
    for ok, what in (
            (repeats, "the kernel repeats bit for bit"),
            (kern["k"] == k_twin, f"BIC-selected k per group: kernel "
                                  f"{kern['k']}, twin {k_twin}"),
            (kern["loglik_rel"] <= tie,
             f"after {n_iter} rounds each model's log-likelihood within "
             f"{tie} of the twin's: {kern['loglik_rel']}"),
            (kern["max_flip_gap_rel"] <= tie,
             f"a restart differs only at a near-tie of the twin's own "
             f"likelihoods (within {tie}): {kern['flips']}")):
        if not ok:
            failed.append(what)
    numbers = timed()
    numbers.update(
        max_abs_err=kern["mean_abs"],
        plain_ms=statistics.median([twin_first, twin_second]),
        plain_ms_runs=[twin_first, twin_second], after_n_iter=kern,
        twin_reordered_after_n_iter=reordered, k_twin=k_twin,
        flip_tie_rel=tie, repeats_bit_for_bit=repeats)
    return failed, numbers


def gmm_limits_phase(dev, phot):
    """Fault F1's cases on the card: ``per_cycle_gmm`` at max_fluors=8
    (K = 9, kernel E's shared-memory form) against the twin under the
    gmm_em phase's rule, kernel E at its largest K, a group of more models
    than one launch takes (sliced launches) against the twin's picks, and
    a sliced call bit for bit against one launch. Emits "gmm_limits";
    returns the per_cycle_gmm call's launches."""
    from fluorosequencingimageanalysis_torch import _build
    from fluorosequencingimageanalysis_torch.api import Pipeline
    from fluorosequencingimageanalysis_torch.inference.gmm import (
        _collect_raw)
    from fluorosequencingimageanalysis_torch.ops import fused_gmm_em
    from fluorosequencingimageanalysis_torch.ops import gmm_batch as gb
    from fluorosequencingimageanalysis_torch.ops.fused_gmm_em import (
        BMAX, KMAX, KREG, gmm_em)

    groups = [np.asarray(_collect_raw(phot, c), np.float64)
              for c in range(GMM_F)]
    ks9 = list(range(2, LIM_MAX_FLUORS + 2))
    failed9, k9 = em_against_twin(dev, groups, ks9, GMM_N_INIT,
                                  GMM_N_ITER)
    pipe = Pipeline(device=dev, profile=True)
    torch.cuda.synchronize()
    gmm_em.launches = 0
    t = time.perf_counter()
    scores, _, _ = pipe.per_cycle_gmm(phot, max_fluors=LIM_MAX_FLUORS,
                                      n_init=GMM_N_INIT,
                                      n_iter=GMM_N_ITER)
    torch.cuda.synchronize()
    pcg_s, pcg_launches = time.perf_counter() - t, gmm_em.launches
    k_pipe = [scores[c][1] + 1 for c in range(GMM_F)]
    failedmax, kmax = em_against_twin(dev, groups, [KMAX], LIM_KMAX_N_INIT,
                                      GMM_N_ITER, full=False)

    # More models than one launch takes: LIM_KS x LIM_N_INIT restarts of
    # one group, against the twin's restart picks and k.
    rng = np.random.default_rng(8)
    one = [np.concatenate([rng.normal(2000.0, 300.0, LIM_N // 2),
                           rng.normal(30000.0, 6000.0, LIM_N // 2)])]
    n_models = len(LIM_KS) * LIM_N_INIT
    torch.cuda.synchronize()
    gmm_em.launches = 0
    t = time.perf_counter()
    big = gb.gmm_fit_batched(one, list(LIM_KS), n_init=LIM_N_INIT,
                             n_iter=LIM_N_ITER, device=dev)
    torch.cuda.synchronize()
    big_s, big_launches = time.perf_counter() - t, gmm_em.launches
    z, _, _, starts = gb.prepare(one, list(LIM_KS), LIM_N_INIT, 0, 2048)
    zt = torch.from_numpy(z).to(dev)
    cnt = torch.tensor([LIM_N], dtype=torch.int32, device=dev)
    st = [torch.from_numpy(a).to(dev) for a in starts]
    valid = (torch.arange(z.shape[1], device=dev)[None, :] < LIM_N).float()
    twin_ms = time_ms(lambda: gb._em_plain(zt, valid, *st, LIM_N_ITER,
                                           1e-6), 1)
    ll_t = gb._em_plain(zt, valid, *st, LIM_N_ITER, 1e-6)[3].double().cpu(
        ).numpy().reshape(len(LIM_KS), LIM_N_INIT)
    ll_k = gb.em_in_slices(zt, cnt, *st, LIM_N_ITER, 1e-6)[3].double().cpu(
        ).numpy().reshape(len(LIM_KS), LIM_N_INIT)
    big_ms = time_ms(lambda: gb.em_in_slices(zt, cnt, *st, LIM_N_ITER,
                                             1e-6), 3)
    big_bytes = zt.numel() * 4 + 4 + sum(
        t.numel() * t.element_size() for t in st) + 3 * st[0].numel() * 4 \
        + n_models * 4
    big_bound, big_by, big_type, _ = bound_e([LIM_N], list(LIM_KS),
                                             LIM_N_INIT, LIM_N_ITER,
                                             big_bytes)
    pick = ll_k.argmax(-1)
    gap = (np.abs(ll_t.max(-1) - ll_t[np.arange(len(LIM_KS)), pick]) /
           np.abs(ll_t.max(-1)))
    pen = np.array([3 * k - 1 for k in LIM_KS]) * np.log(LIM_N)
    k_big_twin = LIM_KS[int((-2 * ll_t.max(-1) + pen).argmin())]
    k_big = LIM_KS[int(big["bic"][0].argmin())]
    del zt, st, valid

    # Sliced against one launch, bit for bit, on config 5's models.
    z5, _, _, s5 = gb.prepare(groups, list(GMM_KS), GMM_N_INIT, 0, 2048)
    z5 = torch.from_numpy(z5).to(dev)
    c5 = torch.from_numpy(np.array([g.size for g in groups],
                                   np.int32)).to(dev)
    s5 = [torch.from_numpy(a).to(dev) for a in s5]
    whole = gb.em_in_slices(z5, c5, *s5, GMM_N_ITER, 1e-6)
    fused_gmm_em.BMAX = LIM_SLICE
    try:
        sliced = gb.em_in_slices(z5, c5, *s5, GMM_N_ITER, 1e-6)
    finally:
        fused_gmm_em.BMAX = BMAX
    bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(whole, sliced))
    del z5, s5

    regs = {}
    for name, v in _build.ptxas_kernels("gmm_em").items():
        form = ("shared_memory_form" if "kernel_sm" in name else
                "register_form_K" + name.split("ILi")[1].split("E")[0])
        regs[form] = v
    emit("gmm_limits", kreg=KREG, kmax=KMAX, bmax=BMAX,
         max_fluors=LIM_MAX_FLUORS, kernel_e_k9=k9, k_per_cycle=k_pipe,
         per_cycle_gmm_wall_s=pcg_s,
         per_cycle_gmm_launches={"gmm_em": pcg_launches},
         kernel_e_kmax=kmax, models_over_bmax={
             "points": LIM_N, "ks": list(LIM_KS), "n_init": LIM_N_INIT,
             "models": n_models, "n_iter": LIM_N_ITER,
             "launches": big_launches, "wall_s": big_s,
             "kernel_ms": statistics.median(big_ms), "kernel_ms_runs": big_ms,
             "plain_ms": statistics.median(twin_ms), "bound_ms": big_bound,
             "bound_by": big_by, "bound_type": big_type,
             "share_of_bound": big_bound / statistics.median(big_ms),
             "k": k_big,
             "k_twin": k_big_twin, "restart_flips": int(
                 (pick != ll_t.argmax(-1)).sum()),
             "max_flip_gap_rel": float(gap.max())},
         slices_bit_for_bit={"models": len(GMM_KS) * GMM_N_INIT,
                             "slice": LIM_SLICE, "equal": bitwise},
         ptxas_by_form=regs,
         note="kernel_e_k9: the shared-memory form at per_cycle_gmm's "
              "max_fluors=8 models (config 5's 12 cycles, k 2-9, 10 "
              "restarts, 100 rounds); kernel_e_kmax: K = KMAX on the same "
              "data, 3 rounds against the twin, the time at 100 rounds")
    check(not failed9, f"kernel E at K = 9 against its twin: {failed9}")
    check(k_pipe == k9["after_n_iter"]["k"],
          f"per_cycle_gmm(max_fluors=8)'s k {k_pipe} is the kernel's "
          f"{k9['after_n_iter']['k']}")
    check(pcg_launches == 1, f"one launch at K = 9: {pcg_launches}")
    check(not failedmax, f"kernel E at K = {KMAX} against its twin: "
                         f"{failedmax}")
    check(big_launches == -(-n_models // BMAX) and k_big == k_big_twin and
          float(gap.max()) <= E_TIE_REL,
          f"{n_models} models in {big_launches} launches pick the twin's "
          f"k ({k_big}, {k_big_twin}) and restarts (gap {gap.max()})")
    check(bitwise, "a sliced call equals one launch bit for bit")
    check(all(v["spill_bytes"] == 0 for v in regs.values()),
          f"no instantiation of kernel E spills: {regs}")
    return {"launches": {"gmm_limits_per_cycle_gmm":
                         {"gmm_em": pcg_launches}}}


def parallel_phases(dev, stack4=None, calibrated=None, gmm_phot=None):
    """The multi-device layer on one card: ``experiment_step_sharded`` over
    a mesh of PAR_SHARDS entries of the card on the headline stack,
    against ``experiment_step`` bit for bit (each field's work is its own);
    ``Pipeline`` over that device list on config 4's first PAR_F fields
    (``stack4``, else made here), its CSV against the one-device
    Pipeline's; ``multihost.run_experiment`` in PAR_PROCS processes
    (gloo, all on the card, PAR_F / PAR_PROCS fields each), every child's
    CSV byte for byte the one-process CSV; and every other method that
    shards (``parallel_methods_phase``, with the fluor group's calibrated
    run and the mixtures group's photometries where those ran). The
    multi-card case is not timed: the machine has one card. Emits
    "parallel_step", "parallel_pipeline", "multihost" and
    "parallel_methods"; returns the kernels' launches."""
    from fluorosequencingimageanalysis_torch.api import Pipeline
    from fluorosequencingimageanalysis_torch.config import (
        DetectConfig, PhotometryConfig, PipelineConfig, RegistrationConfig)
    from fluorosequencingimageanalysis_torch.ops.consolidate import (
        consolidate)
    from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
        candidate_map_fused)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality)
    from fluorosequencingimageanalysis_torch.parallel.mesh import (
        experiment_step, experiment_step_sharded, make_mesh)
    from fluorosequencingimageanalysis_torch.utils.convert import step_kwargs
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_experiment_stack, make_stack)

    def counts():
        return {"candidate_map": candidate_map_fused.launches,
                "fit_quality": fit_quality.launches,
                "consolidate": consolidate.launches}

    def zero():
        candidate_map_fused.launches = fit_quality.launches = 0
        consolidate.launches = 0

    cfg = PipelineConfig(
        detect=DetectConfig(max_candidates=MAX_CANDIDATES,
                            num_iters=NUM_ITERS),
        registration=RegistrationConfig(upsample_factor=UPSAMPLE),
        photometry=PhotometryConfig(method="mexican_hat"))
    kw = step_kwargs(cfg)
    stack, _ = make_stack(F, C, HW, HW)
    x = torch.from_numpy(stack).to(dev)
    mesh = make_mesh(devices=[dev] * PAR_SHARDS)
    launches = {}
    with torch.no_grad():
        one = experiment_step(x, **kw)
        torch.cuda.synchronize()
        zero()
        t = time.perf_counter()
        sharded = experiment_step_sharded(x, mesh, **kw)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t
        launches["parallel_sharded_step"] = counts()
        one_s = host_ms(lambda: experiment_step(x, **kw), 3) / 1e3
        sharded_s = host_ms(lambda: experiment_step_sharded(x, mesh, **kw),
                            3) / 1e3
    differ = {}
    for k, v in one.items():
        a, b = v.cpu().numpy(), sharded[k].cpu().numpy()
        if a.shape != b.shape or not np.array_equal(
                a, b, equal_nan=a.dtype.kind == "f"):
            differ[k] = (float(np.nanmax(np.abs(a.astype(np.float64) -
                                                b.astype(np.float64))))
                         if a.shape == b.shape else "shape")
    emit("parallel_step", mesh=mesh.shape, shape=list(stack.shape),
         one_device_s=one_s, sharded_s=sharded_s,
         launches=launches["parallel_sharded_step"],
         keys_differing=differ,
         note="both shards on the one card, enqueued one after the other "
              "on the calling thread; a shard's "
              "fields are the same work as in the one-device step, so the "
              "outputs are equal bit for bit")
    check(not differ, f"the sharded step equals experiment_step bit for "
                      f"bit; largest differences: {differ} (each field's "
                      f"work is its own: a difference is a fault)")
    check(launches["parallel_sharded_step"] == {
        "candidate_map": PAR_SHARDS, "fit_quality": PAR_SHARDS,
        "consolidate": PAR_SHARDS},
        f"one launch each of A, B and F a shard: {launches}")
    del x, one, sharded

    if stack4 is None:
        stack4 = np.clip(make_experiment_stack(EXP_F, EXP_C), 0,
                         65535).astype(np.uint16)
    stack8 = np.ascontiguousarray(stack4[:PAR_F])
    ekw = dict(max_candidates=EXP_K, max_spots=EXP_S)
    with tempfile.TemporaryDirectory() as tmp:
        csvs = {}
        walls = {}
        for name, device in (("one_device", dev),
                             ("device_list", [dev] * PAR_SHARDS)):
            pipe = Pipeline(device=device)
            pipe.run_experiment(stack8[:1], **ekw)
            torch.cuda.synchronize()
            zero()
            t = time.perf_counter()
            res = pipe.run_experiment(
                stack8, csv_path=os.path.join(tmp, name + ".csv"), **ekw)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t
            launches["parallel_pipeline_" + name] = counts()
            with open(os.path.join(tmp, name + ".csv"), "rb") as fh:
                csvs[name] = fh.read()
            csvs[name + "_rows"] = len(res["rows"])
        same = csvs["one_device"] == csvs["device_list"]
        emit("parallel_pipeline", fields=PAR_F, mesh=mesh.shape,
             rows=csvs["one_device_rows"], csv_equal=same, wall_s=walls,
             launches={k: v for k, v in launches.items()
                       if k.startswith("parallel_pipeline")})
        check(same and csvs["one_device_rows"] == csvs["device_list_rows"],
              "Pipeline over a device list writes the one-device CSV")

        # multihost.run_experiment in PAR_PROCS processes over gloo.
        npy = os.path.join(tmp, "stack8.npy")
        np.save(npy, stack8)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multihost-child",
             f"{r},{PAR_PROCS},{port},{dev},{tmp}"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(PAR_PROCS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=PAR_CHILD_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        mh_s = time.perf_counter() - t
        for p, log in zip(procs, logs):
            check(p.returncode == 0, f"a multihost child failed (exit "
                                     f"{p.returncode}): {log[-3000:]}")
        children = [json.loads(log.strip().splitlines()[-1]) for log in logs]
        equal = []
        for r in range(PAR_PROCS):
            with open(os.path.join(tmp, f"multihost_{r}.csv"), "rb") as fh:
                equal.append(fh.read() == csvs["one_device"])
    emit("multihost", processes=PAR_PROCS, backend="gloo",
         fields_per_process=PAR_F // PAR_PROCS, wall_s=mh_s,
         children=children, csv_equal_to_one_process=equal,
         note="wall: both children from spawn to exit (start-up, the "
              "kernels' load, the group's set-up and the run)")
    check(all(equal), f"every process's CSV is the one-process CSV: {equal}")
    launches.update(parallel_methods_phase(dev, calibrated, gmm_phot))
    return {"launches": launches, "kernels": {}}


def parallel_methods_phase(dev, calibrated=None, gmm_phot=None):
    """Every other ``Pipeline`` method that shards, on a device list of
    PAR_SHARDS entries of the card against the card alone, at the cells'
    full sizes: config 2's z-stack (lean), the timetrace movie with its
    CSV, config 3's traces through ``stepfit``, config 5's track CSV
    through ``fluor_counts`` and ``fluor_counts_calibrated`` (the one-device
    calibrated run is the fluor group's, ``calibrated``, where it ran in
    this call), the mixtures' photometries (``gmm_phot``, else made here)
    through ``per_cycle_gmm``, and ``simulate_signals`` on two peptides
    (host work). One "parallel_methods" line a method: both walls (host
    clock; the shares run one after the other on the one card), the
    launches of kernels A, B, C and E in each call, and whether the two
    results are equal bit for bit (each row's work is its own). Fails
    after the last line if any result differs or a launch count is not
    the expected one; returns the launches of the kernels each path
    drove."""
    from fluorosequencingimageanalysis_torch.api import (GROUP_FRAMES,
                                                         Pipeline)
    from fluorosequencingimageanalysis_torch.config import (
        LognormalConfig, PipelineConfig, StepfitConfig)
    from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
        candidate_map_fused)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality)
    from fluorosequencingimageanalysis_torch.ops.fused_gmm_em import gmm_em
    from fluorosequencingimageanalysis_torch.ops.fused_lognormal import (
        v8_score_fused)
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_gmm_photometries, make_movie, make_step_traces,
        make_v8_workload, make_zstack)

    wrappers = {"candidate_map": candidate_map_fused,
                "fit_quality": fit_quality, "v8_score": v8_score_fused,
                "gmm_em": gmm_em}
    devices = [dev] * PAR_SHARDS

    def run(fn):
        """fn() with every count set to 0 just before: (its result, the
        host-clock wall to the device's end, the launches)."""
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t,
                {k: w.launches for k, w in wrappers.items()})

    launches, failed = {}, []

    def report(method, one, multi, equal, expect_one, expect, **extra):
        """One line for a method; ``one``/``multi``: (result, wall,
        launches); ``expect_one``/``expect``: the launches the card alone
        and the device list must show."""
        kernels = [k for k in wrappers if one[2][k] or multi[2][k]]
        launches["parallel_methods_" + method] = {
            k: multi[2][k] for k in kernels}
        launches["parallel_methods_" + method + "_one_device"] = {
            k: one[2][k] for k in kernels}
        emit("parallel_methods", method=method, shards=PAR_SHARDS,
             one_device_s=one[1], device_list_s=multi[1],
             launches={"one_device": one[2], "device_list": multi[2]},
             expected_launches={"one_device": expect_one,
                                "device_list": expect},
             equal=equal, **extra,
             note="host clock to the device's end; the device list repeats "
                  "the one card, so its shares run one after the other")
        if not equal:
            failed.append(f"{method}: the device list's result differs")
        if (one[2], multi[2]) != (expect_one, expect):
            failed.append(f"{method}: launches {one[2]} and {multi[2]}, "
                          f"expected {expect_one} and {expect}")

    def expect(**n):
        return {k: n.get(k, 0) for k in wrappers}

    # Config 2: the z-stack, its groups of GROUP_FRAMES frames dealt to
    # the devices in turn.
    frames = make_zstack(Z_T, HW, HW)
    kw = dict(max_candidates=Z_K, lean=True, max_spots=Z_S)
    pipes = Pipeline(device=dev), Pipeline(device=devices)
    for p in pipes:
        p.run_zstack(frames[:GROUP_FRAMES * PAR_SHARDS], **kw)
    one, multi = (run(lambda p=p: p.run_zstack(frames, **kw)) for p in pipes)
    groups = -(-Z_T // GROUP_FRAMES)
    report("run_zstack", one, multi, same_result(one[0], multi[0]),
           expect(candidate_map=groups, fit_quality=groups),
           expect(candidate_map=groups, fit_quality=groups),
           frames=Z_T, max_candidates=Z_K, max_spots=Z_S,
           frames_per_s={"one_device": Z_T / one[1],
                         "device_list": Z_T / multi[1]})
    # A ragged stack (a short last group) already on the card: the device
    # list runs it in the groups of frames from the host.
    ragged = frames[:Z_T - GROUP_FRAMES // 2]
    resident = torch.from_numpy(ragged).to(dev)
    one = run(lambda: pipes[0].run_zstack(ragged, **kw))
    multi = run(lambda: pipes[1].run_zstack(resident, **kw))
    groups = -(-len(ragged) // GROUP_FRAMES)
    report("run_zstack_ragged_resident", one, multi,
           same_result(one[0], multi[0]),
           expect(candidate_map=groups, fit_quality=groups),
           expect(candidate_map=groups, fit_quality=groups),
           frames=len(ragged), max_candidates=Z_K, max_spots=Z_S)
    del frames, resident

    # The timetrace movie: tracks split over the list (the two-step path)
    # against the fused one-device path; the CSV's bytes.
    movie = make_movie(T=TT_T, H=HW, W=HW, n_spots=TT_SPOTS)
    kw = dict(max_candidates=None, **SF_KW)
    pipes = Pipeline(device=dev), Pipeline(device=devices)
    with tempfile.TemporaryDirectory() as tmp:
        res = []
        for name, p in zip(("one", "multi"), pipes):
            path = os.path.join(tmp, name + ".csv")
            out, wall, n = run(lambda p=p, path=path: p.run_timetrace(
                movie, csv_path=path, **kw))
            with open(path, "rb") as fh:
                res.append(((out, fh.read()), wall, n))
    (a, csv_a), (b, csv_b) = res[0][0], res[1][0]
    equal = a["trace_count"] > 0 and same_result(
        (a["traces"], a["photometries"], csv_a),
        (b["traces"], b["photometries"], csv_b))
    detect_ok = res[0][2]["candidate_map"] == 1 and \
        res[0][2]["fit_quality"] >= 1
    report("run_timetrace", res[0], res[1], equal and detect_ok,
           res[0][2], res[0][2],
           frames=TT_T, traces=a["trace_count"], csv_bytes=len(csv_a),
           csv_equal=csv_a == csv_b)
    del movie

    # Config 3: step fitting, no kernel of A-E.
    traces = make_step_traces(SF_N, SF_T)
    cfg = PipelineConfig(stepfit=StepfitConfig(**SF_KW))
    one, multi = (run(lambda p=p: p.stepfit(traces)) for p in (
        Pipeline(cfg, device=dev), Pipeline(cfg, device=devices)))
    report("stepfit", one, multi, same_result(one[0], multi[0]), expect(),
           expect(),
           traces=SF_N, frames=SF_T)

    # Config 5's track CSV: kernel C once a device where one chunk holds
    # every trace.
    cfg = PipelineConfig(lognormal=LognormalConfig(max_possible=V8_K,
                                                   allow_multidrop=True))
    pipes = Pipeline(cfg, device=dev), Pipeline(cfg, device=devices)
    fit_kw = dict(beta=V8_BETA, beta_sigma=V8_BETA_SIGMA)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tracks.csv")
        write_v8_tracks_csv(path, *make_v8_workload(FC_ROWS, V8_F, V8_K,
                                                    seed=1)[:2])
        one, multi = (run(lambda p=p: p.fluor_counts(path, **fit_kw))
                      for p in pipes)
        report("fluor_counts", one, multi, same_result(one[0], multi[0]),
               expect(v8_score=1), expect(v8_score=PAR_SHARDS),
               rows=FC_ROWS)
        multi = run(lambda: pipes[1].fluor_counts_calibrated(path))
        if calibrated is None:
            one = run(lambda: pipes[0].fluor_counts_calibrated(path))
            reused = False
        else:
            one = (calibrated["result"], calibrated["wall_s"],
                   expect(**calibrated["launches"]))
            reused = True
    report("fluor_counts_calibrated", one, multi,
           same_result(one[0], multi[0]), expect(v8_score=2),
           expect(v8_score=2 * PAR_SHARDS), rows=FC_ROWS,
           one_device_from_fluor_group=reused)

    # The mixtures: the models over the list, kernel E once a device.
    if gmm_phot is None:
        gmm_phot = make_gmm_photometries(GMM_T, GMM_F)
    pipes = Pipeline(device=dev), Pipeline(device=devices)
    one, multi = (run(lambda p=p: p.per_cycle_gmm(gmm_phot)) for p in pipes)

    def fits(res):
        scores, all_fits, raw = res
        return ([(nf, bic) for _, nf, bic, _ in scores.values()],
                [[(f.means_, f.covars_, f.weights_, f._loglik)
                  for f in fs] for fs in all_fits.values()],
                list(raw.values()))
    report("per_cycle_gmm", one, multi,
           same_result(fits(one[0]), fits(multi[0])), expect(gmm_em=1),
           expect(gmm_em=PAR_SHARDS), traces=GMM_T,
           cycles=GMM_F)

    # simulate_signals: host work whatever the devices.
    n_cycles = SIM_MOCKS + SIM_EDMANS
    peptides = {"P1": ((SIM_SEQ, ""),), "P2": (("AKCAKDCKA", "KC"),)}
    windows = {"C": tuple(range(1, n_cycles + 1)),
               "K": tuple(range(1, n_cycles + 1))}
    args = (peptides, SIM_PARAMS["p"], SIM_PARAMS["b"], SIM_PARAMS["u"],
            windows)
    one, multi = (run(lambda p=p: sorted(
        (sig, sorted(dict(c).items())) for sig, c, _ in p.simulate_signals(
            *args, sample_size=PAR_SIM_SIGNALS,
            random_seed=1).leaf_iterator()))
        for p in (Pipeline(device=dev), Pipeline(device=devices)))
    report("simulate_signals", one, multi,
           bool(one[0]) and same_result(one[0], multi[0]), expect(),
           expect(), peptides=2, samples=2 * PAR_SIM_SIGNALS)
    check(not failed, f"parallel_methods: {failed}")
    return launches


def multihost_child(spec):
    """One process of the parallel group's multihost run: joins the gloo
    group, runs multihost.run_experiment on its share of the fields on the
    device (the parent's) and writes its CSV; prints its launches and wall
    as JSON."""
    from fluorosequencingimageanalysis_torch.ops.consolidate import (
        consolidate)
    from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
        candidate_map_fused)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality)
    from fluorosequencingimageanalysis_torch.parallel import multihost
    from fluorosequencingimageanalysis_torch.parallel.mesh import make_mesh

    rank, nproc, port, device, tmp = spec.split(",", 4)
    rank, nproc = int(rank), int(nproc)
    multihost.initialize(f"localhost:{port}", num_processes=nproc,
                         process_id=rank)
    stack = np.load(os.path.join(tmp, "stack8.npy"))
    share = stack.shape[0] // nproc
    t = time.perf_counter()
    res = multihost.run_experiment(
        stack[rank * share:(rank + 1) * share],
        csv_path=os.path.join(tmp, f"multihost_{rank}.csv"),
        mesh=make_mesh(devices=[device]), max_candidates=EXP_K,
        max_spots=EXP_S)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    torch.distributed.destroy_process_group()
    launches = {"candidate_map": candidate_map_fused.launches,
                "fit_quality": fit_quality.launches,
                "consolidate": consolidate.launches}
    print(json.dumps({"rank": rank, "wall_s": wall, "rows": len(res["rows"]),
                      "launches": launches}), flush=True)


def consolidate_phase(tmpl, dev, ptxas):
    """Kernel F against its plain twin at the sequencing and z-stack
    groups' shapes: keep masks bit for bit, the rounds (the launch's
    largest against the twin's over groups of images) equal, both timed;
    emits one "kernel_f" line a shape and returns the launches and the
    numbers at the z-stack's shape."""
    from fluorosequencingimageanalysis_torch.ops import consolidate as cons
    from fluorosequencingimageanalysis_torch.ops.background import (
        subtract_background_stack)
    from fluorosequencingimageanalysis_torch.ops.candidates import (
        find_candidates_batch)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality)
    from fluorosequencingimageanalysis_torch.utils import profiling
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_experiment_stack, make_zstack)

    seq = make_experiment_stack(8, 12, HW, HW, spots_per_field=2000)
    shapes = {
        "seqrun_group": (torch.from_numpy(seq.reshape(96, HW, HW)).to(dev),
                         EXP_K),
        "zstack_group": (subtract_background_stack(make_zstack(8),
                                                   device=dev), Z_K)}
    del seq
    out, launches = {}, 0
    for path, (images, k) in shapes.items():
        with torch.no_grad():
            hs, ws, valid, _ = find_candidates_batch(
                images, correlation_matrix=tmpl, max_candidates=k)
            fq = fit_quality(images, hs, ws, 60, 1)
        args = (fq[1], fq[2], fq[4], valid & ~(fq[4] < 0.7), 4.0)
        B, n = hs.shape
        group = max(1, cons._MAX_PAIRS // (n * n))
        parts = [cons._consolidate_group(*[a[lo:lo + group]
                                           for a in args[:4]], 4.0)
                 for lo in range(0, B, group)]
        want = torch.cat([m for m, _ in parts])
        want_rounds = max(r for _, r in parts)
        profiling.reset_counters()
        before = cons.consolidate.launches
        with profiling.tracing():
            got = cons.consolidate(*args)
        counts = profiling.counters()
        profiling.reset_counters()
        launches += cons.consolidate.launches - before
        differ = int((got != want).sum())
        check(differ == 0 and cons.consolidate.launches == before + 1 and
              counts["detect/consolidate_rounds"] == want_rounds,
              f"kernel F vs twin at {(B, n)}: {differ} keep flags differ, "
              f"rounds {counts} against {want_rounds}")
        ms = time_ms(lambda: cons.consolidate(*args), 20)
        plain = time_ms(lambda: cons.consolidate_plain(*args), 3)
        # Each fit's center, R^2 and valid flag read, its flag written.
        f_bound, f_by = bound(B * n * (3 * 4 + 1 + 1) + B * 4, 0)
        med = statistics.median(ms)
        out[path] = {"shape": [B, n], "max_abs_err": float(differ),
                     "kept": int(got.sum()), "valid": int(args[3].sum()),
                     "rounds": want_rounds, "ms": med,
                     "plain_ms": statistics.median(plain),
                     "bound_ms": f_bound, "bound_by": f_by,
                     "share_of_bound": f_bound / med, "ms_runs": ms,
                     "plain_ms_runs": plain}
        emit("kernel_f", path=path, **out[path], **ptxas["consolidate"])
        del images, hs, ws, valid, fq, args, want, got
    return {"launches": {"kernel_f_alone": {"consolidate": launches}},
            "kernels": {"consolidate": out["zstack_group"]}}


def headline_phases(tmpl, dev, ptxas, profile=False):
    """Kernels A and B against their twins at the headline shapes, the
    experiment step through ``Pipeline(device="cuda").run_stack``, the card
    against the CPU and the step's timing; emits the "kernel_a",
    "kernel_b", "slice", "card_vs_cpu" and "timing" lines (and "profile"
    with ``profile``) and returns the kernels' launches per step and their
    numbers at these shapes."""
    from fluorosequencingimageanalysis_torch.api import Pipeline
    from fluorosequencingimageanalysis_torch.config import (
        DetectConfig, PhotometryConfig, PipelineConfig, RegistrationConfig)
    from fluorosequencingimageanalysis_torch.ops.candidates import (
        _threshold_and_extract_batch, find_candidates_batch)
    from fluorosequencingimageanalysis_torch.ops.consolidate import (
        consolidate)
    from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
        candidate_map_fused, candidate_map_plain)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality)
    from fluorosequencingimageanalysis_torch.ops.photometry import (
        mexican_hat_batch)
    from fluorosequencingimageanalysis_torch.ops.registration import (
        phase_correlate_stack)
    from fluorosequencingimageanalysis_torch.parallel.mesh import (
        experiment_step)
    from fluorosequencingimageanalysis_torch.utils.convert import step_kwargs
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_stack, recall)

    # Kernel A against its twin.
    stack, spots = make_stack(F, C, HW, HW)
    imgs = torch.from_numpy(stack.reshape(F * C, HW, HW)).to(dev)
    # The median is exact and the taps keep the twin's FMA order: the
    # kernel must equal the twin bit for bit.
    cm_k = candidate_map_fused(imgs, tmpl)
    cm_p = candidate_map_plain(imgs, tmpl)
    torch.cuda.synchronize()
    err_a = float((cm_k - cm_p).abs().max())
    check(err_a == 0.0,
          f"kernel A vs twin at {tuple(imgs.shape)} (max abs err {err_a})")
    a_ms = time_ms(lambda: candidate_map_fused(imgs, tmpl), 20)
    a_plain_ms = time_ms(lambda: candidate_map_plain(imgs, tmpl), 10)
    sweep = []
    for i, (h, w) in enumerate(SWEEP):
        x = torch.from_numpy(planted(h, w, i)).to(dev)
        k, p = candidate_map_fused(x, tmpl), candidate_map_plain(x, tmpl)
        e = float((k - p).abs().max())
        check(e == 0.0, f"kernel A vs twin at {(h, w)} (max abs err {e})")
        sweep.append({"shape": [h, w], "max_abs_err": e})
    a_bound, a_by = bound(2 * imgs.numel() * 4,
                          imgs.numel() * A_OPS_PER_PIXEL)
    a_med = statistics.median(a_ms)
    emit("kernel_a", shape=list(imgs.shape), max_abs_err=err_a,
         ms_median=a_med, plain_ms_median=statistics.median(a_plain_ms),
         bound_ms=a_bound, bound_by=a_by, share_of_bound=a_bound / a_med,
         **ptxas["candidate_map"], ms_runs=a_ms, plain_ms_runs=a_plain_ms,
         sweep=sweep)

    # Kernel B against its twin on every candidate of the headline step.
    hs, ws, valid, _ = _threshold_and_extract_batch(cm_p, MAX_CANDIDATES,
                                                    2.0)
    b_report = {ts: kernel_b_report(imgs, hs, ws, valid, NUM_ITERS, ts,
                                    reps=10, plain_reps=3)
                for ts in (1, 2)}
    for ts, rep in b_report.items():
        emit("kernel_b", theta_starts=ts, num_iters=NUM_ITERS,
             **rep, **ptxas["fit_quality"])
    err_b = max(rep["max_abs_err_all_outputs"] for rep in b_report.values())

    # The slice on the card, through the user's entry point.
    cfg = PipelineConfig(
        detect=DetectConfig(max_candidates=MAX_CANDIDATES,
                            num_iters=NUM_ITERS),
        registration=RegistrationConfig(upsample_factor=UPSAMPLE),
        photometry=PhotometryConfig(method="mexican_hat"))
    pipe = Pipeline(cfg, device="cuda")
    candidate_map_fused.launches = 0
    fit_quality.launches = 0
    consolidate.launches = 0
    out = pipe.run_stack(stack)
    launches = {"candidate_map": candidate_map_fused.launches,
                "fit_quality": fit_quality.launches,
                "consolidate": consolidate.launches}
    check(launches["candidate_map"] > 0 and launches["fit_quality"] > 0
          and launches["consolidate"] == 1,
          f"kernels A and B launched in the slice, F once: {launches}")
    S = out["spot_h"].shape[-1]
    dims = {"F": F, "C": C, "K": MAX_CANDIDATES, "S": S, "7": 7}
    check(set(out) == set(SCHEMA), f"output keys {sorted(out)}")
    for k, (shape, dtype) in SCHEMA.items():
        want = tuple(dims[c] for c in shape)
        check(out[k].shape == want and out[k].dtype.name == dtype,
              f"{k}: {out[k].shape} {out[k].dtype}, want {want} {dtype}")
    for k in ("params", "center_h", "spot_h", "photometry"):
        v = out["keep"] if out[k].shape[2] == MAX_CANDIDATES \
            else out["spot_valid"]
        check(np.isfinite(out[k][v]).all(), f"{k} finite where kept")
    rec = recall(spots, out, tol=1.0)
    check(rec >= 0.95, f"recall of planted spots within 1 px: {rec}")
    emit("slice", launches=launches, recall_1px=rec,
         recall_0p2px=recall(spots, out, tol=0.2),
         spot_count_mean=float(out["spot_count"].mean()),
         cand_count_mean=float(out["cand_count"].mean()),
         overflow_images=int(out["spot_overflow"].sum()))

    # Card against CPU (plain path) on a reduced stack.
    small, _ = make_stack(2, 2, HW, HW, seed=1)
    gpu = pipe.run_stack(small)
    cpu = Pipeline(cfg, device="cpu").run_stack(small)
    xs = torch.from_numpy(small.reshape(4, HW, HW))
    cg = find_candidates_batch(xs.to(dev), max_candidates=MAX_CANDIDATES)
    cc = find_candidates_batch(xs, max_candidates=MAX_CANDIDATES)
    overlaps, matched = [], []
    for i in range(4):
        sg = {(int(a), int(b)) for a, b, v in zip(*(t[i].cpu() for t in
                                                    cg[:3])) if v}
        sc = {(int(a), int(b)) for a, b, v in zip(*(t[i] for t in cc[:3]))
              if v}
        overlaps.append(len(sg & sc) / max(len(sg | sc), 1))
        f, c = divmod(i, 2)
        vg, vc = gpu["spot_valid"][f, c], cpu["spot_valid"][f, c]
        pg = np.stack([gpu["spot_h"][f, c][vg], gpu["spot_w"][f, c][vg]], 1)
        pc = np.stack([cpu["spot_h"][f, c][vc], cpu["spot_w"][f, c][vc]], 1)
        d = np.abs(pc[:, None, :] - pg[None, :, :]).max(-1).min(1)
        matched.append(float(np.mean(d <= B_CENTER)))
    check(min(overlaps) >= 0.99, f"candidate set overlap {overlaps}")
    check(min(matched) >= 0.99,
          f"share of CPU kept spots with a card spot within 1e-3 px "
          f"{matched}")
    check(np.array_equal(gpu["offsets_h"], cpu["offsets_h"]) and
          np.array_equal(gpu["offsets_w"], cpu["offsets_w"]),
          "offsets equal on card and CPU")
    emit("card_vs_cpu", shape=list(small.shape), cand_overlap=overlaps,
         kept_matched_1e3=matched,
         spot_count_card=gpu["spot_count"].ravel().tolist(),
         spot_count_cpu=cpu["spot_count"].ravel().tolist())

    # Timing of the step (upload, compute and download) and its stages.
    x_host = stack
    steps = []
    pipe.run_stack(x_host)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipe.run_stack(x_host)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(steps)
    xs = torch.from_numpy(stack).to(dev)
    stage_ms = {
        "registration": statistics.median(time_ms(
            lambda: phase_correlate_stack(xs, UPSAMPLE), 5)),
        "candidate_map_kernel": statistics.median(a_ms),
        "extraction": statistics.median(time_ms(
            lambda: _threshold_and_extract_batch(cm_k, MAX_CANDIDATES, 2.0),
            5)),
        "fit_quality_kernel": b_report[1]["ms_median"],
    }
    fq = fit_quality(imgs, hs, ws, NUM_ITERS, 1)
    passed = valid & ~(fq[4] < 0.7)
    stage_ms["consolidate"] = statistics.median(time_ms(
        lambda: consolidate(fq[1], fq[2], fq[4], passed, 4.0), 5))
    rch = torch.randint(9, HW - 9, (F * C, 512), device=dev,
                        dtype=torch.int32)
    stage_ms["mexican_hat_photometry"] = statistics.median(time_ms(
        lambda: mexican_hat_batch(imgs, rch, rch), 5))
    kw = step_kwargs(cfg)
    host = torch.from_numpy(stack)
    pinned = host.pin_memory()
    with torch.no_grad():
        dev_out = experiment_step(xs, **kw)
        split_ms = {
            "upload_pageable": host_ms(lambda: host.to(dev), 5),
            "upload_pinned": host_ms(
                lambda: pinned.to(dev, non_blocking=True), 5),
            "device_step": host_ms(lambda: experiment_step(xs, **kw), 5),
            "download": host_ms(
                lambda: [v.cpu() for v in dev_out.values()], 5),
        }
    emit("timing", step_s_median=step_s, step_s_runs=steps,
         images_per_s=F * C / step_s, fields_per_s=F / step_s,
         peak_mem_bytes=int(peak), stage_ms=stage_ms, split_ms=split_ms,
         note="step = run_stack from a host numpy stack to host numpy "
              "outputs; stage times are device times of each stage alone; "
              "split_ms are host-clock medians of the step's parts")

    # Optional: where the device's time goes within run_stack.
    if profile:
        prof = profile_steps(lambda: pipe.run_stack(x_host), 3)
        prof["device_busy_ms_per_step"] = prof["device_busy_us"] / 3e3
        # The profiler slows the host; the same device work over the
        # unprofiled step time estimates the share without that overhead.
        prof["device_busy_share_of_unprofiled_step"] = (
            prof["device_busy_ms_per_step"] / (step_s * 1e3))
        emit("profile", **prof)

    b1 = b_report[1]
    return {
        "launches": launches,
        "kernels": {
            "candidate_map": {
                "max_abs_err": err_a, "ms": a_med,
                "plain_ms": statistics.median(a_plain_ms),
                "bound_ms": a_bound, "bound_by": a_by,
                "share_of_bound": a_bound / a_med},
            "fit_quality": {
                "max_abs_err": err_b, "ms": b1["ms_median"],
                "plain_ms": b1["plain_ms_median"],
                "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
                "share_of_bound": b1["share_of_bound"]}}}


def host_profile(pipe, stack, kw, top=15):
    """cProfile of run_experiment's host half for one group, run alone on
    this thread (no step beside it): the spot lists, linking, fill-in,
    hole gathers and rows, then the track CSV of those rows. Emits the
    cumulative time of each piece and the functions with the most own
    time."""
    import cProfile
    import pstats

    from fluorosequencingimageanalysis_torch.api import (EXPERIMENT_KEYS,
                                                         GROUP_FIELDS)
    from fluorosequencingimageanalysis_torch.pipeline import (
        fast_experiment as fe)

    out, grp, _ = next(pipe._stack_step_groups(
        torch.from_numpy(stack[:GROUP_FIELDS]), EXPERIMENT_KEYS, **kw))
    cfg = pipe.config.photometry
    Fg, C = out["offsets_h"].shape
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    rhs, rws, values = fe._spot_lists(out, Fg, C)
    queue = []
    per_field = fe.run_experiment_stack(
        grp, out["offsets_h"], out["offsets_w"], (rhs, rws), values,
        photometry_method=cfg.method, photometry_radius=cfg.radius,
        photometry_brim=cfg.brim_size, hole_queue=queue)
    fe.flush_hole_queue(queue)
    rows = [("ch1", f, h0, w0, cat, ph)
            for f, field_rows in enumerate(per_field)
            for (cat, h0, w0, ph) in field_rows]
    with tempfile.TemporaryDirectory() as tmp:
        fe.write_track_rows_csv(rows, C, os.path.join(tmp, "t.csv"))
    prof.disable()
    wall = time.perf_counter() - t
    stats = pstats.Stats(prof).stats
    pieces = ("_spot_lists", "_link_field", "greedy_link", "_fill_traces",
              "_lookup_spot_values", "_queue_photometry", "_rows_by_field",
              "flush_hole_queue", "write_track_rows_csv")
    cum = dict.fromkeys(pieces, 0.0)
    for (_, _, fn), (_, _, _, ct, _) in stats.items():
        if fn in cum:
            cum[fn] += ct
    own = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    emit("experiment_host_profile", fields=Fg, rows=len(rows),
         wall_s_profiled=wall, cumulative_s=cum,
         top_own_s=[[f"{fn} ({os.path.basename(file)}:{line})", tt]
                    for (file, line, fn), (_, _, tt, _, _) in own],
         note="cProfile adds cost to every Python call: read the shares, "
              "not the totals")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace three steps with torch.profiler and "
                         "profile the experiment's host half with cProfile")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated groups of phases to run, of "
                         + ", ".join(PHASES) + " (default: all of them)")
    ap.add_argument("--multihost-child", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.multihost_child is not None:
        return multihost_child(args.multihost_child)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown or not phases:
        raise SystemExit(f"chip_smoke: --phases takes names of {PHASES}, "
                         f"got {args.phases!r}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    from fluorosequencingimageanalysis_torch import _build
    from fluorosequencingimageanalysis_torch.ops.candidates import (
        DEFAULT_CORRELATION_MATRIX)

    dev = torch.device("cuda")
    tmpl = DEFAULT_CORRELATION_MATRIX

    # Device and build: one compiler per source (nvcc for the kernels, g++
    # for the tracker, the two step-fit cores and the CSV parser), all
    # started together.
    t0 = time.perf_counter()
    _build.build_all(KERNELS + HOST_CORES)
    for name in KERNELS + HOST_CORES:
        _build.load(name)
    build_s = time.perf_counter() - t0
    ptxas = {name: _build.ptxas_info(name) for name in KERNELS}
    smi = nvidia_smi_line()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], build_s=build_s, ptxas=ptxas,
         phases=phases)

    # Each group sets the kernels' launch counts to 0 just before it drives
    # its path and reads them just after.
    done = {}
    if "headline" in phases:
        done["headline"] = headline_phases(tmpl, dev, ptxas,
                                           profile=args.profile)
    if "consolidate" in phases:  # kernel F alone at the paths' shapes
        done["consolidate"] = consolidate_phase(tmpl, dev, ptxas)
    if "experiment" in phases:  # config 4
        done["experiment"] = experiment_phase(tmpl, dev,
                                              profile_host=args.profile)
    stack4 = done.get("experiment", {}).pop("stack", None)
    if "objects" in phases:  # the class path on config 4's first fields
        done["objects"] = objects_phases(tmpl, dev, stack4)
    if "zstack" in phases:  # config 2 and the single-image front door
        done["zstack"] = zstack_phases(tmpl, dev)
    if "timetrace" in phases:  # the movie and config 3
        done["timetrace"] = timetrace_phases(tmpl, dev)
    if "fluor" in phases:  # config 5
        done["fluor"] = fluor_phases(
            dev, ptxas, done.get("experiment", {}).get("track_csv"))
    if "sim" in phases:  # simulation and the Monte-Carlo detector
        done["sim"] = sim_phases(tmpl, dev, ptxas)
    if "mixtures" in phases:  # the per-cycle mixtures and batched fitters
        done["mixtures"] = mixtures_phases(dev, ptxas)
    gmm_phot = done.get("mixtures", {}).pop("photometries", None)
    if "parallel" in phases:  # the sharded step, a device list, multihost
        done["parallel"] = parallel_phases(
            dev, stack4, done.get("fluor", {}).get("calibrated"), gmm_phot)
    if "files" in phases:  # the file front doors, nothing patched
        done["files"] = files_phases(tmpl, dev, stack4)

    print(smi, flush=True)
    print(json.dumps({"kernels": kernel_summary(done, ptxas)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def kernel_summary(done, ptxas):
    """One entry per kernel that a group of this run drove. The top-level
    numbers of kernels A and B are the headline step's (or, where that
    group did not run, the first path's that did); each other path's
    launches and numbers follow under its own name. Kernel F's launches
    are those of the headline step, run_experiment and run_zstack (the
    first that ran is the top-level count), its numbers the consolidate
    group's at the z-stack group's shape; its launches alone there are
    ``launches_kernel_f_alone``. No single PyTorch call
    computes any of the six functions: ``library_ms`` is null (kernel
    C's nearest composition of library calls is timed beside it as
    ``matmul_composition_ms``)."""
    meta = {
        "candidate_map": (
            "fluorosequencingimageanalysis_torch/csrc/candidate_map.cu",
            "fluorosequencingimageanalysis_tpu/ops/pallas_candidates.py:100"),
        "fit_quality": (
            "fluorosequencingimageanalysis_torch/csrc/fit_quality.cu",
            "fluorosequencingimageanalysis_tpu/models/detect.py:36"),
        "v8_score": (
            "fluorosequencingimageanalysis_torch/csrc/v8_score.cu",
            "fluorosequencingimageanalysis_tpu/ops/lognormal.py:60"),
        "mc_fit": (
            "fluorosequencingimageanalysis_torch/csrc/mc_fit.cu",
            "fluorosequencingimageanalysis_tpu/models/detect.py:762"),
        "gmm_em": (
            "fluorosequencingimageanalysis_torch/csrc/gmm_em.cu",
            "fluorosequencingimageanalysis_tpu/ops/gmm_batch.py:54"),
        "consolidate": (
            "fluorosequencingimageanalysis_torch/csrc/consolidate.cu",
            "fluorosequencingimageanalysis_tpu/ops/consolidate.py:56"),
    }
    # {kernel: [(path, launches, numbers), ...]} in the order of the run.
    paths = {name: [] for name in meta}
    for name in ("candidate_map", "fit_quality"):
        if "headline" in done:
            h = done["headline"]
            paths[name].append(("headline", h["launches"][name],
                                h["kernels"][name]))
        if "experiment" in done:
            e = done["experiment"]
            paths[name].append(("experiment", e["launches"][name],
                                e["kernels"][name]))
        for group, first in (("objects", "objects"),
                             ("zstack", "zstack_group"),
                             ("timetrace", "timetrace")):
            if group in done:
                g = done[group]
                by_path = g["kernels"][name]
                paths[name].append((first, g["launches"][group][name],
                                    by_path[first]))
        if "files" in done:
            g = done["files"]
            paths[name].append((
                "files", g["launches"]["files_run_experiment"][name],
                g["kernels"][name]["files"]))
    if "fluor" in done:
        f = done["fluor"]
        paths["v8_score"].append(("v8", f["launches"]["v8"]["v8_score"],
                                  f["kernels"]["v8_score"]))
    if "sim" in done:
        g = done["sim"]
        for name in ("mc_fit", "candidate_map"):
            paths[name].append(("mc_detect",
                                g["launches"]["mc_detect"][name],
                                g["kernels"][name]["mc_detect"]))
    if "consolidate" in done:
        # Kernel F's launches are the main paths' runs; its numbers are
        # the consolidate group's, which times it alone.
        alone = done["consolidate"]["kernels"]["consolidate"]
        if "headline" in done:
            paths["consolidate"].append((
                "headline", done["headline"]["launches"]["consolidate"],
                alone))
        if "experiment" in done:
            paths["consolidate"].append((
                "experiment", done["experiment"]["launches"]["consolidate"],
                alone))
        if "zstack" in done:
            paths["consolidate"].append((
                "zstack", done["zstack"]["launches"]["zstack"]["consolidate"],
                alone))
        if not paths["consolidate"]:
            paths["consolidate"].append(("kernel_f_alone", None, alone))
    if "mixtures" in done:
        g = done["mixtures"]
        paths["gmm_em"].append((
            "per_cycle_gmm", g["launches"]["per_cycle_gmm"]["gmm_em"],
            g["kernels"]["gmm_em"]))
    out = []
    for name, (source, replaces) in meta.items():
        if not paths[name]:
            continue
        _, launches, top = paths[name][0]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches,
                 **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by")},
                 "library_ms": None, "share_of_bound": top["share_of_bound"],
                 **ptxas[name]}
        if name in ("v8_score", "mc_fit", "gmm_em", "consolidate"):
            entry.update({k: v for k, v in top.items() if k not in entry})
        if "experiment" in done and name in ("candidate_map", "fit_quality"):
            entry["launches_experiment"] = \
                done["experiment"]["launches"][name]
            entry["experiment"] = done["experiment"]["kernels"][name]
        if name == "consolidate":
            for path, n, _ in paths[name]:
                entry["launches_" + path] = n
        for group in ("objects", "zstack", "timetrace", "fluor", "sim",
                      "mixtures", "parallel", "files", "consolidate"):
            if group not in done:
                continue
            for path, n in done[group]["launches"].items():
                if name in n:
                    entry["launches_" + path] = n[name]
            if group not in ("fluor", "mixtures") and \
                    name in done[group]["kernels"]:
                entry.update(done[group]["kernels"][name])
        out.append(entry)
    return out


if __name__ == "__main__":
    main()
