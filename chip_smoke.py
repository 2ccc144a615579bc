#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # every check, the step's timing
    python3 chip_smoke.py --profile    # also a torch.profiler trace of it

Builds the hand-written kernels from csrc/ (nvcc, sm_90a, one process per
source, all at once) and reads ptxas's registers and spills for each,
checks each against its plain PyTorch twin on the card (kernel A bit for
bit, kernel B's parameters bit for bit), times each beside its bound
(bytes over the memory rate or operations over the float32 rate), drives
the experiment step through ``Pipeline(device="cuda").run_stack`` on the
headline stack (8 fields x 4 cycles of 512x512, ~200 planted spots per
field, max_candidates=2048, num_iters=40, upsample_factor=20, mexican-hat
photometry) and checks its output, compares the card with the CPU on a
reduced stack, and times the step and its split into upload, device step
and download; ``--profile`` adds the device's busy share and its largest
operations over three steps. Prints one JSON line per phase, then
the nvidia-smi name/power-limit line, the kernel summary and, last,
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero; so is a process that sees no CUDA device. Imports no jax.
"""

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

F, C, HW = 8, 4, 512
MAX_CANDIDATES, NUM_ITERS, UPSAMPLE = 2048, 40, 20
B_CENTER, B_R2, B_RMSE_REL, B_MODEL = 1e-3, 1e-4, 1e-4, 1e-3
SWEEP = [(48, 100), (33, 257), (70, 130), (96, 384)]
KERNELS = ("candidate_map", "fit_quality")

# Published peaks of one H100 SXM at its 700 W limit: float32 outside the
# tensor cores (an FMA counts 2) and HBM3 bandwidth.
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
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


def nvidia_smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, "nvidia-smi ran: " + proc.stderr)
    return proc.stdout.strip().splitlines()[0]


def planted(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(400, 10, (h, w)).astype(np.float32)
    hh, ww = np.indices((h, w)).astype(np.float32)
    img += 3000 * np.exp(-(((hh - h // 2) ** 2) + ((ww - w // 2) ** 2)) / 3.0)
    return img


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace three steps with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    from fluorosequencingimageanalysis_torch import _build
    from fluorosequencingimageanalysis_torch.api import Pipeline
    from fluorosequencingimageanalysis_torch.config import (
        DetectConfig, PhotometryConfig, PipelineConfig, RegistrationConfig)
    from fluorosequencingimageanalysis_torch.ops.candidates import (
        DEFAULT_CORRELATION_MATRIX, _threshold_and_extract_batch,
        find_candidates_batch, gather_patches)
    from fluorosequencingimageanalysis_torch.ops.consolidate import (
        consolidate)
    from fluorosequencingimageanalysis_torch.ops.fused_candidates import (
        candidate_map_fused, candidate_map_plain)
    from fluorosequencingimageanalysis_torch.ops.fused_fit import (
        fit_quality, fit_quality_plain)
    from fluorosequencingimageanalysis_torch.ops.gaussian import (
        gauss2d_image)
    from fluorosequencingimageanalysis_torch.ops.photometry import (
        mexican_hat_batch)
    from fluorosequencingimageanalysis_torch.ops.registration import (
        phase_correlate_stack)
    from fluorosequencingimageanalysis_torch.parallel.mesh import (
        experiment_step)
    from fluorosequencingimageanalysis_torch.utils.convert import step_kwargs
    from fluorosequencingimageanalysis_torch.utils.synth import (
        make_stack, recall)

    dev = torch.device("cuda")
    tmpl = DEFAULT_CORRELATION_MATRIX

    # 1. Device and build: one nvcc per source, all started together.
    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    for name in KERNELS:
        _build.load(name)
    build_s = time.perf_counter() - t0
    ptxas = {name: _build.ptxas_info(name) for name in KERNELS}
    smi = nvidia_smi_line()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], build_s=build_s, ptxas=ptxas)

    # 2. Kernel A against its twin.
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

    # 3. Kernel B against its twin on every candidate of the headline step.
    hs, ws, valid, _ = _threshold_and_extract_batch(cm_p, MAX_CANDIDATES,
                                                    2.0)
    patch_max = gather_patches(imgs, hs, ws).abs().amax(dim=(-2, -1))
    b_report = {}
    err_b = 0.0
    for ts in (1, 2):
        got = fit_quality(imgs, hs, ws, NUM_ITERS, ts)
        ref = fit_quality_plain(imgs, hs, ws, NUM_ITERS, ts)
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
              and stats["over_rmse_tol"] == 0
              and stats["over_model_tol"] == 0,
              f"kernel B vs twin, theta_starts={ts}: {stats}")
        err_b = max(err_b, stats["max_abs_err_all_outputs"])
        ms = time_ms(lambda: fit_quality(imgs, hs, ws, NUM_ITERS, ts), 10)
        plain = time_ms(
            lambda: fit_quality_plain(imgs, hs, ws, NUM_ITERS, ts), 3)
        # Per fit: its 25 pixels and 2 coordinates in, 12 floats out.
        fits = hs.numel()
        b_bound, b_by = bound(
            fits * (25 * 4 + 2 * 4 + 12 * 4),
            fits * min(ts, 2) * NUM_ITERS *
            (25 * B_FLOPS_PER_PIXEL_ITER + B_FLOPS_SOLVE))
        b_med = statistics.median(ms)
        b_report[ts] = dict(stats, ms_median=b_med,
                            plain_ms_median=statistics.median(plain),
                            bound_ms=b_bound, bound_by=b_by,
                            share_of_bound=b_bound / b_med,
                            **ptxas["fit_quality"], ms_runs=ms,
                            plain_ms_runs=plain)
        emit("kernel_b", theta_starts=ts, num_iters=NUM_ITERS,
             **b_report[ts])

    # 4. The slice on the card, through the user's entry point.
    cfg = PipelineConfig(
        detect=DetectConfig(max_candidates=MAX_CANDIDATES,
                            num_iters=NUM_ITERS),
        registration=RegistrationConfig(upsample_factor=UPSAMPLE),
        photometry=PhotometryConfig(method="mexican_hat"))
    pipe = Pipeline(cfg, device="cuda")
    candidate_map_fused.launches = 0
    fit_quality.launches = 0
    out = pipe.run_stack(stack)
    launches = {"candidate_map": candidate_map_fused.launches,
                "fit_quality": fit_quality.launches}
    check(all(n > 0 for n in launches.values()),
          f"both kernels launched in the slice: {launches}")
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

    # 5. Card against CPU (plain path) on a reduced stack.
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

    # 6. Timing of the step (upload, compute and download) and its stages.
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

    # 7. Optional: where the device's time goes within run_stack.
    if args.profile:
        prof = profile_steps(lambda: pipe.run_stack(x_host), 3)
        prof["device_busy_ms_per_step"] = prof["device_busy_us"] / 3e3
        # The profiler slows the host; the same device work over the
        # unprofiled step time estimates the share without that overhead.
        prof["device_busy_share_of_unprofiled_step"] = (
            prof["device_busy_ms_per_step"] / (step_s * 1e3))
        emit("profile", **prof)

    print(smi, flush=True)
    # No single PyTorch call computes either function: library_ms is null.
    kernels = [
        {"name": "candidate_map", "route": "cuda",
         "source": "fluorosequencingimageanalysis_torch/csrc/"
                   "candidate_map.cu",
         "replaces": "fluorosequencingimageanalysis_tpu/ops/"
                     "pallas_candidates.py:100",
         "launches": launches["candidate_map"], "max_abs_err": err_a,
         "ms": a_med, "plain_ms": statistics.median(a_plain_ms),
         "bound_ms": a_bound, "bound_by": a_by, "library_ms": None,
         "share_of_bound": a_bound / a_med, **ptxas["candidate_map"]},
        {"name": "fit_quality", "route": "cuda",
         "source": "fluorosequencingimageanalysis_torch/csrc/fit_quality.cu",
         "replaces": "fluorosequencingimageanalysis_tpu/models/"
                     "detect.py:36",
         "launches": launches["fit_quality"], "max_abs_err": err_b,
         "ms": b_report[1]["ms_median"],
         "plain_ms": b_report[1]["plain_ms_median"],
         "bound_ms": b_report[1]["bound_ms"],
         "bound_by": b_report[1]["bound_by"], "library_ms": None,
         "share_of_bound": b_report[1]["share_of_bound"],
         **ptxas["fit_quality"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
