"""The port's CLI front door: ``python -m fluorosequencingimageanalysis_torch``.

Counterpart of fluorosequencingimageanalysis_tpu/__main__.py over the
port's api.Pipeline, with the subcommands whose paths the port has, the
same flags and the same JSON summaries, plus ``--device`` (default cuda)
on the subcommands that use a device; run-experiment, zstack, timetrace,
stepfit and fluor-counts also take a comma-separated list of devices and
shard over it, as the JAX CLI shards over every local device:

    python -m fluorosequencingimageanalysis_torch run-experiment \\
        --peptide-files cycle_*/field_*.png --output-dir out
    python -m fluorosequencingimageanalysis_torch detect field.tif
    python -m fluorosequencingimageanalysis_torch zstack frames.npy \\
        --output spots.csv
    python -m fluorosequencingimageanalysis_torch timetrace \\
        --frames movie.tif --output-dir out
    python -m fluorosequencingimageanalysis_torch stepfit tracks.csv
    python -m fluorosequencingimageanalysis_torch fluor-counts \\
        out/track_photometries.csv --beta 30000 --beta-sigma 0.2 \\
        --signals-pkl out/SIGNALS.pkl
    python -m fluorosequencingimageanalysis_torch background-correct \\
        out/SIGNALS.pkl --control-pkls c1.pkl c2.pkl --num-cycles 12
    python -m fluorosequencingimageanalysis_torch remainder-correct \\
        out/track_photometries.csv
    python -m fluorosequencingimageanalysis_torch simulate \\
        ACKDYECAGKHSECAMKR K --num-sims 100000 --results-pkl sims.pkl

run-experiment groups files by the reference's directory=cycle,
filename=field convention (flexlibrary.py:1105-1154), runs the one-call
array-native path (registration + detect/fit + tracking + interpolation +
categories), and writes the track-photometries and category-counts CSVs.
detect writes the psfs pkl/csv/png artifacts next to each image; zstack
writes a per-spot CSV; timetrace runs the movie workflow (detect, LC
tracking, photometry, step fits) and writes the timetrace CSV; stepfit
step-fits the traces of a track CSV or an .npy matrix and writes the
per-frame step-fit CSV; fluor-counts runs the v8 lognormal fit over a track
CSV (manual beta, or --auto-calibrate) and prints the counts;
background-correct and remainder-correct are host code and take no
--device; simulate runs the batched Monte-Carlo dye simulation and prints
the commonest dye-decrement patterns. Raw uint16 images upload as-is and
are cast on the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys

import numpy as np

from ._device import data_devices


def _devices(text, many=True):
    """``--device`` as the Pipeline takes it: one device or, where the
    subcommand's method shards (``many``), a comma-separated list of them
    (``cuda:0,cuda:1``; the counterpart of the JAX CLI's default mesh over
    every local device)."""
    names = [d.strip() for d in text.split(",") if d.strip()]
    if not names:
        raise SystemExit(f"--device: no device in {text!r}")
    if len(names) > 1 and not many:
        raise SystemExit(f"--device: this subcommand runs on one device, "
                         f"got {text!r}")
    return names if len(names) > 1 else names[0]


def _method_override(args):
    """--photometry-method as a from_cli override, only when given.

    The flag default is None so an explicit ``'method'`` key inside
    --photometry-parameters (the reference's dict surface,
    basic_experiment_script.py:150-158) is honored instead of being
    silently clobbered by the flag's default."""
    if args.photometry_method is None:
        return {}
    return {"method": args.photometry_method}


def _cmd_run_experiment(args):
    from .api import Pipeline
    from .config import DetectConfig, PhotometryConfig, PipelineConfig
    from .pipeline.files import FileLayoutError

    store = None
    if args.store:
        from .utils.checkpoint import ArtifactStore
        store = ArtifactStore(args.store)
    config = PipelineConfig(
        detect=DetectConfig.from_cli(args.detect_parameters),
        photometry=PhotometryConfig.from_cli(
            args.photometry_parameters, **_method_override(args)))
    pipe = Pipeline(config=config, device=_devices(args.device),
                    store=store, profile=args.profile)
    os.makedirs(args.output_dir, exist_ok=True)
    csv_path = os.path.join(args.output_dir, args.csv)
    category_csv_path = os.path.join(args.output_dir, args.category_csv)
    try:
        out = pipe.run_experiment_files(
            args.peptide_files, args.second_channel_files,
            csv_path=csv_path, category_csv_path=category_csv_path,
            category_csv_filtered=not args.all_categories,
            category_csv_collate_fields=args.collate_fields,
            max_candidates=args.max_candidates, max_spots=args.max_spots,
            mdma=args.mdma, save_averages=args.save_averages,
            keep_invalid=args.keep_invalid,
            remainder_threshold=args.remainder_threshold,
            dispatch=args.dispatch)
    except FileLayoutError as e:
        raise SystemExit(str(e)) from None
    if args.offsets_pkl:
        with open(os.path.join(args.output_dir, args.offsets_pkl),
                  "wb") as fh:
            pickle.dump({ch: (np.asarray(oh), np.asarray(ow))
                         for ch, (oh, ow) in out["offsets"].items()}, fh)
    n_fields, n_cycles = out["offsets"]["ch1"][0].shape
    summary = {"fields": int(n_fields), "cycles": int(n_cycles),
               "channels": sorted(out["offsets"]),
               "rows": len(out["rows"]),
               "summary": out["summary"],
               "csv": csv_path, "category_csv": category_csv_path}
    if args.profile:
        from .utils import profiling
        summary["stages_sec"] = {k: round(v["total"], 3)
                                 for k, v in profiling.timings().items()}
    print(json.dumps(summary, default=str))
    return 0


def _cmd_detect(args):
    """Spot finding + PSF fitting over image files, writing the
    reference's psfs artifacts (<image>_psfs_<hash>.{pkl,csv,png}) —
    the basic_image_script workflow on the device detector."""
    from .batch import image_batch

    params = {"device": _devices(args.device, many=False)}
    if args.max_candidates is not None:
        params["max_candidates"] = args.max_candidates
    if args.c_std is not None:
        params["c_std"] = args.c_std
    if args.r2_threshold is not None:
        params["r_2_threshold"] = args.r2_threshold
    processed = image_batch(args.images, find_peptides_parameters=params)
    spot_counts = {}
    for image_path, (converted, pkl_path, _csv, _png) in processed.items():
        with open(pkl_path, "rb") as fh:
            spot_counts[image_path] = len(pickle.load(fh))
    print(json.dumps({
        "images": len(args.images), "processed": len(processed),
        "spots": spot_counts,
        "artifacts": {p: list(t[1:]) for p, t in processed.items()}},
        default=str))
    return 0 if len(processed) == len(set(map(os.path.abspath,
                                              args.images))) else 1


def _cmd_zstack(args):
    """Background estimation + batched PSF fits over a z/time stack:
    per-frame SExtractor mesh backgrounds estimated and subtracted on the
    device, then batched detect + fit over the frames
    (api.Pipeline.run_zstack). Writes a per-spot CSV and,
    optionally, the background maps as .npy."""
    import csv as csv_module

    from .api import Pipeline
    from .config import DetectConfig, PipelineConfig
    from .utils.imageio import read_stack_array

    if len(args.frames) == 1 and args.frames[0].endswith(".npy"):
        stack = np.load(args.frames[0])
        if stack.ndim != 3:
            raise SystemExit("--frames .npy must hold a [T, H, W] stack")
    else:
        # One multi-page TIFF or a list of per-frame files.
        stack = np.concatenate([read_stack_array(p) for p in args.frames])
    overrides = {}
    if args.max_candidates is not None:
        overrides["max_candidates"] = args.max_candidates
    if args.c_std is not None:
        overrides["c_std"] = args.c_std
    if args.r2_threshold is not None:
        overrides["r_2_threshold"] = args.r2_threshold
    det = dataclasses.replace(DetectConfig(), **overrides)
    store = None
    if args.store:
        from .utils.checkpoint import ArtifactStore
        store = ArtifactStore(args.store)
    pipe = Pipeline(PipelineConfig(detect=det),
                    device=_devices(args.device), store=store)
    out = pipe.run_zstack(stack, box_size=args.box_size,
                          filter_size=args.filter_size,
                          return_background=args.background_npy is not None)
    if args.background_npy is not None:
        np.save(args.background_npy, out["background"])
    n_spots = 0
    with open(args.output, "w", newline="") as fh:
        w = csv_module.writer(fh)
        w.writerow(["FRAME", "H", "W", "AMPLITUDE", "SIGMA_H", "SIGMA_W",
                    "THETA", "RMSE", "R_2", "S_N"])
        for t in range(stack.shape[0]):
            for i in np.nonzero(out["keep"][t])[0]:
                p = out["params"][t, i]
                w.writerow([t, out["center_h"][t, i], out["center_w"][t, i],
                            p[1], p[4], p[5], p[6], out["rmse"][t, i],
                            out["r2"][t, i], out["s_n"][t, i]])
                n_spots += 1
    print(json.dumps({
        "frames": int(stack.shape[0]), "spots": n_spots,
        "candidates_per_frame": out["cand_count"].tolist(),
        "output": args.output, "background_npy": args.background_npy},
        default=str))
    return 0


def _cmd_timetrace(args):
    from .api import Pipeline
    from .config import PipelineConfig, PhotometryConfig
    from .utils.imageio import read_stack_array

    # One multi-page TIFF or a list of per-frame files; read_stack_array
    # returns (frames, H, W) either way.
    movie = np.concatenate([read_stack_array(p) for p in args.frames])
    config = PipelineConfig(
        photometry=PhotometryConfig.from_cli(
            args.photometry_parameters, **_method_override(args)))
    pipe = Pipeline(config=config, device=_devices(args.device),
                    profile=args.profile)
    os.makedirs(args.output_dir, exist_ok=True)
    csv_path = os.path.join(args.output_dir, args.csv)
    out = pipe.run_timetrace(
        movie, csv_path=csv_path, search_radius=args.search_radius,
        s_n_cutoff=args.sn_cutoff, max_candidates=args.max_candidates,
        photometry_min=args.photometry_minimum,
        mirror_start=args.mirror_start, chung_kennedy=args.chung_kennedy,
        p_threshold=args.p_threshold)
    summary = {"frames": int(movie.shape[0]),
               "traces": out["trace_count"], "csv": csv_path}
    if args.profile:
        from .utils import profiling
        summary["stages_sec"] = {k: round(v["total"], 3)
                                 for k, v in profiling.timings().items()}
    print(json.dumps(summary, default=str))
    return 0


def _cmd_simulate(args):
    import math

    from .sim.dye_sim import peptide_simulation_batched

    # simulate_photometries_batched wants a per-dye-count quench array;
    # expand the scalar CLI flag the way fluor_counts_calibrated does: no
    # quench for a single dye, ddif for every higher count.
    n_labeled = sum(aa in args.labels for aa in args.sequence)
    ddif = None if args.ddif is None else tuple(
        [0.0] + [args.ddif] * max(n_labeled, 1))
    results = peptide_simulation_batched(
        args.sequence, args.labels, num_mocks=args.num_mocks,
        num_edmans=args.num_edmans, num_simulations=args.num_sims,
        seed=args.seed, beta=args.fluor_intensity,
        beta_sigma=args.beta_sigma, ddif=ddif,
        device=_devices(args.device, many=False),
        p=args.edman_efficiency,
        b=-math.log(1.0 - args.dye_destruction),
        u=args.dud_dyes,
        s=args.surface_degradation_1,
        sc=args.surface_degradation_1_num_cycles,
        s2=args.surface_degradation_2)
    decrement_counts = {}
    for decrements, _, _, _ in results:
        decrement_counts[decrements] = decrement_counts.get(decrements,
                                                            0) + 1
    if args.results_pkl:
        with open(args.results_pkl, "wb") as fh:
            pickle.dump(results, fh)
    top = sorted(decrement_counts.items(), key=lambda kv: -kv[1])[:20]
    print(json.dumps({"simulations": args.num_sims,
                      "distinct_patterns": len(decrement_counts),
                      "top_patterns": [[str(k), v] for k, v in top],
                      "results_pkl": args.results_pkl}, default=str))
    return 0


def _cmd_stepfit(args):
    """Batched step fitting over traces from a track CSV or an .npy
    matrix; emits the reference's per-frame step-fit CSV schema
    (flexlibrary.py:3550-3709 columns, plus Channel/Field provenance
    when the input is a track CSV)."""
    import csv as csv_module

    from .api import Pipeline
    from .config import PipelineConfig, StepfitConfig
    from .pipeline.traces import PhotometryTrace, PlateauTrace, Trace

    if (args.tracks_csv is None) == (args.npy is None):
        raise SystemExit("give exactly one of TRACKS_CSV or --npy")
    if args.npy:
        phot = np.load(args.npy)
        if phot.ndim != 2:
            raise SystemExit("--npy must hold an (N, T) photometry matrix")
        meta = [("", "", i, "") for i in range(phot.shape[0])]
    else:
        from .inference.photometries import read_track_photometries_csv
        _, d2 = read_track_photometries_csv(
            args.tracks_csv,
            channels=[args.channel] if args.channel else None)
        rows = [d2[r] for r in sorted(d2)]
        if not rows:
            raise SystemExit("no traces in " + args.tracks_csv)
        phot = np.asarray([row[5] for row in rows], np.float64)
        meta = [(row[0], row[1], row[2], row[3]) for row in rows]

    if args.method == "chi_squared":
        # The reference's chi_squared flow (flexlibrary.py:3756-3789):
        # optional CK smoothing passes, the Kerssemakers fitter on the
        # smoothed trace, refit on the raw trace. mirror_start is
        # unsupported with this method, with the reference's own error.
        if args.mirror_start > 0:
            raise SystemExit(
                "chi_squared not supported with mirror_start because I'm "
                "trying to get this thing to work asap.")
        import torch

        from . import stepfitting as sflib
        from .ops.stepfit_batch import chung_kennedy_batch

        work = phot
        # The smoothing passes run on one device, the first of a list, as
        # the JAX package's subcommand runs them on its default device.
        dev = data_devices(_devices(args.device))[0]
        for _ in range(args.chung_kennedy):
            # float32 smoothing passes, as the JAX package's subcommand.
            work = chung_kennedy_batch(torch.from_numpy(
                work.astype(np.float32)).to(dev)).cpu().numpy().astype(
                    np.float64)
        fits = sflib.chi_squared_fit_batch(
            work, num_steps=args.num_steps,
            min_step_length=args.min_step_length,
            min_step_magnitude=args.min_step_magnitude,
            ignore_counterfits=args.ignore_counterfits)
        results = [
            (tuple(phot[i]), tuple(work[i]), fits[i],
             sflib.refit_plateaus(list(phot[i]), fits[i]))
            for i in range(len(fits))
        ]
    else:
        pipe = Pipeline(PipelineConfig(stepfit=StepfitConfig(
            mirror_start=args.mirror_start, chung_kennedy=args.chung_kennedy,
            p_threshold=args.p_threshold)),
            device=_devices(args.device), profile=args.profile)
        results = pipe.stepfit(phot)

    os.makedirs(args.output_dir, exist_ok=True)
    csv_path = os.path.join(args.output_dir, args.csv)
    n_steps = 0
    with open(csv_path, "w", newline="") as fh:
        writer = csv_module.writer(fh)
        writer.writerow(["Trace #", "Channel", "Field", "Hcoord", "Wcoord",
                         "Frame #", "Photometry", "Step #",
                         "Plateau Height", "Step Size", "Plateau Length",
                         "Overall Fit R^2"])
        for t, ((channel, field, h, w), (phots, _ck, _pl, t_filtered)) in \
                enumerate(zip(meta, results)):
            sf = PlateauTrace(t_filtered, h, w)
            ptrace = PhotometryTrace(tuple(phots), h, w)
            r_2 = Trace.coefficient_of_determination(ptrace, sf)
            sf_starts = sf.plateau_starts()
            ls_num, ls_pos, ls_mag = sf.last_step_info(0)
            (pa, po, ph), _pi = sf.frame_plateau(0)
            plateau_length = po - pa + 1
            n_steps += max(len(t_filtered) - 1, 0)
            for f in range(len(phots)):
                if f in sf_starts:
                    ls_num, ls_pos, ls_mag = sf.last_step_info(f)
                    (pa, po, ph), _pi = sf.frame_plateau(f)
                    plateau_length = po - pa + 1
                writer.writerow([t, channel, field, h, w, f, phots[f],
                                 ls_num, ph, ls_mag, plateau_length, r_2])
    print(json.dumps({"traces": len(results), "steps": n_steps,
                      "csv": csv_path}))
    return 0


def _cmd_fluor_counts(args):
    from .api import Pipeline
    from .config import PipelineConfig, LognormalConfig

    # Both modes honor --max-possible / --no-multidrop, and multidrop
    # defaults ON in both — the reference fitter's default
    # (lognormal_fitter_v2.py:95-96,166). Manual mode used to ignore
    # these flags and fit with the library's multidrop-off default.
    pipe = Pipeline(PipelineConfig(lognormal=LognormalConfig(
        max_possible=args.max_possible,
        allow_multidrop=not args.no_multidrop)),
        device=_devices(args.device))
    if args.auto_calibrate:
        signals, total, none_count, fit_info, calibration = \
            pipe.fluor_counts_calibrated(
                args.tracks_csv, channel=args.channel or "ch1",
                beta=args.beta,
                beta_sigma=args.beta_sigma, truncate=args.truncate,
                ddif=args.ddif, max_possible=args.max_possible,
                allow_multidrop=not args.no_multidrop,
                adjustment=not args.no_adjustment)
    else:
        if args.beta is None:
            raise SystemExit("--beta is required without --auto-calibrate")
        calibration = None
        signals, total, none_count, fit_info = pipe.fluor_counts(
            args.tracks_csv, beta=args.beta, beta_sigma=args.beta_sigma,
            alpha_adjust=args.alpha_adjust,
            # Manual mode honors --channel too: a multi-channel
            # experiment CSV raises otherwise (one beta cannot apply
            # across channels), with no other CLI way to restrict it.
            **({"channels": [args.channel]} if args.channel else {}))
    if args.signals_pkl:
        with open(args.signals_pkl, "wb") as fh:
            pickle.dump(signals, fh)
    print(json.dumps({"traces": total, "none": none_count,
                      "distinct_signals": len(signals),
                      "calibration": calibration,
                      "signals_pkl": args.signals_pkl}, default=str))
    return 0


def _cmd_background(args):
    """Iterative background correction of a SIGNALS.pkl against control
    experiments (the iterative_background_v2 flow with direct pkl paths
    instead of the index-CSV indirection)."""
    from .inference.background import (average_signals, counts_to_percent,
                                       discard_late_signals, head_truncate,
                                       iterative_peak_finding_v3,
                                       signals_std)

    def _load(path, head, total):
        with open(path, "rb") as fh:
            signals = pickle.load(fh)
        signals = {k: c for k, c in signals.items() if k[1]}  # zeros only
        if head > 0:
            signals = head_truncate(signals=signals, num_cycles=head)
        if total is not None:
            signals = discard_late_signals(signals=signals, max_cycle=total)
        return signals

    boc = _load(args.signals_pkl, args.head, args.total)
    if args.omit_multidrop:
        boc = {k: c for k, c in boc.items() if len(k[0]) == len(set(k[0]))}
    controls = [_load(p, args.control_head, args.control_total)
                for p in args.control_pkls]

    include_multidrop = not args.omit_multidrop
    averaged_ac = average_signals(experiments=controls,
                                  include_remainders=False,
                                  include_multidrop=include_multidrop,
                                  max_cycle=None)
    ac_stds = signals_std(experiments=controls, include_remainders=False,
                          include_multidrop=include_multidrop,
                          max_cycle=None)
    boc_percent = counts_to_percent(signals=boc, include_remainders=False,
                                    include_multidrop=include_multidrop,
                                    max_cycle=None)
    peak_list, undefined_peaks, updated_boc_raw, updated_boc_percent = \
        iterative_peak_finding_v3(
            boc_raw=boc, boc_percent=boc_percent, ac_average=averaged_ac,
            ac_std=ac_stds, num_cycles=args.num_cycles,
            sigma_threshold=args.sigma,
            include_multidrop=include_multidrop)
    corrected = {k: max(boc[k] - background_count, 0)
                 for k, background_count in updated_boc_raw.items()}

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, args.output)
    with open(out_path, "wb") as fh:
        pickle.dump(corrected, fh)
    if args.background_pkl:
        with open(os.path.join(args.output_dir, args.background_pkl),
                  "wb") as fh:
            pickle.dump(updated_boc_raw, fh)
    print(json.dumps({
        "signals_in": len(boc), "signals_out": len(corrected),
        "counts_in": int(sum(boc.values())),
        "counts_out": int(sum(corrected.values())),
        "undefined_peaks": len(undefined_peaks), "output": out_path}))
    return 0


def _cmd_remainder(args):
    """Remainder-based photometry correction of a track CSV (the
    remainder_correction app's methods 1-4), writing
    <csv>_adjusted.csv."""
    import csv as csv_module

    from .inference.photometries import (read_track_photometries_csv,
                                         remainder_correct,
                                         write_photometries_dict_to_csv)

    csv_path = os.path.abspath(args.tracks_csv)
    photometries, row_photometries = read_track_photometries_csv(
        csv_path, head_truncate=0, tail_truncate=0, downstep_filtered=False)
    if not row_photometries:
        raise SystemExit("no traces in " + csv_path)
    num_frames = len(row_photometries.popitem()[1][4])
    adjusted, adjustments = remainder_correct(
        photometries, num_frames, method=args.method,
        minimum_r_per_field=args.min, use_median=args.m1_diff_median)
    out_path = args.output or (csv_path + "_adjusted.csv")
    # The correction methods may leave empty channel/field shells
    # (minimum_r_per_field rejections); prune so the library writer's
    # first-entry header probe is safe.
    adjusted = {c: {f: d for f, d in cd.items() if d}
                for c, cd in adjusted.items()}
    adjusted = {c: cd for c, cd in adjusted.items() if cd}
    if adjusted:
        n_rows = write_photometries_dict_to_csv(adjusted, out_path)
    else:
        # Methods can reject every field (minimum_r_per_field); still
        # honor the promised artifact with a header-only CSV.
        with open(out_path, "w", newline="") as fh:
            csv_module.writer(fh).writerow(
                ["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                [f"FRAME {fr}" for fr in range(num_frames)])
        n_rows = 0
    if args.adjustments_pkl:
        with open(args.adjustments_pkl, "wb") as fh:
            pickle.dump(adjustments, fh)
    print(json.dumps({"method": args.method, "rows": n_rows,
                      "adjusted_fields": {c: sorted(d)
                                          for c, d in adjustments.items()},
                      "output": out_path}, default=str))
    return 0


def build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m fluorosequencingimageanalysis_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    pe = sub.add_parser(
        "run-experiment",
        help="registration + detect/fit + tracking + categories + CSVs")
    pe.add_argument("--peptide-files", nargs="+", required=True,
                    help="image files; directory = cycle, filename = field")
    pe.add_argument("--second-channel-files", nargs="+", default=None,
                    help="optional second-channel image files (ch2), same "
                         "cycle/field layout")
    pe.add_argument("--output-dir", default=".",
                    help="directory for output CSVs")
    pe.add_argument("--csv", default="track_photometries.csv",
                    help="track-photometries CSV filename")
    pe.add_argument("--category-csv", default="category_counts.csv",
                    help="category-counts CSV filename")
    pe.add_argument("--offsets-pkl", default=None,
                    help="also dump per-channel offsets to this pkl")
    pe.add_argument("--photometry-method", default=None,
                    choices=["mexican_hat", "simple", "maximum",
                             "gaussian_volume", "sigmas", "sextractor"],
                    help="photometry metric (default mexican_hat; a "
                         "'method' key in --photometry-parameters wins "
                         "when this flag is not given)")
    pe.add_argument("--max-candidates", type=int, default=None)
    pe.add_argument("--max-spots", type=int, default=None)
    pe.add_argument("--photometry-parameters", default=None,
                    help="dict literal of PhotometryConfig fields, e.g. "
                         "\"{'radius': 12, 'brim_size': 8}\" — the "
                         "reference's --photometry_parameters surface")
    pe.add_argument("--detect-parameters", default=None,
                    help="dict literal of DetectConfig fields, e.g. "
                         "\"{'c_std': 3, 'r_2_threshold': 0.5}\" — the "
                         "reference's --parameters surface")
    pe.add_argument("--keep-invalid", action="store_true",
                    help="keep window-invalid traces (skip "
                         "discard_invalid_traces; out-of-box interpolated "
                         "holes write '0') — the reference script's "
                         "--keep_invalid surface")
    pe.add_argument("--save-averages", action="store_true",
                    help="write the AVERAGE_INTENSITY CSV format (mean "
                         "over detected frames, no interpolation) — the "
                         "reference's track_photometries_as_csv("
                         "save_averages=True) / the experiment script's "
                         "--not_all_photometries surface")
    pe.add_argument("--mdma", action="store_true",
                    help="apply multiplicative-delta-median photometric "
                         "drift adjustments (flexlibrary MDMA)")
    pe.add_argument("--remainder-threshold", type=int, default=None,
                    help="QC-mask fields with fewer persistent remainders "
                         "than this in any channel "
                         "(remainder_threshold_fields semantics)")
    pe.add_argument("--all-categories", action="store_true",
                    help="category CSV keeps every pattern (default: "
                         "one-drop monotone only, like the reference)")
    pe.add_argument("--collate-fields", action="store_true",
                    help="per-field category counts")
    pe.add_argument("--dispatch", default="eager",
                    choices=["eager", "window"],
                    help="group-upload scheduling: eager enqueues every "
                         "field group up front; window keeps 2 in "
                         "flight for devices short of memory")
    pe.add_argument("--profile", action="store_true",
                    help="print per-stage wall-clock")
    pe.add_argument("--store", default=None,
                    help="artifact-store directory: detect-step results "
                         "are content-hash cached there, so re-runs with "
                         "unchanged inputs skip the device step")
    pe.add_argument("--device", default="cuda",
                    help="where the work runs: cuda (default), cuda:N, "
                         "cpu, or a comma-separated list (cuda:0,cuda:1) "
                         "to shard over")
    pe.set_defaults(func=_cmd_run_experiment)

    det = sub.add_parser(
        "detect",
        help="spot finding + PSF fitting over images, writing the "
             "psfs pkl/csv/png artifacts (basic_image_script workflow)")
    det.add_argument("images", nargs="+", help="image files")
    det.add_argument("--max-candidates", type=int, default=None)
    det.add_argument("--c-std", type=float, default=None,
                     help="candidate threshold sigma over the "
                          "correlation-map mean")
    det.add_argument("--r2-threshold", type=float, default=None,
                     help="PSF-fit R^2 acceptance threshold")
    det.add_argument("--device", default="cuda",
                     help="where the work runs: cuda (default), cuda:N "
                          "or cpu")
    det.set_defaults(func=_cmd_detect)

    zs = sub.add_parser(
        "zstack",
        help="background estimation + batched PSF fits over a z/time "
             "stack: per-frame SExtractor mesh background subtraction "
             "on the device, batched detect/fit, spots CSV out")
    zs.add_argument("frames", nargs="+",
                    help="frame image files (z or time order), or one "
                         ".npy holding a [T, H, W] stack")
    zs.add_argument("--output", default="zstack_spots.csv",
                    help="per-spot CSV path")
    zs.add_argument("--box-size", type=int, default=10,
                    help="background mesh box size (pixels)")
    zs.add_argument("--filter-size", type=int, default=10,
                    help="background mesh median-filter size (boxes)")
    zs.add_argument("--background-npy", default=None,
                    help="also save the [T, H, W] background maps")
    zs.add_argument("--max-candidates", type=int, default=None)
    zs.add_argument("--c-std", type=float, default=None,
                    help="candidate threshold sigma over the "
                         "correlation-map mean")
    zs.add_argument("--r2-threshold", type=float, default=None,
                    help="PSF-fit R^2 acceptance threshold")
    zs.add_argument("--store", default=None,
                    help="artifact-store directory for run caching")
    zs.add_argument("--device", default="cuda",
                    help="where the work runs: cuda (default), cuda:N, "
                         "cpu, or a comma-separated list (cuda:0,cuda:1) "
                         "to shard over")
    zs.set_defaults(func=_cmd_zstack)

    tt = sub.add_parser(
        "timetrace",
        help="movie workflow: detect + LC tracking + step fits + CSV")
    tt.add_argument("--frames", nargs="+", required=True,
                    help="movie frame image files, in order")
    tt.add_argument("--output-dir", default=".")
    tt.add_argument("--csv", default="timetrace.csv",
                    help="timetrace CSV filename")
    tt.add_argument("--photometry-method", default=None,
                    choices=["mexican_hat", "simple", "maximum",
                             "gaussian_volume", "sigmas", "sextractor"],
                    help="photometry metric (default mexican_hat; a "
                         "'method' key in --photometry-parameters wins "
                         "when this flag is not given)")
    tt.add_argument("--search-radius", type=int, default=3,
                    help="luminosity-centroid search radius")
    tt.add_argument("--sn-cutoff", type=float, default=3.0,
                    help="Illumina S/N gate for accepting a tracked spot")
    tt.add_argument("--max-candidates", type=int, default=None)
    tt.add_argument("--photometry-parameters", default=None,
                    help="dict literal of PhotometryConfig fields "
                         "(reference --photometry_parameters)")
    tt.add_argument("--photometry-minimum", type=float, default=None)
    tt.add_argument("--mirror-start", type=int, default=None,
                    help="mirror this many frames before step fitting")
    tt.add_argument("--chung-kennedy", type=int, default=None,
                    help="number of Chung-Kennedy filter passes")
    tt.add_argument("--p-threshold", type=float, default=None,
                    help="t-test merge p threshold")
    tt.add_argument("--profile", action="store_true")
    tt.add_argument("--device", default="cuda",
                    help="where the work runs: cuda (default), cuda:N, "
                         "cpu, or a comma-separated list (cuda:0,cuda:1) "
                         "to shard over")
    tt.set_defaults(func=_cmd_timetrace)

    sim = sub.add_parser(
        "simulate",
        help="batched Monte-Carlo peptide simulation (exact joint "
             "multi-color dye sim)")
    sim.add_argument("sequence", help="peptide amino-acid sequence")
    sim.add_argument("labels", help="labeled amino acids, e.g. 'C' or 'CK'")
    sim.add_argument("--num-mocks", type=int, default=4)
    sim.add_argument("--num-edmans", type=int, default=8)
    sim.add_argument("--num-sims", type=int, default=10000)
    sim.add_argument("--seed", type=int, default=0)
    sim.add_argument("--fluor-intensity", type=float, default=30000.0)
    sim.add_argument("--beta-sigma", type=float, default=0.2)
    sim.add_argument("--edman-efficiency", type=float, default=0.94)
    sim.add_argument("--dye-destruction", type=float, default=0.05)
    sim.add_argument("--dud-dyes", type=float, default=0.3)
    sim.add_argument("--surface-degradation-1", type=float, default=0.0)
    sim.add_argument("--surface-degradation-1-num-cycles", type=int,
                     default=0)
    sim.add_argument("--surface-degradation-2", type=float, default=0.0)
    sim.add_argument("--ddif", type=float, default=None,
                     help="dye-dye interaction quench factor")
    sim.add_argument("--results-pkl", default=None,
                     help="dump the per-molecule FluorEvent results pkl")
    sim.add_argument("--device", default="cuda",
                     help="where the simulation runs: cuda (default), "
                          "cuda:N or cpu")
    sim.set_defaults(func=_cmd_simulate)

    sf = sub.add_parser(
        "stepfit",
        help="batched step fitting over traces from a track CSV or .npy")
    sf.add_argument("tracks_csv", nargs="?", default=None,
                    help="track-photometries CSV (run-experiment output)")
    sf.add_argument("--npy", default=None,
                    help="(N, T) photometry matrix .npy instead of a CSV")
    sf.add_argument("--channel", default=None,
                    help="restrict the CSV to this channel")
    sf.add_argument("--output-dir", default=".")
    sf.add_argument("--csv", default="step_fits.csv",
                    help="per-frame step-fit CSV filename")
    sf.add_argument("--mirror-start", type=int, default=0,
                    help="mirror this many frames before fitting")
    sf.add_argument("--chung-kennedy", type=int, default=0,
                    help="number of Chung-Kennedy filter passes")
    sf.add_argument("--p-threshold", type=float, default=0.01)
    sf.add_argument("--method", choices=["t_test", "chi_squared"],
                    default="t_test",
                    help="step-fit algorithm (the reference's "
                         "save_stepfits_as_csv method choices, "
                         "flexlibrary.py:3762): 't_test' = CK + "
                         "sliding-t + refit + t-merge; 'chi_squared' = "
                         "the Kerssemakers best-fit/counter-fit fitter "
                         "(native batched core) + refit on the raw "
                         "trace")
    sf.add_argument("--num-steps", type=int, default=10,
                    help="chi_squared: maximum steps to consider "
                         "(reference default 10)")
    sf.add_argument("--min-step-length", type=int, default=2,
                    help="chi_squared: minimum plateau length in frames")
    sf.add_argument("--min-step-magnitude", type=float, default=0.0,
                    help="chi_squared: ignore steps smaller than this")
    sf.add_argument("--ignore-counterfits", action="store_true",
                    help="chi_squared: take the longest fit instead of "
                         "the best step-indicator S")
    sf.add_argument("--profile", action="store_true")
    sf.add_argument("--device", default="cuda",
                    help="where the work runs: cuda (default), cuda:N, "
                         "cpu, or a comma-separated list (cuda:0,cuda:1) "
                         "to shard over (chi_squared smooths on the first)")
    sf.set_defaults(func=_cmd_stepfit)

    fc = sub.add_parser("fluor-counts",
                        help="v8 lognormal fluor counting from a track CSV")
    fc.add_argument("tracks_csv")
    fc.add_argument("--auto-calibrate", action="store_true",
                    help="derive alpha via the histogram mode-separation "
                         "method and beta via last-drop v2, with an "
                         "ON/OFF re-adjustment pass — the "
                         "lognormal_fitter_v2 flow (the fit always uses "
                         "--beta-sigma; last-drop sigma estimates are "
                         "only reported)")
    fc.add_argument("--beta", type=float, default=None,
                    help="lognormal intensity scale; required without "
                         "--auto-calibrate, pins beta with it")
    fc.add_argument("--beta-sigma", type=float, default=0.2,
                    help="lognormal sigma used by the fit (both passes, "
                         "as in the reference)")
    fc.add_argument("--alpha-adjust", type=float, default=0.0,
                    help="(manual mode) subtract this zero level")
    fc.add_argument("--channel", default=None,
                    help="channel to read from the CSV (auto-calibrate "
                         "default: ch1; manual default: all — required "
                         "there when the CSV holds multiple channels)")
    fc.add_argument("--truncate", type=int, default=0,
                    help="(auto-calibrate) head-truncate cycles for the "
                         "last-drop beta estimate")
    fc.add_argument("--ddif", type=float, default=0.0,
                    help="(auto-calibrate) dye-dye interaction quench "
                         "factor")
    fc.add_argument("--max-possible", type=int, default=5)
    fc.add_argument("--no-multidrop", action="store_true")
    fc.add_argument("--no-adjustment", action="store_true",
                    help="(auto-calibrate) skip the ON/OFF re-adjustment "
                         "pass")
    fc.add_argument("--signals-pkl", default=None,
                    help="dump the signals dict to this pkl")
    fc.add_argument("--device", default="cuda",
                    help="where the scoring runs: cuda (default), cuda:N, "
                         "cpu, or a comma-separated list (cuda:0,cuda:1) "
                         "to shard over")
    fc.set_defaults(func=_cmd_fluor_counts)

    bg = sub.add_parser(
        "background-correct",
        help="iterative background correction of a SIGNALS.pkl against "
             "control experiments")
    bg.add_argument("signals_pkl", help="experiment SIGNALS.pkl")
    bg.add_argument("--control-pkls", nargs="+", required=True,
                    help="control-experiment SIGNALS.pkl files")
    bg.add_argument("--num-cycles", type=int, required=True)
    bg.add_argument("--sigma", type=float, default=2.0,
                    help="outlier sigma threshold")
    bg.add_argument("--head", type=int, default=0,
                    help="head-truncate the experiment by this many cycles")
    bg.add_argument("--total", type=int, default=None,
                    help="discard experiment signals beyond this cycle")
    bg.add_argument("--control-head", type=int, default=0)
    bg.add_argument("--control-total", type=int, default=None)
    bg.add_argument("--omit-multidrop", action="store_true")
    bg.add_argument("--output-dir", default=".")
    bg.add_argument("--output", default="corrected_signals.pkl")
    bg.add_argument("--background-pkl", default=None,
                    help="also dump the per-signal background counts")
    bg.set_defaults(func=_cmd_background)

    rc = sub.add_parser(
        "remainder-correct",
        help="remainder-based photometry correction of a track CSV "
             "(methods 1-4), writing <csv>_adjusted.csv")
    rc.add_argument("tracks_csv", help="track-photometries CSV")
    rc.add_argument("--method", type=int, default=4, choices=[1, 2, 3, 4])
    rc.add_argument("--min", type=int, default=5,
                    help="minimum remainders per field")
    rc.add_argument("--m1-diff-median", action="store_true",
                    help="method 1: deviations from each remainder's "
                         "median instead of its mean")
    rc.add_argument("--output", default=None,
                    help="output CSV path (default <csv>_adjusted.csv)")
    rc.add_argument("--adjustments-pkl", default=None,
                    help="also pickle the per-field adjustments")
    rc.set_defaults(func=_cmd_remainder)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
