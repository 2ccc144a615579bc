"""The port's CLI front door: ``python -m fluorosequencingimageanalysis_torch``.

Counterpart of fluorosequencingimageanalysis_tpu/__main__.py over the
port's api.Pipeline, with the subcommands whose paths the port has, the
same flags and the same JSON summaries, plus ``--device`` (default cuda):

    python -m fluorosequencingimageanalysis_torch run-experiment \\
        --peptide-files cycle_*/field_*.png --output-dir out
    python -m fluorosequencingimageanalysis_torch detect field.tif
    python -m fluorosequencingimageanalysis_torch zstack frames.npy \\
        --output spots.csv

run-experiment groups files by the reference's directory=cycle,
filename=field convention (flexlibrary.py:1105-1154), runs the one-call
array-native path (registration + detect/fit + tracking + interpolation +
categories), and writes the track-photometries and category-counts CSVs.
detect writes the psfs pkl/csv/png artifacts next to each image; zstack
writes a per-spot CSV. Raw uint16 images upload as-is and are cast on the
device. The other subcommands of the JAX package (timetrace, stepfit,
fluor-counts, background-correct, remainder-correct, simulate) are not
registered yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys

import numpy as np


def _load_stack(files):
    """files -> ([F, C, H, W] array, frame_count) via dir=cycle/file=field."""
    from .pipeline.experiment import easy_sort_target_images
    from .utils.imageio import read_image_array

    frame_indexed, field_indexed = easy_sort_target_images(files)
    n_fields = {len(v) for v in frame_indexed.values()}
    if len(n_fields) != 1:
        raise SystemExit("every cycle directory must hold the same number "
                         f"of field files (got counts {sorted(n_fields)})")
    fields = []
    for f in sorted(field_indexed):
        fields.append(np.stack([read_image_array(p)
                                for p in field_indexed[f]]))
    stack = np.stack(fields)  # [F, C, H, W]
    return stack, stack.shape[1]


def _method_override(args):
    """--photometry-method as a from_cli override, only when given.

    The flag default is None so an explicit ``'method'`` key inside
    --photometry-parameters (the reference's dict surface,
    basic_experiment_script.py:150-158) is honored instead of being
    silently clobbered by the flag's default."""
    if args.photometry_method is None:
        return {}
    return {"method": args.photometry_method}


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
    from .config import PipelineConfig, PhotometryConfig

    store = None
    if args.store:
        from .utils.checkpoint import ArtifactStore
        store = ArtifactStore(args.store)
    stack, C = _load_stack(args.peptide_files)
    stacks = {"ch1": stack}
    if args.second_channel_files:
        stack2, C2 = _load_stack(args.second_channel_files)
        if C2 != C:
            raise SystemExit("second channel must have the same cycle count")
        stacks["ch2"] = stack2
    from .config import DetectConfig
    config = PipelineConfig(
        detect=DetectConfig.from_cli(args.detect_parameters),
        photometry=PhotometryConfig.from_cli(
            args.photometry_parameters, **_method_override(args)))
    pipe = Pipeline(config=config, device=args.device, store=store,
                    profile=args.profile)
    os.makedirs(args.output_dir, exist_ok=True)
    csv_path = os.path.join(args.output_dir, args.csv)
    category_csv_path = os.path.join(args.output_dir, args.category_csv)
    out = pipe.run_experiment(
        stacks, csv_path=csv_path, category_csv_path=category_csv_path,
        category_csv_filtered=not args.all_categories,
        category_csv_collate_fields=args.collate_fields,
        max_candidates=args.max_candidates, max_spots=args.max_spots,
        mdma=args.mdma, save_averages=args.save_averages,
        keep_invalid=args.keep_invalid,
        remainder_threshold=args.remainder_threshold,
        dispatch=args.dispatch)
    if args.offsets_pkl:
        with open(os.path.join(args.output_dir, args.offsets_pkl),
                  "wb") as fh:
            pickle.dump({ch: (np.asarray(oh), np.asarray(ow))
                         for ch, (oh, ow) in out["offsets"].items()}, fh)
    summary = {"fields": int(stack.shape[0]), "cycles": int(C),
               "channels": sorted(stacks),
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

    params = {"device": args.device}
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
    pipe = Pipeline(PipelineConfig(detect=det), device=args.device,
                    store=store)
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
                    help="where the work runs: cuda (default), cuda:N "
                         "or cpu")
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
                    help="where the work runs: cuda (default), cuda:N "
                         "or cpu")
    zs.set_defaults(func=_cmd_zstack)

    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
