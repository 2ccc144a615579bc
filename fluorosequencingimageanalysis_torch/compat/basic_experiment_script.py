"""
Full multi-field multi-cycle fluorosequencing experiment: cross-cycle
registration, spot tracing, category counting, and track photometries.

A copy of the repo's root basic_experiment_script.py on the PyTorch package
(CLI parity: the reference's basic_experiment_script.py), with --device. Run it
as
``python -m fluorosequencingimageanalysis_torch.compat.basic_experiment_script ...``.
"""

import argparse
import ast
import datetime
import glob
import logging
import os
import pickle
import time

import numpy as np
from .._device import default_device, set_default_device
from . import flexlibrary, pflib
from ..utils.visualize import _intensity_scaling  # noqa: F401


class MyFormatter(argparse.ArgumentDefaultsHelpFormatter,
                  argparse.RawDescriptionHelpFormatter):
    pass


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=MyFormatter)
    parser.add_argument("-D", "--debug", action="store_true",
                        help="Debug-level logging.")
    parser.add_argument("-n", "--num_processes", type=int, nargs=1,
                        default=[None],
                        help="Compatibility; ignored on the device.")
    default_log_path = os.path.join(
        os.getcwd(), "basic_experiment_script_" +
        str(datetime.datetime.now()).replace(" ", "_") + ".log")
    parser.add_argument("-L", "--log_path", nargs=1,
                        default=[default_log_path], help="Pathname for log.")
    parser.add_argument("--output_directory", nargs=1, default=None,
                        help="Directory for output files.")
    parser.add_argument("-r", "--recompute", action="store_true",
                        help="Not implemented (parity with reference).")
    parser.add_argument("--keep_invalid", action="store_true",
                        help="Keep traces with invalid photometries.")
    parser.add_argument("--pkl_invalid", action="store_true",
                        help="Pickle discarded traces.")
    parser.add_argument("-ns", "--no_self_align", action="store_true",
                        help="Do not self-align using peptide frames.")
    parser.add_argument("--no_sanity_check_images", action="store_true",
                        help="Skip sanity-check PNGs.")
    parser.add_argument("-en", "--extraction_number", type=int, default=10,
                        help="Tracks to extract per category.")
    parser.add_argument("-es", "--extraction_size", type=int, default=9,
                        help="Extracted track square side (odd).")
    parser.add_argument("--save_tracks", action="store_true", default=False,
                        help="Save per-category pkls and track PNGs.")
    parser.add_argument("--sextractor", action="store_true", default=False,
                        help="Use sextractor photometry.")
    parser.add_argument("--photometry_parameters", type=str, nargs=1,
                        default=[None],
                        help="Photometry parameters dict (quoted).")
    parser.add_argument("--save_photometries", action="store_true",
                        default=True, help="Save track photometries CSV.")
    parser.add_argument("--not_all_photometries", action="store_true",
                        default=False,
                        help="Save average intensity only.")
    parser.add_argument("--collate_fields", action="store_true",
                        default=False, help="Per-field category counts.")
    parser.add_argument("--all_categories", action="store_true",
                        default=False,
                        help="Not implemented (parity with reference).")
    parser.add_argument("--alignment_files", nargs="+", type=str,
                        default=None, help="Alignment channel image files.")
    parser.add_argument("--peptide_files", nargs="+", type=str,
                        required=True, help="Peptide channel image files.")
    parser.add_argument("--second_channel", nargs="+", type=str,
                        default=None, help="Second channel image files.")
    parser.add_argument("--device", type=str, default=default_device(),
                        help="Device of detection, registration, "
                             "photometry and step fits (cuda, cuda:N or "
                             "cpu; the default is the FSIA_TORCH_DEVICE "
                             "environment variable, else cuda).")
    return parser


def _fit_missing(files, timestamp_epoch, num_processes, logger):
    files = [os.path.abspath(f) for f in files]
    need_fitting = []
    need_fitting_map = {}
    for f, fullpath in enumerate(files):
        if len(sorted(glob.glob(fullpath + "*_psfs_*.pkl"))) == 0:
            need_fitting.append(fullpath)
            need_fitting_map.setdefault(fullpath, f)
    logger.info("Submitting to pflib: " + str(need_fitting))
    processed = pflib.parallel_image_batch(
        image_paths=need_fitting, find_peptides_parameters=None,
        timestamp_epoch=timestamp_epoch, num_processes=num_processes)
    for original, (converted, *_rest) in processed.items():
        files[need_fitting_map[original]] = converted
    return files


def main(argv=None):
    timestamp_epoch = round(time.time())
    epoch_hash = pflib._epoch_to_hash(timestamp_epoch)
    args = build_parser().parse_args(argv)
    set_default_device(args.device)
    logging.basicConfig(filename=args.log_path[0],
                        level=logging.DEBUG if args.debug else logging.INFO)
    logger = logging.getLogger()
    logger.info("basic_experiment_script args = " + str(args))
    if args.recompute:
        raise NotImplementedError("--recompute option not currently "
                                  "implemented.")
    if args.all_categories:
        raise NotImplementedError("--all_categories option not currently "
                                  "implemented.")

    peptide_files = _fit_missing(args.peptide_files, timestamp_epoch,
                                 args.num_processes[0], logger)

    by_dir = {}
    for f in peptide_files:
        head, tail = os.path.split(f)
        by_dir.setdefault(head, []).append(tail)
    if len(set(len(v) for v in by_dir.values())) != 1:
        raise Exception("For peptide_files, each directory must have the "
                        "same number of files specified.")
    frame_idx_pep, field_idx_pep = \
        flexlibrary.Experiment.easy_sort_target_images(peptide_files)

    if args.alignment_files is not None:
        alignment_files = [os.path.abspath(f) for f in args.alignment_files]
    elif not args.no_self_align:
        alignment_files = [os.path.abspath(f) for f in args.peptide_files]
    else:
        alignment_files = []
    frame_idx_al, field_idx_al = \
        flexlibrary.Experiment.easy_sort_target_images(alignment_files)

    if args.second_channel is not None:
        second_files = _fit_missing(args.second_channel, timestamp_epoch,
                                    args.num_processes[0], logger)
    else:
        second_files = []
    frame_idx_2, field_idx_2 = \
        flexlibrary.Experiment.easy_sort_target_images(second_files)

    if args.output_directory is None:
        output_directory = os.getcwd()
        trace_directory = None
    else:
        output_directory = os.path.abspath(args.output_directory[0])
        os.makedirs(output_directory, exist_ok=True)
        trace_directory = os.path.join(output_directory,
                                       "sanity_check_pngs_" + epoch_hash)
        if not os.path.exists(trace_directory) and \
                not args.no_sanity_check_images:
            os.makedirs(trace_directory)

    def load_fields(field_idx, load_psfs=True):
        fields = {}
        for field, files in field_idx.items():
            fields.setdefault(field, [])
            for f in files:
                img, discarded = \
                    flexlibrary.Experiment.easy_load_processed_image(
                        f, load_psfs=load_psfs)
                if discarded > 0:
                    logger.info("For %s discarded %d Spots.", f, discarded)
                fields[field].append(img)
        return fields

    peptide_fields = load_fields(field_idx_pep)
    alignment_fields = load_fields(field_idx_al, load_psfs=False)
    second_fields = load_fields(field_idx_2)

    combined = []
    for field, frames in peptide_fields.items():
        ex = flexlibrary.SequenceExperiment(
            peptide_frames=frames,
            alignment_frames=alignment_fields[field])
        ex.offsets_from_frames()
        if len(second_fields) == 0:
            channels = {"ch1": ex}
        else:
            ex2 = flexlibrary.SequenceExperiment(
                peptide_frames=second_fields[field],
                alignment_frames=alignment_fields[field])
            ex2.offsets_from_frames()
            channels = {"ch1": ex, "ch2": ex2}
        combined.append(
            flexlibrary.MultichannelSequenceExperiment(channels))

    mfmc = flexlibrary.MultifieldMultichannelSequenceExperiment(
        experimental_fields=combined)

    if args.photometry_parameters[0] is not None:
        p_params = ast.literal_eval(args.photometry_parameters[0])
    elif args.sextractor:
        p_params = {"photometry_method": "sextractor"}
    else:
        p_params = {}

    mfmc.trace_existing_spots()
    if not args.keep_invalid:
        invalid_traces = mfmc.discard_invalid_traces(**p_params)
        if args.pkl_invalid:
            with open(os.path.join(output_directory, "discarded_traces_" +
                                   epoch_hash + ".pkl"), "wb") as f:
                pickle.dump(invalid_traces, f)

    if not args.no_sanity_check_images:
        mfmc.plot_traces(timestamp_epoch=timestamp_epoch,
                         trace_directory=trace_directory)

    category_stats, categories = mfmc.count_binary_trace_categories()
    filtered_stats = mfmc.filtered_binary_trace_category_counts(
        include_first_frame_only=True)

    if args.save_tracks:
        cat_dir = os.path.join(output_directory,
                               "category_pkls_" + epoch_hash)
        os.makedirs(cat_dir, exist_ok=True)
        for c, chan in categories.items():
            for e, ex_cats in chan.items():
                for category, traces in ex_cats.items():
                    path = os.path.join(cat_dir, "category_" +
                                        str(category) + ".pkl")
                    with open(path, "wb") as f:
                        pickle.dump([[(s.h, s.w) if s is not None else None
                                      for s in t] for t in traces], f)

    with open(os.path.join(output_directory, "category_stats_" +
                           epoch_hash + ".pkl"), "wb") as f:
        pickle.dump(category_stats, f)
    with open(os.path.join(output_directory, "filtered_stats_" +
                           epoch_hash + ".pkl"), "wb") as f:
        pickle.dump(filtered_stats, f)

    mfmc.category_counts_as_csv(
        os.path.join(output_directory,
                     "category_counts_" + epoch_hash + ".csv"),
        collate_fields=args.collate_fields)

    if args.save_tracks:
        from PIL import Image as PILImage  # Pillow only where it is used
        track_dir = os.path.join(output_directory, "track_pngs_" + epoch_hash)
        os.makedirs(track_dir, exist_ok=True)
        num_frames = len(frame_idx_pep)
        for drop in range(1, num_frames + 1):
            pattern = tuple([True] * drop + [False] * (num_frames - drop))
            if args.extraction_size % 2 == 0:
                raise ValueError("extraction_size must be an odd number.")
            radius = (args.extraction_size - 1) // 2
            tracks = mfmc.extract_tracks(trace_category=pattern,
                                         radius=radius,
                                         number=args.extraction_number)
            for c, c_tracks in tracks.items():
                for t, ((h, w), track) in enumerate(c_tracks):
                    valid = [frame for f, (frame, pi) in enumerate(track)
                             if frame.shape[0] and frame.shape[1]]
                    if not valid:
                        continue
                    fmax = max(np.amax(fr) for fr in valid)
                    fmin = min(np.amin(fr) for fr in valid)
                    for f, (frame, parent_Image) in enumerate(track):
                        if frame.shape[0] == 0 or frame.shape[1] == 0:
                            continue
                        scale = max(fmax - fmin, 1)
                        r_frame = np.clip(
                            (frame.astype(np.float64) - fmin) / scale * 255,
                            0, 255).astype(np.uint8)
                        PILImage.fromarray(r_frame, mode="L").save(
                            os.path.join(track_dir,
                                         f"track_drop_{drop}_hw_{(h, w)}"
                                         f"_channel_{c}_track_{t}"
                                         f"_frame_{f}.png"))

    if args.save_photometries:
        if args.keep_invalid:
            csv_filename = os.path.join(
                output_directory,
                "track_photometries_" + epoch_hash + ".csv")
        else:
            csv_filename = os.path.join(
                output_directory,
                "track_photometries_NO_NONES_" + epoch_hash + ".csv")
        mfmc.track_photometries_as_csv(
            filepath=csv_filename,
            save_averages=args.not_all_photometries,
            discard_invalid=False, **p_params)

    print("")
    print("Summary stats")
    print("-------------")
    print("Stage drift offsets:")
    print(mfmc.offsets_as_string())
    mfmc.save_offsets_as_dict(os.path.join(
        output_directory, "offsets_dict_" + epoch_hash + ".pkl"))
    print("Total spots found in all peptide frames: " +
          str(mfmc.spot_count()))
    print("Number of spots discarded due to stage drift: " +
          str(mfmc.count_discarded_spots()))
    print("Total number of traced spots: " + str(mfmc.trace_count()))
    print("Singleton count: " + str(mfmc.singleton_count()))
    print("Basic track breakdown:")
    print(mfmc.category_counts_as_string(filtered=True,
                                         collate_fields=args.collate_fields))
    return mfmc


if __name__ == "__main__":
    main()
