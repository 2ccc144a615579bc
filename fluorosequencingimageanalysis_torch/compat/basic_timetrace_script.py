"""
Track spots through a continuously-filmed field and step-fit their
intensity traces.

A copy of the repo's root basic_timetrace_script.py on the PyTorch package (CLI
parity: the reference's basic_timetrace_script.py), with --device. Run it as
``python -m fluorosequencingimageanalysis_torch.compat.basic_timetrace_script ...``.
"""

import argparse
import ast
import datetime
import glob
import logging
import os
import pickle
import time

from .._device import default_device, set_default_device
from . import flexlibrary, pflib


class MyFormatter(argparse.ArgumentDefaultsHelpFormatter,
                  argparse.RawDescriptionHelpFormatter):
    pass


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=MyFormatter)
    parser.add_argument("-D", "--debug", action="store_true",
                        help="Debug-level logging.")
    default_log_path = os.path.join(
        os.getcwd(), "basic_timetrace_script_" +
        str(datetime.datetime.now()).replace(" ", "_") + ".log")
    parser.add_argument("-L", "--log_path", nargs=1,
                        default=[default_log_path], help="Pathname for log.")
    parser.add_argument("--output_directory", nargs=1, default=[os.getcwd()],
                        help="Directory for output files.")
    parser.add_argument("--no_sanity_check_images", action="store_true",
                        help="Do not save sanity-check track overlays.")
    parser.add_argument("--save_traces_pkl", action="store_true",
                        help="Save spot_traces as a pkl.")
    parser.add_argument("--sextractor", action="store_true", default=False,
                        help="Use sextractor photometry.")
    parser.add_argument("--photometry_parameters", type=str, nargs=1,
                        default=[None],
                        help="Photometry parameters dict (quoted).")
    parser.add_argument("--photometry_minimum", type=float, nargs=1,
                        default=[None], help="Round photometries up to this.")
    parser.add_argument("--p_threshold", type=float, nargs=1, default=[0.01],
                        help="Welch t-test threshold for step merging.")
    parser.add_argument("--linear_fit_threshold", type=float, nargs=1,
                        default=[1.0], help="Linear explainer threshold.")
    parser.add_argument("--chung_kennedy", type=int, nargs=1, default=[1],
                        help="Number of Chung-Kennedy filter applications.")
    parser.add_argument("--mirror_start", type=int, nargs=1, default=[0],
                        help="Mirror this many frames at the trace start.")
    parser.add_argument("timetrace_frames", nargs="+", type=str,
                        help="Frames of the timetrace, in order.")
    parser.add_argument("--device", type=str, default=default_device(),
                        help="Device of detection, registration, "
                             "photometry and step fits (cuda, cuda:N or "
                             "cpu; the default is the FSIA_TORCH_DEVICE "
                             "environment variable, else cuda).")
    return parser


def main(argv=None):
    timestamp_epoch = time.time()
    args = build_parser().parse_args(argv)
    set_default_device(args.device)
    logging.basicConfig(filename=args.log_path[0],
                        level=logging.DEBUG if args.debug else logging.INFO)
    logger = logging.getLogger()
    logger.info("basic_timetrace_script starting; args = " + str(args))

    timetrace_frames = [os.path.abspath(f) for f in args.timetrace_frames]
    os.makedirs(args.output_directory[0], exist_ok=True)

    timetrace_image_arrays = [pflib.read_image(f) for f in timetrace_frames]
    frame_Images = [flexlibrary.Image(image=timetrace_image_arrays[f][1],
                                      metadata={"filepath": frame},
                                      spots=None)
                    for f, frame in enumerate(timetrace_frames)]

    initial_pkls = glob.glob(timetrace_frames[0] + "*_psfs_*.pkl")
    if len(initial_pkls) == 0:
        logger.info("No PSF pkl for %s; submitting to pflib.",
                    timetrace_frames[0])
        processed = pflib.parallel_image_batch(
            image_paths=timetrace_frames[:1],
            find_peptides_parameters=None,
            timestamp_epoch=timestamp_epoch)
        psfs_pkl_path = processed[timetrace_frames[0]][1]
    else:
        psfs_pkl_path = initial_pkls[0]
    with open(psfs_pkl_path, "rb") as f:
        initial_psfs = pickle.load(f)
    initial_Spots = [flexlibrary.Spot(parent_Image=frame_Images[0],
                                      h=h_0, w=w_0,
                                      size=gaussian_fit[7].shape[0],
                                      gaussian_fit=gaussian_fit)
                     for (h_0, w_0), gaussian_fit in initial_psfs.items()]
    frame_Images[0].spots = initial_Spots

    tte = flexlibrary.TimetraceExperiment(frames=frame_Images,
                                          spot_traces=None, step_fits=None,
                                          step_fit_intermediates=None)
    tte.lc_create_traces()
    if not args.no_sanity_check_images:
        tte.wildcolor_plot_tracks(
            filepath_prefix=os.path.join(args.output_directory[0], "test_"))

    if args.photometry_parameters[0] is not None:
        p_params = ast.literal_eval(args.photometry_parameters[0])
    elif args.sextractor:
        p_params = {"photometry_method": "sextractor"}
    else:
        p_params = {}

    step_fits, step_fit_intermediates = tte.stepfit_tracks(
        photometry_min=args.photometry_minimum[0],
        mirror_start=args.mirror_start[0],
        chung_kennedy=args.chung_kennedy[0],
        p_threshold=args.p_threshold[0], **p_params)

    pkl_filepath = os.path.join(args.output_directory[0], "test.pkl")
    with open(pkl_filepath, "wb") as f:
        pickle.dump((step_fits, step_fit_intermediates), f)
    csv_filepath = os.path.join(args.output_directory[0], "test.csv")
    tte.save_experiment_as_csv(output_path=csv_filepath,
                               include_step_fits=True,
                               include_intermediates=True, **p_params)
    if args.save_traces_pkl:
        tte.save_traces_pkl(path=os.path.join(args.output_directory[0],
                                              "traces.pkl"))
    return tte


if __name__ == "__main__":
    main()
