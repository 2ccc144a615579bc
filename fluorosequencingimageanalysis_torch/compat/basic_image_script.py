"""
Find fluorescent spots in all images.

Will traverse all target_directories and process all found *.tif files through
pflib.parallel_image_batch. For each image, a png version will be created if it
is not found.

For each image, spot finding results will be output in three files: a Python
pickle file, a png file, and a csv file. See pflib.py's save_psfs_pkl,
save_psfs_png, and save_psfs_csv documentation for detailed description of each
file output.

A copy of the repo's root basic_image_script.py on the PyTorch package (CLI
parity: the reference's basic_image_script.py), with --device. Run it as
``python -m fluorosequencingimageanalysis_torch.compat.basic_image_script ...``.
"""

import argparse
import ast
import datetime
import logging
import os
import time

from .._device import default_device, set_default_device
from . import pflib


class MyFormatter(argparse.ArgumentDefaultsHelpFormatter,
                  argparse.RawDescriptionHelpFormatter):
    pass


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=MyFormatter)
    parser.add_argument("--parameters", type=str, nargs=1, default=[None],
                        help="Parameters for pflib's find_peptides function. "
                             "Expects a Python dictionary in quotes.")
    parser.add_argument("-mc", "--monte_carlo", action="store_true",
                        default=False,
                        help="Use Monte Carlo method to peakfit (instead of "
                             "default Levenberg-Marquardt Gaussian).")
    parser.add_argument("--N_iter", type=int, nargs=1, default=[10 ** 3],
                        help="Number of samples to use if using "
                             "--monte_carlo.")
    parser.add_argument("-n", "--num_processes", type=int, nargs=1,
                        default=[None],
                        help="Number of processes to use (accepted for "
                             "compatibility; the batched device path ignores "
                             "it).")
    default_log_path = os.path.join(
        os.getcwd(), "basic_image_script_" +
        str(datetime.datetime.now()).replace(" ", "_") + ".log")
    parser.add_argument("-L", "--log_path", nargs=1,
                        default=[default_log_path], help="Pathname for log.")
    parser.add_argument("target_directories", nargs="+",
                        help="Directories to process. At least one must be "
                             "specified.")
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
    target_directories = [os.path.abspath(d)
                          for d in args.target_directories]
    logging.basicConfig(filename=args.log_path[0], level=logging.DEBUG)
    logger = logging.getLogger()
    logger.info("basic_image_script starting at " +
                str(datetime.datetime.fromtimestamp(timestamp_epoch)))
    if args.parameters[0] is not None:
        fp_parameters = ast.literal_eval(args.parameters[0])
    else:
        fp_parameters = None
    if args.monte_carlo:
        if fp_parameters is None:
            fp_parameters = {}
        fp_parameters.setdefault("fit_type", "monte_carlo")
        fp_parameters.setdefault("N_iter", args.N_iter[0])
    target_images = []
    for target_dir in target_directories:
        for root, subfolders, files in os.walk(target_dir):
            for f in files:
                if f.endswith(".tif"):
                    target_images.append(os.path.join(root, f))
    logger.info("Will process target images\n" + "\n".join(target_images))
    processed = pflib.parallel_image_batch(
        target_images, find_peptides_parameters=fp_parameters,
        timestamp_epoch=timestamp_epoch,
        num_processes=args.num_processes[0])
    logger.info("Pathnames of images processed: " +
                "\n".join(processed.keys()))
    return processed


if __name__ == "__main__":
    main()
