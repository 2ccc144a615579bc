#!/usr/bin/env python
"""
Adjust track photometries using persistent remainders.

A copy of the repo's root remainder_correction.py on the PyTorch package
(CLI parity: the reference's remainder_correction.py); host code, so it
takes no --device. Run it as
``python -m fluorosequencingimageanalysis_torch.compat.remainder_correction ...``.
Methods 1-3 are the
local variants; method 4 (default) is MCsimlib._remainder_adjust_2
(multiplicative median ratio).
"""

import argparse
import csv
import os
import pickle

from . import MCsimlib


class MyFormatter(argparse.ArgumentDefaultsHelpFormatter,
                  argparse.RawDescriptionHelpFormatter):
    pass


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=MyFormatter)
    parser.add_argument("tracks", nargs=1, type=str,
                        help="track_photometries CSV to adjust.")
    parser.add_argument("--min", type=int, default=5,
                        help="Minimum remainders per field.")
    parser.add_argument("--M1_diff_median", action="store_true",
                        default=False,
                        help="Method 1: use median instead of mean.")
    parser.add_argument("--print_adjustments", action="store_true",
                        default=False, help="Print adjustments.")
    parser.add_argument("--save_adjustments", action="store_true",
                        default=False, help="Pickle adjustments.")
    parser.add_argument("--method", type=int, default=4,
                        help="Adjustment method (1-4).")
    return parser


def method_1(photometries, minimum, num_frames, use_median):
    """Per-field median of per-remainder differences (reference
    remainder_correction.py:61-99)."""
    from ..inference.photometries import (
        remainder_adjust_diff_median)
    return remainder_adjust_diff_median(photometries, num_frames,
                                        minimum_r_per_field=minimum,
                                        use_median=use_median)


def method_2(photometries, minimum, num_frames):
    """Additive medians relative to frame 0
    (remainder_correction.py:102-135)."""
    adjusted, adjustments = MCsimlib._remainder_adjust(
        photometries, num_frames, minimum_r_per_field=minimum)
    return adjusted, adjustments


def method_3(photometries, minimum, num_frames):
    """Multiplicative frame-0-median ratio
    (remainder_correction.py:137-170)."""
    from ..inference.photometries import (
        remainder_adjust_frame0_ratio)
    return remainder_adjust_frame0_ratio(photometries, num_frames,
                                         minimum_r_per_field=minimum)


def main(argv=None):
    from ..inference.photometries import (
        remainder_correct)

    args = build_parser().parse_args(argv)
    csv_path = os.path.abspath(args.tracks[0])
    photometries, row_photometries = MCsimlib.read_track_photometries_csv(
        csv_path, head_truncate=0, tail_truncate=0, downstep_filtered=False)
    num_frames = len(row_photometries.popitem()[1][4])
    del row_photometries
    adjusted, adjustments = remainder_correct(
        photometries, num_frames, method=args.method,
        minimum_r_per_field=args.min, use_median=args.M1_diff_median)
    if args.print_adjustments:
        print(adjustments)
    output_filepath = csv_path + "_adjusted.csv"
    if args.save_adjustments:
        with open(csv_path + "_adjustments.pkl", "wb") as f:
            pickle.dump(adjustments, f)
    with open(output_filepath, "w", newline="") as f:
        csv_writer = csv.writer(f)
        csv_writer.writerow(["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                            ["FRAME " + str(fr) for fr in range(num_frames)])
        for channel, cdict in adjusted.items():
            for field, fdict in cdict.items():
                for (h, w), entry in fdict.items():
                    category, adjusted_intensities = entry[0], entry[1]
                    row = [str(channel), str(field), str(h), str(w),
                           str(category)]
                    row += [str(i) for i in adjusted_intensities]
                    csv_writer.writerow(row)
    return output_filepath


if __name__ == "__main__":
    main()
