#!/usr/bin/env python
"""
Iterative background correction of a fluorosequencing experiment.

Signals-dict format: {(signal, is_zero, starting_intensity): count}, where
signal is a tuple of ('A', cycle) drop positions.

Loads the experiment (boc) SIGNALS.pkl and a CSV list of control (ac)
SIGNALS.pkls, reconciles cycle counts, and removes background outliers via
iterative_peak_finding_v3.

A copy of the repo's root iterative_background_v2.py on the PyTorch
package (CLI parity: the reference's iterative_background_v2.py); host
code, so it takes no --device. Run it as
``python -m fluorosequencingimageanalysis_torch.compat.iterative_background_v2 ...``.
"""

import argparse
import pickle
from csv import reader
from os import getcwd, makedirs
from os.path import abspath, exists, join
from time import time

from .MCsimlib import (head_truncate, discard_late_signals, average_signals,
                       signals_std, counts_to_percent,
                       iterative_peak_finding_v3)
from .pflib import _epoch_to_hash


class MyFormatter(argparse.ArgumentDefaultsHelpFormatter,
                  argparse.RawDescriptionHelpFormatter):
    pass


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=MyFormatter)
    parser.add_argument("--boc_file", nargs=1, required=True,
                        help="Experiment SIGNALS.pkl (background on chip).")
    parser.add_argument("--ac_file", nargs=1, required=True,
                        help="CSV of index,filepath rows listing control "
                             "SIGNALS.pkls.")
    parser.add_argument("--head_boc", type=int, default=0,
                        help="Head-truncate the boc by this many cycles.")
    parser.add_argument("--head_ac", type=int, default=0,
                        help="Head-truncate each ac by this many cycles.")
    parser.add_argument("--boc_total", type=int, default=None,
                        help="Discard boc signals beyond this cycle.")
    parser.add_argument("--ac_total", type=int, default=None,
                        help="Discard ac signals beyond this cycle.")
    parser.add_argument("--num_cycles", type=int, required=True,
                        help="Number of cycles in the experiment.")
    parser.add_argument("--ac_use", type=int, nargs="+",
                        help="Use only these ac indices.")
    parser.add_argument("--ac_omit", type=int, nargs="+",
                        help="Omit these ac indices.")
    parser.add_argument("--omit_multidrop", action="store_true",
                        default=False, help="Omit multidrop signals.")
    parser.add_argument("--sigma", type=float, default=2,
                        help="Sigma threshold for outlier detection.")
    parser.add_argument("--output_directory", nargs=1, default=[getcwd()],
                        help="Directory for output pkls.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    timestamp_hash = _epoch_to_hash(round(time()))
    include_multidrop = not args.omit_multidrop
    include_remainders = False

    ac_use_set = set() if args.ac_use is None else set(args.ac_use)
    ac_omit_set = (set() if len(ac_use_set) > 0 or args.ac_omit is None
                   else set(args.ac_omit))

    ac_experiments = {}
    with open(args.ac_file[0]) as ac_csv:
        for r, row in enumerate(reader(ac_csv)):
            if r == 0:
                continue
            ac_index, ac_filepath = row[:2]
            ac_index = int(ac_index)
            if ac_index in ac_omit_set:
                continue
            if len(ac_use_set) > 0 and ac_index not in ac_use_set:
                continue
            try:
                with open(ac_filepath, "rb") as f:
                    ac_signals = pickle.load(f)
                if not include_remainders:
                    ac_signals = {k: c for k, c in ac_signals.items()
                                  if k[1]}
                ac_experiments.setdefault(ac_index, ac_signals)
            except Exception as e:
                print("Could not load " + str(ac_filepath) + " due to " +
                      str(e) + "; omitting.")

    if args.head_ac > 0:
        for k in list(ac_experiments):
            ac_experiments[k] = head_truncate(signals=ac_experiments[k],
                                              num_cycles=args.head_ac)
    elif args.head_ac < 0:
        raise ValueError("--head_ac must be a non-negative integer.")
    if args.ac_total is not None:
        if args.ac_total <= 0:
            raise ValueError("--ac_total must be a positive integer.")
        for k in list(ac_experiments):
            ac_experiments[k] = discard_late_signals(
                signals=ac_experiments[k], max_cycle=args.ac_total)

    with open(args.boc_file[0], "rb") as f:
        boc_experiment = pickle.load(f)
    if not include_remainders:
        boc_experiment = {k: c for k, c in boc_experiment.items() if k[1]}
    if args.head_boc > 0:
        boc_experiment = head_truncate(signals=boc_experiment,
                                       num_cycles=args.head_boc)
    elif args.head_boc < 0:
        raise ValueError("--head_boc must be a non-negative integer.")
    if args.boc_total is not None:
        if args.boc_total <= 0:
            raise ValueError("--boc_total must be a positive integer.")
        boc_experiment = discard_late_signals(signals=boc_experiment,
                                              max_cycle=args.boc_total)
    if args.omit_multidrop:
        boc_experiment = {k: c for k, c in boc_experiment.items()
                          if len(k[0]) == len(set(k[0]))}

    averaged_ac = average_signals(experiments=list(ac_experiments.values()),
                                  include_remainders=include_remainders,
                                  include_multidrop=include_multidrop,
                                  max_cycle=None)
    ac_stds = signals_std(experiments=list(ac_experiments.values()),
                          include_remainders=include_remainders,
                          include_multidrop=include_multidrop,
                          max_cycle=None)
    boc_percent = counts_to_percent(signals=boc_experiment,
                                    include_remainders=include_remainders,
                                    include_multidrop=include_multidrop,
                                    max_cycle=None)
    peak_list, undefined_peaks, updated_boc_raw, updated_boc_percent = \
        iterative_peak_finding_v3(
            boc_raw=boc_experiment, boc_percent=boc_percent,
            ac_average=averaged_ac, ac_std=ac_stds,
            num_cycles=args.num_cycles, sigma_threshold=args.sigma,
            include_multidrop=include_multidrop)
    background_corrected_raw = {
        k: max(boc_experiment[k] - background_count, 0)
        for k, background_count in updated_boc_raw.items()}

    output_directory = abspath(args.output_directory[0])
    if not exists(output_directory):
        makedirs(output_directory)

    print("Background iteration completed. Saving results using filename "
          "hash " + str(timestamp_hash))
    for name, obj in [("average_background_", averaged_ac),
                      ("std_background_", ac_stds),
                      ("experiment_background_", updated_boc_raw),
                      ("corrected_experiment_", background_corrected_raw)]:
        with open(join(output_directory,
                       name + str(timestamp_hash) + ".pkl"), "wb") as f:
            pickle.dump(obj, f)
    return background_corrected_raw


if __name__ == "__main__":
    main()
