#!/usr/bin/env python
"""
Fit track photometries using the lognormal algorithm.

A copy of the repo's root lognormal_fitter_v2.py on the PyTorch package
(CLI parity: the reference's lognormal_fitter_v2.py), with --device: the
per-spot Pool fan-out is the batched v8 scorer (kernel C on a card). Run
it as
``python -m fluorosequencingimageanalysis_torch.compat.lognormal_fitter_v2 ...``.
"""

import argparse
import pickle
import sys
from collections import defaultdict
from csv import writer
from os.path import abspath
from time import time

from .._device import default_device, set_default_device
from .MCsimlib import (read_track_photometries_csv, _get_m0Dm1,
                       _photometries_lognormal_fit_MP_v8, last_drop_method_v2)
from .pflib import _epoch_to_hash
from .plotting import (plot_histogram, single_drops_heatmap_v2,
                       double_drops_heatmap_v2)
from . import jupyter_development as jd


class MyFormatter(argparse.ArgumentDefaultsHelpFormatter,
                  argparse.RawDescriptionHelpFormatter):
    pass


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=MyFormatter)
    parser.add_argument("tracks", nargs=1, type=str,
                        help="track_photometries_??????.csv file to fit.")
    parser.add_argument("-c", "--channel", type=int, default=1,
                        help="Which channel to fit. Must be either 1 or 2.")
    parser.add_argument("-w", "--wavelength", type=int, default=0,
                        help="Wavelength of the channel for heatmap colors. "
                             "0 maps channel 1 -> 561nm, channel 2 -> 647nm.")
    parser.add_argument("-m", "--num_mocks", type=int, default=4,
                        help="Number of mocks performed.")
    parser.add_argument("-o", "--num_mocks_omitted", type=int, default=1,
                        help="Number of mocks not imaged.")
    parser.add_argument("-e", "--num_edmans", type=int, default=8,
                        help="Number of Edmans performed.")
    parser.add_argument("-s", "--sequence", type=str, default=None,
                        help="Peptide sequence as string (for heatmaps).")
    parser.add_argument("-n", "--num_processors", type=int, default=None,
                        help="Compatibility; the batched fitter ignores it.")
    parser.add_argument("--max_possible", type=int, default=5,
                        help="Maximum number of fluors to try to fit.")
    parser.add_argument("--max_deviation", type=int, default=3,
                        help="Max standard deviations from mean per fluor.")
    parser.add_argument("--ddif", type=float, default=0.30,
                        help="Dye-dye interaction factor.")
    parser.add_argument("--beta_sigma", type=float, default=0.20,
                        help="Lognormal shape parameter.")
    parser.add_argument("--beta", type=float, default=None,
                        help="Manually specify 1-fluor intensity.")
    parser.add_argument("--no_adjustment", action="store_true",
                        default=False,
                        help="No ON->OFF per-image photometry adjustment.")
    parser.add_argument("--no_multidrop", action="store_true", default=False,
                        help="No drops greater than one dye during fit.")
    parser.add_argument("--truncate", type=int, default=0,
                        help="Ignore this many head cycles for beta guess.")
    parser.add_argument("--device", type=str, default=default_device(),
                        help="Device of the v8 fit (cuda, cuda:N or cpu; the "
                             "default is the FSIA_TORCH_DEVICE environment "
                             "variable, else cuda).")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    set_default_device(args.device)
    tracks_filepath = abspath(args.tracks[0])
    channel = "ch" + str(args.channel)
    if args.wavelength == 0:
        wavelength = 561 if args.channel == 1 else 647
    else:
        wavelength = args.wavelength
    timestamp_epoch = round(time())
    timestamp_hash = _epoch_to_hash(timestamp_epoch)
    base = tracks_filepath + "_" + str(timestamp_hash) + "_" + channel + "_"
    print("Using timestamp_hash " + str(timestamp_hash))

    with open(base + "COMMANDLINE.pkl", "wb") as f:
        pickle.dump(sys.argv, f)

    photometries, row_photometries = read_track_photometries_csv(
        tracks_filepath, head_truncate=0, tail_truncate=0,
        downstep_filtered=True, channels=[channel])

    raw_photometries = tuple(
        intensity
        for ch, field, h, w, category, intensities, row
        in jd.unwind_photometries(photometries)
        for intensity in intensities)

    alpha = _get_m0Dm1(raw_photometries=raw_photometries,
                       optimal_bin_number=None)[7]

    alpha_adjusted = defaultdict(dict)
    for (ch, field, h, w, category, intensities,
         row) in jd.unwind_photometries(photometries):
        adj = tuple(i - alpha for i in intensities)
        (alpha_adjusted.setdefault(ch, {}).setdefault(field, {})
         .setdefault((h, w), (category, adj, row)))

    truncated = defaultdict(dict)
    for (ch, field, h, w, category, intensities,
         row) in jd.unwind_photometries(photometries):
        (truncated.setdefault(ch, {}).setdefault(field, {})
         .setdefault((h, w), (category[args.truncate:],
                              intensities[args.truncate:], row)))

    original_beta, original_beta_sigma = last_drop_method_v2(
        photometries=dict(truncated))
    if args.beta is not None:
        original_beta = args.beta
    allow_multidrop = not args.no_multidrop
    ddif = tuple([0.0] + [args.ddif] * (args.max_possible + 1))

    (original_signals, original_total, original_none,
     original_all_fit_info) = _photometries_lognormal_fit_MP_v8(
        photometries=dict(alpha_adjusted), beta=original_beta,
        beta_sigma=args.beta_sigma, max_possible=args.max_possible,
        allow_upsteps=False, allow_multidrop=allow_multidrop,
        max_deviation=3, quench_factor=0, quench_factors=ddif)

    on_offs = jd.grab_ON_OFFS(original_all_fit_info, alpha_adjust=0)

    # Unconditional like the reference (lognormal_fitter_v2.py:187-193):
    # with empty ON_OFFS the adjustment is a no-op that passes the RAW
    # (un-alpha-adjusted) photometries through — the else branch is only
    # for --no_adjustment.
    if not args.no_adjustment:
        adj_photometries = jd.ON_OFF_adjust_photometries(
            photometries=photometries, ON_OFFS=on_offs, alpha=alpha)
    else:
        adj_photometries = dict(alpha_adjusted)

    adj_beta, adj_beta_sigma = last_drop_method_v2(
        photometries=adj_photometries)
    if args.beta is not None:
        adj_beta = args.beta

    plf_results = (signals, total_count, none_count, all_fit_info) = \
        _photometries_lognormal_fit_MP_v8(
            photometries=adj_photometries, beta=adj_beta,
            beta_sigma=args.beta_sigma, max_possible=args.max_possible,
            allow_upsteps=False, allow_multidrop=allow_multidrop,
            max_deviation=3, quench_factor=0, quench_factors=ddif)

    with open(base + "INTERMEDIATES_v2.pkl", "wb") as f:
        pickle.dump(((alpha, adj_beta, args.beta_sigma, ddif), plf_results,
                     args), f)
    with open(base + "CLUSTERED.csv", "w", newline="") as f:
        writer(f)
    with open(base + "SIGNALS.pkl", "wb") as f:
        pickle.dump(signals, f)

    print("")
    print("Signals:")
    for (signal, is_zero, s_i), count in sorted(signals.items(),
                                                key=lambda x: x[0]):
        print(str((signal, is_zero, s_i)) + "    " + str(count))
    print("Total number of signals: " + str(sum(signals.values())))
    print("Total number of signals that fall to 0: " +
          str(sum(c for (s, z, si), c in signals.items() if z)))
    print("")

    with open(base + "RAW_PHOTOMETRIES.pkl", "wb") as f:
        pickle.dump(raw_photometries, f)

    try:
        plot_histogram(plot_target=raw_photometries,
                       title="Spot intensity log histogram",
                       yaxis_title="log(counts)", xaxis_title="photometry",
                       log_yaxis=True, filepath=base + "HISTOGRAM.html")
    except Exception as e:
        print("Error saving histogram using plotting.py functions. "
              "Exception: " + str(e))
    try:
        single_drops_heatmap_v2(
            signals=signals, num_mocks=args.num_mocks,
            num_edmans=args.num_edmans,
            num_mocks_omitted=args.num_mocks_omitted,
            peptide_string=args.sequence, wavelength=wavelength, zmin=None,
            zmax=None, filepath=base + "SINGLE_DROPS_HEATMAP.html",
            plot_remainders=True)
    except Exception as e:
        print("Error saving single drops heatmap using plotting.py "
              "functions. Exception: " + str(e))
    try:
        double_drops_heatmap_v2(
            signals=signals, num_mocks=args.num_mocks,
            num_edmans=args.num_edmans,
            num_mocks_omitted=args.num_mocks_omitted,
            peptide_string=args.sequence, wavelength=wavelength, zmin=None,
            zmax=None, filepath=base + "DOUBLE_DROPS_HEATMAP.html",
            plot_remainders=True)
    except Exception as e:
        print("Error saving double drops heatmap using plotting.py "
              "functions. Exception: " + str(e))
    return signals


if __name__ == "__main__":
    main()
