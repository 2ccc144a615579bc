#!/usr/bin/env python
"""
Monte-Carlo simulate fluorosequencing of a peptide and fit the simulated
tracks with the v8 lognormal fitter (closure test).

A copy of the repo's root simulate_peptide.py on the PyTorch package (CLI
parity: the reference's simulate_peptide.py), with --device. Run it as
``python -m fluorosequencingimageanalysis_torch.compat.simulate_peptide ...``.
"""

import argparse
import pickle
import traceback
from collections import defaultdict
from datetime import datetime
from math import log
from os import getcwd, makedirs
from os.path import abspath, exists, join
from time import time

from .._device import default_device, set_default_device
from . import peptide_simulator
from .MCsimlib import (_photometries_lognormal_fit_MP_v8,
                       write_photometries_dict_to_csv)
from .pflib import _epoch_to_hash


class MyFormatter(argparse.ArgumentDefaultsHelpFormatter,
                  argparse.RawDescriptionHelpFormatter):
    pass


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=MyFormatter)
    parser.add_argument("sequence", nargs=1, type=str,
                        help="Peptide sequence.")
    parser.add_argument("labels", nargs=1, type=str,
                        help="Labeled amino acids (e.g. 'A').")
    parser.add_argument("-N", "--num_sims", type=int, default=100000,
                        help="Number of molecules to simulate.")
    parser.add_argument("-m", "--num_mocks", type=int, default=4,
                        help="Number of mocks performed.")
    parser.add_argument("-o", "--num_mocks_omitted", type=int, default=1,
                        help="Number of mocks not imaged.")
    parser.add_argument("-e", "--num_edmans", type=int, default=8,
                        help="Number of Edmans performed.")
    parser.add_argument("--edman_efficiency", type=float, default=0.90,
                        help="Edman success probability p.")
    parser.add_argument("--dye_destruction", type=float, default=0.1,
                        help="Per-exposure dye destruction probability.")
    parser.add_argument("--dud_dyes", type=float, default=0.50,
                        help="Initial dud-dye probability u.")
    parser.add_argument("--surface_degradation_1", type=float, default=0.30,
                        help="Strip probability during the first phase.")
    parser.add_argument("--surface_degradation_1_num_cycles", type=int,
                        default=3, help="Cycles in the first strip phase.")
    parser.add_argument("--surface_degradation_2", type=float, default=0.10,
                        help="Strip probability afterwards.")
    parser.add_argument("--fluor_intensity", type=float, default=70000,
                        help="One-fluor intensity beta.")
    parser.add_argument("--ddif_2", type=float, default=0.30,
                        help="Dye-dye interaction for 2 fluors.")
    parser.add_argument("--ddif_3", type=float, default=0.30,
                        help="Dye-dye interaction for 3+ fluors.")
    parser.add_argument("--beta_sigma", type=float, default=0.20,
                        help="Lognormal shape parameter.")
    parser.add_argument("--distance_ddifs", nargs="+", type=float,
                        default=None, help="Distance-based DDIFs.")
    parser.add_argument("-n", "--num_processors", type=int, default=None,
                        help="Compatibility; ignored.")
    parser.add_argument("--no_csv", action="store_true", default=False,
                        help="Do not write simulated photometries CSV.")
    parser.add_argument("--output_directory", nargs=1, default=[getcwd()],
                        help="Directory for outputs.")
    parser.add_argument("--no_multidrop", action="store_true", default=False,
                        help="Disallow multidrop during fitting.")
    parser.add_argument("--superdye_rate", type=float, default=0.0,
                        help="Chance for a dye to be a superdye.")
    parser.add_argument("--superdye_factor", type=float, default=1.0,
                        help="Superdye brightness factor.")
    parser.add_argument("--batched_simulation", choices=["auto", "on", "off"],
                        default="auto",
                        help="Use the device-scale batched Monte-Carlo "
                             "(exact joint multi-color statistics; event "
                             "buffers not materialized). 'auto' enables it "
                             "for num_sims >= 10000 when superdyes and "
                             "distance-DDIFs are off.")
    parser.add_argument("--device", type=str, default=default_device(),
                        help="Device of the batched simulation and the v8 fit (cuda, cuda:N or cpu; the "
                             "default is the FSIA_TORCH_DEVICE environment "
                             "variable, else cuda).")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    set_default_device(args.device)
    sequence = args.sequence[0]
    labels = args.labels[0]
    N, m, o, e = (args.num_sims, args.num_mocks, args.num_mocks_omitted,
                  args.num_edmans)

    output_directory = abspath(args.output_directory[0])
    if not exists(output_directory):
        makedirs(output_directory)
    allow_multidrop = not args.no_multidrop
    timestamp_hash = _epoch_to_hash(round(time()))
    output_filepath = join(output_directory,
                           "Simulated_" + str(timestamp_hash) + ".pkl")
    max_possible = 5
    ddif = [0, args.ddif_2] + [args.ddif_3] * 5

    distance_ddifs = args.distance_ddifs
    if distance_ddifs is not None:
        maximum_distance = len(sequence) - 1
        padding = maximum_distance - len(distance_ddifs)
        if padding > 0:
            distance_ddifs = distance_ddifs + [0.0] * padding
        elif padding < 0:
            distance_ddifs = distance_ddifs[:padding]
        distance_ddifs = dict(zip(range(1, maximum_distance),
                                  distance_ddifs))

    print("Parameters loaded. Starting simulation at " + str(datetime.now()))
    if args.batched_simulation == "on" and (args.superdye_rate != 0.0 or
                                            distance_ddifs is not None):
        raise SystemExit(
            "--batched_simulation on does not support superdyes or "
            "distance DDIFs (the batched model omits them); use "
            "--batched_simulation auto/off for these parameters.")
    use_batched = (args.batched_simulation == "on" or
                   (args.batched_simulation == "auto" and N >= 10000 and
                    args.superdye_rate == 0.0 and distance_ddifs is None))
    if use_batched:
        # Device-scale Monte-Carlo CHAINED into the v8 fit: the
        # dye-count scan, photometry kernel and scorer share the device
        # (one fetch round of per-trace winners + compact counts — the
        # (N, F) intensities only cross the link when the CSV needs
        # them). Signals / molecular_error_signals equal the two-step
        # path (tests/test_closure_full_stack.py).
        from ._on_default_device import simulate_and_fit_batched
        if len(set(labels)) > 1:
            # Reference parity: the per-molecule error-signal loop below
            # dies on multi-label input with exactly this error
            # (reference simulate_peptide.py popitem loop).
            raise NotImplementedError(
                "This part currently only works for one label.")
        out = simulate_and_fit_batched(
            sequence=sequence, labels=labels, num_mocks=m - o, num_edmans=e,
            num_simulations=N, seed=round(time()) % (2 ** 31),
            beta=args.fluor_intensity, beta_sigma=args.beta_sigma,
            ddif=ddif, max_possible=max_possible,
            allow_multidrop=allow_multidrop, max_deviation=3,
            fetch_intensities=not args.no_csv,
            p=args.edman_efficiency, b=-log(1.0 - args.dye_destruction),
            u=args.dud_dyes, s=args.surface_degradation_1,
            sc=args.surface_degradation_1_num_cycles,
            s2=args.surface_degradation_2)
        signals = out["signals"]
        molecular_error_signals = out["molecular_error_signals"]
        if not args.no_csv:
            # Photometries dict only for the CSV artifact (same rows as
            # the two-step path's convert_to_oldstyle build).
            label = out["labels"][0]
            counts = out["counts"][:, :, 0]
            intens = out["intensities"][label].astype("float64")
            photometries = {"ch1": {0: {}}}
            for t in range(counts.shape[0]):
                category = tuple(bool(c != 0) for c in counts[t])
                row = tuple(float(x) for x in intens[t])
                photometries["ch1"][0].setdefault((t, t),
                                                  (category, row, t))
            csv_filepath = output_filepath[:-4] + ".csv"
            try:
                rows = write_photometries_dict_to_csv(
                    photometries=photometries, filepath=csv_filepath)
                print("Wrote " + str(rows) + " rows to " + str(csv_filepath))
            except Exception as e:
                print("Failed to write simulated photometries to " +
                      str(csv_filepath) + " due to exception " + str(e))
                traceback.print_exc()
        print("Fitting completed at " + str(datetime.now()) +
              ". Saving results to " + output_filepath)
        with open(output_filepath, "wb") as f:
            pickle.dump((args, signals, molecular_error_signals), f)
        return signals, molecular_error_signals
    else:
        results = peptide_simulator.peptide_simulation(
            sequence=sequence, labels=labels, num_mocks=m - o, num_edmans=e,
            num_simulations=N, random_seed=None,
            num_processes=args.num_processors, reserved_character=None,
            p=args.edman_efficiency, b=-log(1.0 - args.dye_destruction),
            u=args.dud_dyes, s=args.surface_degradation_1,
            sc=args.surface_degradation_1_num_cycles,
            s2=args.surface_degradation_2, beta=args.fluor_intensity,
            beta_sigma=args.beta_sigma, ddif=ddif,
            distance_ddifs=distance_ddifs, superdye_rate=args.superdye_rate,
            superdye_factor=args.superdye_factor)

    results = peptide_simulator.convert_to_oldstyle(results)
    molecular_error_signals = defaultdict(int)
    photometries = {"ch1": {0: {}}}
    t = 0
    for dye_decrements, dye_counts, event_buffer, ci in results:
        for label, (category, (intensities,)) in ci.items():
            photometries["ch1"][0].setdefault((t, t),
                                              (category, intensities, t))
            t += 1
        assert len(dye_counts) > 0
        if len(dye_counts) > 1:
            raise NotImplementedError(
                "This part currently only works for one label.")
        label, seq = dye_counts.popitem()
        z = seq[-1] == 0
        molecular_error_signals[(dye_decrements, z, seq[0])] += 1
    molecular_error_signals = dict(molecular_error_signals)

    if not args.no_csv:
        csv_filepath = output_filepath[:-4] + ".csv"
        try:
            rows = write_photometries_dict_to_csv(
                photometries=photometries, filepath=csv_filepath)
            print("Wrote " + str(rows) + " rows to " + str(csv_filepath))
        except Exception as e:
            print("Failed to write simulated photometries to " +
                  str(csv_filepath) + " due to exception " + str(e))
            traceback.print_exc()

    print("Simulation complete. Fitting simulated tracks at " +
          str(datetime.now()))
    plf_results = (signals, total_count, none_count, all_fit_info) = \
        _photometries_lognormal_fit_MP_v8(
            photometries=photometries, beta=args.fluor_intensity,
            beta_sigma=args.beta_sigma, max_possible=max_possible,
            num_processes=args.num_processors, allow_upsteps=False,
            allow_multidrop=allow_multidrop, max_deviation=3,
            quench_factor=0, quench_factors=ddif)
    print("Fitting completed at " + str(datetime.now()) +
          ". Saving results to " + output_filepath)
    with open(output_filepath, "wb") as f:
        pickle.dump((args, signals, molecular_error_signals), f)
    return signals, molecular_error_signals


if __name__ == "__main__":
    main()
