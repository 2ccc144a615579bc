"""Experiment hierarchy: single-field, multichannel, multifield, timetrace.

Counterpart of fluorosequencingimageanalysis_tpu/pipeline/experiment.py, a
host copy (tests/test_torch_import.py holds every class and function equal
to that module's, the device calls apart): the reference's flexlibrary
experiment classes (flexlibrary.py:509-4021) over the port's device
layer. Registration (``offsets_from_frames``) runs the batched phase
correlation and ``TimetraceExperiment.stepfit_tracks`` the batched step
fitter on the process default device (``_device.default_device()``, "cuda"
unless set otherwise); tracking is the native greedy linker and photometry
the per-image batched measurement of ``Image``.
"""

from __future__ import annotations

import glob
import logging
import math
import os
import pickle
import random
import time
import csv as csv_module

import numpy as np
import torch

from .._device import default_device, resolve_device
from .spots import Spot, Image
from .traces import Trace, SimpleTrace, PhotometryTrace, PlateauTrace
from . import tracking
from ..utils.hashing import epoch_to_hash
from ..utils.visualize import save_psfs_png

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())


def write_category_counts_csv(to_save, filepath, collate_fields=False,
                              dialect="excel"):
    """Write a {channel: {field: {pattern: count}}} dict as the reference's
    Pattern[,Field],Channel,Count CSV (flexlibrary.py:2948-3024).

    Shared by MultifieldMultichannelSequenceExperiment.category_counts_as_csv
    and api.Pipeline.run_experiment so the two surfaces cannot drift.
    Fields present in the dict with zero patterns still contribute count-0
    rows under collate_fields (the reference pre-creates per-field entries
    for every valid field).
    """
    to_save_channels = sorted(to_save.keys())
    header = (["Pattern", "Field", "Channel", "Count"] if collate_fields
              else ["Pattern", "Channel", "Count"])
    patterns = sorted(set(
        pattern for chan, fields in to_save.items()
        for e, pats in fields.items() for pattern in pats))
    with open(filepath, "w", newline="") as output_file:
        output_writer = csv_module.writer(output_file, dialect=dialect)
        output_writer.writerow(header)
        for pattern in patterns:
            base = [Experiment.truefalse_to_onoff(pattern)]
            for chan in to_save_channels:
                if collate_fields:
                    for e, ex in to_save[chan].items():
                        row = base + [str(e), str(chan),
                                      str(ex.get(pattern, 0))]
                        output_writer.writerow(row)
                else:
                    count = sum(ex.get(pattern, 0)
                                for ex in to_save[chan].values())
                    output_writer.writerow(base + [str(chan), str(count)])
    return filepath


class Experiment:
    """Base class: shared static utilities (flexlibrary.py:509-1317)."""

    # -- offset algebra (delegated to tracking) ----------------------------
    accumulate_offsets = staticmethod(tracking.accumulate_offsets)
    get_cumulative_offset = staticmethod(tracking.get_cumulative_offset)
    apply_offset = staticmethod(tracking.apply_offset)
    unapply_offset = staticmethod(tracking.unapply_offset)
    offset_frame_coordinates = staticmethod(tracking.offset_frame_coordinates)
    round_coordinates = staticmethod(tracking.round_coordinates)
    discard_dropouts = staticmethod(tracking.discard_dropouts)
    greedy_particle_tracking = staticmethod(tracking.greedy_particle_tracking)
    next_frame_spot_by_luminosity_centroid = None  # set below
    luminosity_centroid_particle_tracking = staticmethod(
        tracking.luminosity_centroid_particle_tracking)

    @staticmethod
    def easy_load_processed_image(image_filepath, psf_pkl_filepath=None,
                                  load_psfs=True):
        """Load an image + its PSF pkl into Image/Spot objects
        (flexlibrary.py:516-564)."""
        from ..utils.imageio import read_image_array
        image = read_image_array(image_filepath)
        image_object = Image(image=image,
                             metadata={"filepath": image_filepath},
                             spots=None)
        discarded_spots = 0
        if load_psfs:
            if psf_pkl_filepath is None:
                pkl_files = sorted(glob.glob(image_filepath + "*_psfs_*.pkl"))
                if len(pkl_files) == 0:
                    raise ValueError("For image_filepath = " + image_filepath +
                                     " psf_pkl_filepath passed as None when "
                                     "no pkl files available.")
                psf_pkl_filepath = pkl_files[-1]
            with open(psf_pkl_filepath, "rb") as f:
                psfs = pickle.load(f, encoding="latin1")
            spot_objects = []
            for (h, w), gaussian_fit in psfs.items():
                fit_img = gaussian_fit[8]
                try:
                    new_spot = Spot(parent_Image=image_object,
                                    h=int(tracking._py2_round(h)),
                                    w=int(tracking._py2_round(w)),
                                    size=fit_img.shape[0],
                                    gaussian_fit=gaussian_fit)
                    spot_objects.append(new_spot)
                except Exception:
                    logger.info("easy_load_processed_image: ignoring Spot "
                                "due to Spot.__init__ exception.",
                                exc_info=True)
                    discarded_spots += 1
            image_object.spots = spot_objects
        return image_object, discarded_spots

    @staticmethod
    def plot_traces(traces, output_filepaths):
        """Color-coded trace overlay PNGs (flexlibrary.py:1029-1103).

        Red: single-frame spot; yellow: trace start; blue: middle;
        lightblue: trace end.
        """
        framewise = [[] for _ in range(len(output_filepaths))]
        for trace in traces:
            for f, spot in enumerate(trace):
                if spot is None:
                    continue
                first = (f == 0 or trace[f - 1] is None)
                last = (f == len(trace) - 1 or trace[f + 1] is None)
                if first and last:
                    color = "red"
                elif first:
                    color = "yellow"
                elif last:
                    color = "lightblue"
                else:
                    color = "blue"
                framewise[f].append((spot, color))
        output_paths = []
        for f, spot_colors in enumerate(framewise):
            if not spot_colors:
                continue
            image_path = spot_colors[0][0].parent_Image.metadata["filepath"]
            filler = tuple([0] * 12)
            psfs = {}
            square_colors = {}
            for spot, color in spot_colors:
                psfs.setdefault((spot.h, spot.w), filler)
                square_colors.setdefault((spot.h, spot.w), color)
            output_paths.append(save_psfs_png(
                psfs=psfs, image_path=image_path,
                output_path=output_filepaths[f], square_colors=square_colors))
        return output_paths

    @staticmethod
    def easy_sort_target_images(filepath_list):
        """Sort image files into frame/field indexes by the directory=cycle,
        filename=field convention (flexlibrary.py:1105-1154)."""
        grouped = {}
        for fpath in filepath_list:
            d, f = os.path.split(os.path.abspath(fpath))
            grouped.setdefault(d, []).append(f)
        grouped = {d: sorted(flist) for d, flist in grouped.items()}
        frame_indexed = {}
        for index, d in enumerate(sorted(grouped.keys())):
            for filepath in grouped[d]:
                frame_indexed.setdefault(index, []).append(
                    os.path.join(d, filepath))
        field_indexed = {}
        for frame, fields in frame_indexed.items():
            for f, field in enumerate(fields):
                field_indexed.setdefault(f, []).append(field)
        return frame_indexed, field_indexed

    @staticmethod
    def trace_to_binary(trace):
        return [spot is not None for spot in trace]

    @staticmethod
    def truefalse_to_onoff(pattern):
        return " ".join(["[ON] " if p else "[OFF]" for p in pattern])

    @staticmethod
    def trace_to_photometry(trace, method="mexican_hat", return_invalid=True,
                            **kwargs):
        return [(spot.h, spot.w,
                 spot.photometry(method=method,
                                 return_invalid=return_invalid, **kwargs))
                if spot is not None else (None, None, None)
                for spot in trace]


class SequenceExperiment(Experiment):
    """Single-field, single-channel Edman sequence experiment
    (flexlibrary.py:1664-2382)."""

    def __init__(self, peptide_frames, alignment_frames=None, offsets=None,
                 spot_traces=None, num_discarded_spots=0,
                 photometry_adjustments=None):
        self.peptide_frames = peptide_frames
        self.alignment_frames = [None for _ in peptide_frames]
        if offsets is not None:
            if len(offsets) != len(peptide_frames):
                raise AttributeError("If provided, offsets must have the "
                                     "same number of items as peptide_frames.")
            self.offsets = offsets
        elif alignment_frames is not None:
            if len(alignment_frames) != len(peptide_frames):
                raise AttributeError("If provided, alignment_frames must "
                                     "have the same number of items as "
                                     "peptide_frames.")
            self.alignment_frames = alignment_frames
            self.offsets = self.offsets_from_frames()
        # Parity quirk (flexlibrary.py:1760): the reference unconditionally
        # resets offsets to zeros after the branches above; callers invoke
        # offsets_from_frames() explicitly. Reproduced for compatibility.
        self.offsets = [(0, 0) for _ in peptide_frames]
        self.spot_traces = spot_traces
        self.num_discarded_spots = num_discarded_spots
        if photometry_adjustments is not None:
            if not all(len(adj) == len(peptide_frames)
                       for adj in photometry_adjustments.values()):
                raise AttributeError("All photometry adjustment lists must "
                                     "be the same length as peptide_frames.")
        self.photometry_adjustments = photometry_adjustments

    def offsets_from_frames(self, upsample_factor=20):
        """Register consecutive alignment frames (flexlibrary.py:1717-1741).

        All consecutive pairs are registered at once, in float64 on the
        process default device (``_device.default_device()``).
        """
        from ..ops.registration import phase_correlate_stack
        if self.alignment_frames is None or \
                any(f is None for f in self.alignment_frames):
            raise AttributeError("Calling offsets_from_frames without "
                                 "alignment_frames defined.")
        stack = np.stack([np.asarray(f.image, dtype=np.float64)
                          for f in self.alignment_frames])
        dev = resolve_device(default_device())
        r, c, _, _ = phase_correlate_stack(torch.from_numpy(stack).to(dev),
                                           upsample_factor=upsample_factor)
        r, c = r.cpu().numpy(), c.cpu().numpy()
        offsets = [(0, 0)] + [(float(r[i]), float(c[i]))
                              for i in range(1, len(self.alignment_frames))]
        self.offsets = offsets
        return self.offsets

    def trace_existing_spots(self, spot_radius=None):
        if spot_radius is not None:
            raise NotImplementedError("spot_radius currently not implemented")
        self.spot_traces, self.num_discarded_spots = \
            tracking.greedy_particle_tracking(
                frame_spots=[image.spots for image in self.peptide_frames],
                frame_shape=self.peptide_frames[0].image.shape,
                offsets=self.offsets,
                spot_radius=0)
        return self.spot_traces

    def binary_trace_categories(self):
        trace_categories = {}
        for trace in self.spot_traces:
            trace_categories.setdefault(
                tuple(Experiment.trace_to_binary(trace)), []).append(trace)
        return trace_categories

    def interpolate_spots(self, start, stop):
        """Interpolate Spot positions between two bookends
        (flexlibrary.py:1842-1974)."""
        (start_spot, start_frame) = start
        (stop_spot, stop_frame) = stop
        if not start_frame < stop_frame:
            raise ValueError("start_frame must come before stop_frame")
        if (not (start_spot is None or stop_spot is None) and
                not start_frame + 1 < stop_frame):
            raise ValueError("If neither start_spot or stop_spot are None, "
                             "stop_frame must have at least one frame between "
                             "it and start_frame.")
        if start_spot is None and stop_spot is None:
            raise ValueError("Both start_spot and stop_spot are None.")
        if self.offsets is None:
            use_offsets = [(0, 0) for _ in self.peptide_frames]
        else:
            use_offsets = self.offsets
        if start_spot is not None:
            start_h, start_w = start_spot.h, start_spot.w
        else:
            start_h, start_w = Experiment.offset_frame_coordinates(
                offsets=use_offsets, coordinate=(stop_spot.h, stop_spot.w),
                f=start_frame, g=stop_frame)
        if stop_spot is not None:
            stop_h, stop_w = Experiment.offset_frame_coordinates(
                offsets=use_offsets, coordinate=(stop_spot.h, stop_spot.w),
                f=start_frame, g=stop_frame)
        else:
            stop_h, stop_w = start_spot.h, start_spot.w
        num_frames = stop_frame - start_frame
        h_inc = float(stop_h - start_h) / num_frames
        w_inc = float(stop_w - start_w) / num_frames
        h_coords = [start_h + h_inc * i for i in range(num_frames + 1)]
        w_coords = [start_w + w_inc * i for i in range(num_frames + 1)]
        assert abs(h_coords[-1] - stop_h) < 0.01
        assert abs(w_coords[-1] - stop_w) < 0.01
        offset_coords = []
        for i, (h, w) in enumerate(zip(h_coords, w_coords)):
            offset = Experiment.get_cumulative_offset(
                offsets=use_offsets, f=i + start_frame, g=start_frame)
            offset_coords.append(Experiment.apply_offset((h, w), offset))
        if start_spot is not None and stop_spot is not None:
            if start_spot.size != stop_spot.size:
                raise ValueError("start_spot.size != stop_spot.size")
        spot_size = (start_spot.size if start_spot is not None
                     else stop_spot.size)
        spot_radius = (spot_size - 1) // 2
        interpolated = []
        for i, (h, w) in enumerate(offset_coords):
            frame = self.peptide_frames[start_frame + i]
            fh, fw = frame.image.shape[:2]
            # Py2 rounding parity (reference flexlibrary interpolation
            # rounds half away from zero under Python 2).
            int_h = int(tracking._py2_round(h))
            int_w = int(tracking._py2_round(w))
            if (spot_radius <= int_h < fh - spot_radius and
                    spot_radius <= int_w < fw - spot_radius):
                new_spot = Spot(parent_Image=frame, h=int_h, w=int_w,
                                size=spot_size, gaussian_fit=None)
                frame.spots.append(new_spot)
                frame.append_photometry_apertures()
            else:
                new_spot = None
            interpolated.append(new_spot)
        return interpolated

    def fill_in_trace(self, trace):
        """Fill None gaps by interpolation (flexlibrary.py:1976-2032)."""
        from .. import stepfitting
        holes = [s is None for s in trace]
        hole_borders = []
        border_start = None
        border_index_map = {}
        border_index_j = 0
        i = -1
        s2 = None
        for i, (h1, h2) in enumerate(stepfitting._pairwise(holes)):
            s1, s2 = trace[i], trace[i + 1]
            border_index_map.setdefault(i, (len(hole_borders), border_index_j))
            if h1 and h2:
                border_index_j += 1
            elif h1 and not h2:
                if border_start is None:
                    hole_borders.append(((s1, 0), (s2, i + 1)))
                else:
                    hole_borders.append((border_start, (s2, i + 1)))
                    border_start = None
            elif not h1 and h2:
                border_start = s1, i
                border_index_j = 1
        if border_start is not None:
            border_index_map.setdefault(i + 1, (len(hole_borders), -1))
            hole_borders.append((border_start, (s2, len(holes) - 1)))
        interpolated = [self.interpolate_spots((s1, i1), (s2, i2))
                        for (s1, i1), (s2, i2) in hole_borders]
        merged = []
        for i, s in enumerate(trace):
            if s is not None:
                merged.append(s)
            else:
                border_index, j = border_index_map[i]
                merged.append(interpolated[border_index][j])
        return merged

    def discard_invalid_traces(self, **pparams):
        valid, invalid = [], []
        for trace in self.spot_traces:
            filled = self.fill_in_trace(trace)
            if None in filled:
                invalid.append(filled)
                continue
            p = Experiment.trace_to_photometry(filled, return_invalid=False,
                                               **pparams)
            if None in [ph for h, w, ph in p]:
                invalid.append(filled)
            else:
                valid.append(trace)
        self.spot_traces = valid
        return invalid

    def binary_trace_categories_photometry(self, method="mexican_hat",
                                           interpolate=False,
                                           discard_invalid=False,
                                           adjustment_function=None, **kwargs):
        if discard_invalid:
            raise DeprecationWarning("discard_invalid is deprecated. Use "
                                     "discard_invalid_traces() functions")
        btc = self.binary_trace_categories()
        btc_photometries = {}
        for category, traces in btc.items():
            for trace in traces:
                use_trace = self.fill_in_trace(trace) if interpolate else trace
                p = Experiment.trace_to_photometry(
                    use_trace, method=method, return_invalid=True, **kwargs)
                if adjustment_function is not None:
                    p = [(h, w, adjustment_function(
                        photometry=ph, frame=frame,
                        adjustments=self.photometry_adjustments))
                        for frame, (h, w, ph) in enumerate(p)]
                btc_photometries.setdefault(category, []).append(p)
        return btc_photometries

    def multiplicative_delta_median_adjustments(self, tag="mdma",
                                                method="mexican_hat",
                                                **kwargs):
        """Per-frame photometric drift factors from persistent remainders
        (flexlibrary.py:2131-2200).

        QUIRK (kept bug-for-bug, PARITY.md "MDMA tag"): the reference's
        docstring promises "supply an alternate tag to create a new
        entry", but its code ignores ``tag`` and always stores under the
        literal ``'mdma'`` key (flexlibrary.py:2198-2200 —
        ``setdefault('mdma', [])`` then ``['mdma'] = ...``). We reproduce
        that: a non-default ``tag`` is accepted and ignored, exactly like
        the reference, so mdma_adjustment (which reads ``'mdma'``) always
        sees the latest run's factors."""
        btc_photometries = self.binary_trace_categories_photometry(
            method=method, interpolate=False, discard_invalid=False, **kwargs)
        all_on = tuple([True] * len(self.peptide_frames))
        all_on_photometries = btc_photometries.get(all_on, [])
        all_on_photometries = [pt for pt in all_on_photometries
                               if all(ph is not None for h, w, ph in pt)]
        ratios = [[] for _ in self.peptide_frames]
        for pt in all_on_photometries:
            m = np.median([ph for (h, w, ph) in pt])
            for i, (h, w, ph) in enumerate(pt):
                ratios[i].append(float(ph - m) / m)
        medians = [float(np.median(r)) if len(r) > 0 else 0.0
                   for r in ratios]
        if self.photometry_adjustments is None:
            self.photometry_adjustments = {}
        # tag is IGNORED like the reference (see docstring QUIRK note).
        self.photometry_adjustments.setdefault("mdma", [])
        self.photometry_adjustments["mdma"] = tuple(medians)
        return self.photometry_adjustments["mdma"]

    @staticmethod
    def mdma_adjustment(photometry, frame, adjustments):
        if "mdma" in adjustments:
            return photometry * (1.0 - adjustments["mdma"][frame])
        return photometry

    def count_remainders(self):
        btc = self.binary_trace_categories()
        all_on = tuple([True] * len(self.peptide_frames))
        return len(btc.get(all_on, []))

    def plot_traces(self, timestamp_epoch=None, trace_directory=None,
                    prefix=""):
        if timestamp_epoch is None:
            timestamp_epoch = round(time.time())
        epoch_hash = epoch_to_hash(timestamp_epoch)
        output_filepaths = []
        if trace_directory is not None:
            os.makedirs(trace_directory, exist_ok=True)
            frame_zfill = int(np.ceil(math.log10(
                max(len(self.peptide_frames), 2))))
            for f, _ in enumerate(self.peptide_frames):
                output_filepaths.append(os.path.join(
                    trace_directory,
                    prefix + "_frame_" + str(f).zfill(frame_zfill) + "_" +
                    epoch_hash + ".png"))
        else:
            for frame in self.peptide_frames:
                output_filepaths.append(frame.metadata["filepath"] +
                                        "_traces_" + epoch_hash + ".png")
        return Experiment.plot_traces(self.spot_traces,
                                      output_filepaths=output_filepaths)

    def spot_count(self):
        return sum(len(frame.spots) for frame in self.peptide_frames)

    def singleton_count(self):
        return sum(1 for trace in self.spot_traces
                   if len([t for t in trace if t is not None]) == 1)

    def extract_tracks(self, trace_category, radius=4, number=5):
        """Sample spot-vicinity image sequences for a binary category
        (flexlibrary.py:2303-2381)."""
        btc = self.binary_trace_categories()
        image_sequences = []
        if trace_category in btc:
            traces = btc[trace_category]
            sample = random.sample(traces, min(number, len(traces)))
            for trace in sample:
                image_sequence = []
                nonnull = [(f, s) for f, s in enumerate(trace)
                           if s is not None]
                if not nonnull:
                    raise Exception("This trace has no non-None frames.")
                n, nspot = nonnull[0]
                ndh, ndw = Experiment.get_cumulative_offset(self.offsets, n)
                nh, nw = Experiment.apply_offset((nspot.h, nspot.w),
                                                 (ndh, ndw))
                for f, frame in enumerate(trace):
                    if frame is None:
                        img = self.peptide_frames[f].image
                        oh, ow = Experiment.get_cumulative_offset(
                            self.offsets, f)
                        gh, gw = Experiment.unapply_offset((nh, nw),
                                                           (oh, ow))
                        rgh, rgw = Experiment.round_coordinates(gh, gw)
                    else:
                        img = frame.parent_Image.image
                        rgh, rgw = Experiment.round_coordinates(frame.h,
                                                                frame.w)
                    subimg = img[max(0, rgh - radius):
                                 min(rgh + radius + 1, img.shape[0]),
                                 max(0, rgw - radius):
                                 min(rgw + radius + 1, img.shape[1])]
                    image_sequence.append((subimg, self.peptide_frames[f]))
                image_sequences.append(((nh, nw), image_sequence))
        return image_sequences


class MultifieldSequenceExperiment(Experiment):
    """Deprecated in the reference (flexlibrary.py:2384-2403); retained for
    API parity only."""

    def __init__(self, experimental_fields):
        self.experimental_fields = experimental_fields
        raise DeprecationWarning("This class is no longer maintained. Use "
                                 "MultifieldMultichannelSequenceExperiment "
                                 "instead.")

    # Per-field aggregation methods (flexlibrary.py:2405-2470). Unreachable
    # in practice — __init__ raises — kept for API parity.

    def trace_existing_spots(self):
        for ex in self.experimental_fields:
            ex.trace_existing_spots()

    def plot_traces(self, timestamp_epoch=None, trace_directory=None):
        for e, ex in enumerate(self.experimental_fields):
            ex.plot_traces(timestamp_epoch=timestamp_epoch,
                           trace_directory=trace_directory, prefix=str(e))

    def binary_trace_categories(self):
        merged = {}
        for ex in self.experimental_fields:
            for k, v in ex.binary_trace_categories().items():
                merged.setdefault(k, [])
                merged[k] += v
        return merged

    def count_binary_trace_categories(self):
        merged = self.binary_trace_categories()
        return {k: len(v) for k, v in merged.items()}, merged

    def filtered_binary_trace_category_counts(self):
        counts, merged = self.count_binary_trace_categories()
        return {bt: count for bt, count in counts.items()
                if tuple(sorted(bt, reverse=True)) == bt and bt[1]}

    def plot_filtered_binary_trace_counts(self, output_filepath):
        raise DeprecationWarning("Deprecating for now in favor of outputting "
                                 "CSV files. Assume this function is no "
                                 "longer maintained.")

    def count_discarded_spots(self):
        return sum(ex.num_discarded_spots for ex in self.experimental_fields)

    def spot_count(self):
        return sum(ex.spot_count() for ex in self.experimental_fields)

    def trace_count(self):
        return sum(len(ex.spot_traces) for ex in self.experimental_fields)

    def singleton_count(self):
        return sum(ex.singleton_count() for ex in self.experimental_fields)


class MultichannelSequenceExperiment(SequenceExperiment):
    """Dict-of-channels wrapper (flexlibrary.py:2471-2629)."""

    def __init__(self, channels):
        if not (len(set(len(chan.peptide_frames)
                        for chan in channels.values())) ==
                len(set(len(chan.alignment_frames)
                        for chan in channels.values())) == 1):
            raise AttributeError("Number of peptide_frames and "
                                 "alignment_frames does not match across "
                                 "channels.")
        self.channels = channels

    def trace_existing_spots(self):
        for chan in self.channels.values():
            chan.trace_existing_spots()

    def plot_traces(self, timestamp_epoch=None, trace_directory=None,
                    prefix=""):
        for c, chan in self.channels.items():
            chan.plot_traces(timestamp_epoch=timestamp_epoch,
                             trace_directory=trace_directory,
                             prefix=prefix + "_channel_" + str(c))

    def binary_trace_categories(self):
        return {c: chan.binary_trace_categories()
                for c, chan in self.channels.items()}

    def binary_trace_categories_photometry(self, method="mexican_hat",
                                           interpolate=False,
                                           discard_invalid=False,
                                           adjustment_function=None,
                                           **kwargs):
        if discard_invalid:
            raise DeprecationWarning("discard_invalid is deprecated. Use "
                                     "discard_invalid_traces() functions")
        return {c: chan.binary_trace_categories_photometry(
            method=method, interpolate=interpolate,
            discard_invalid=discard_invalid,
            adjustment_function=adjustment_function, **kwargs)
            for c, chan in self.channels.items()}

    def count_binary_trace_categories(self):
        merged = self.binary_trace_categories()
        counts = {c: {k: len(v) for k, v in chan.items()}
                  for c, chan in merged.items()}
        return counts, merged

    def filtered_binary_trace_category_counts(self):
        counts, merged = self.count_binary_trace_categories()
        return {c: {bt: count for bt, count in chan.items()
                    if tuple(sorted(bt, reverse=True)) == bt and bt[1]}
                for c, chan in counts.items()}

    def plot_filtered_binary_trace_counts(self, output_directory,
                                          output_prefix=""):
        """Deprecated in the reference (flexlibrary.py:2561-2565)."""
        raise DeprecationWarning("Deprecating for now in favor of outputting "
                                 "CSV files. Assume this function is no "
                                 "longer maintained.")

    def count_discarded_spots(self):
        return {c: chan.num_discarded_spots
                for c, chan in self.channels.items()}

    def spot_count(self):
        return {c: chan.spot_count() for c, chan in self.channels.items()}

    def trace_count(self):
        return {c: len(chan.spot_traces)
                for c, chan in self.channels.items()}

    def singleton_count(self):
        return {c: chan.singleton_count()
                for c, chan in self.channels.items()}

    def extract_tracks(self, trace_category, radius=4, number=5):
        return {c: chan.extract_tracks(trace_category, radius=radius,
                                       number=number)
                for c, chan in self.channels.items()}

    def get_offsets(self):
        return {c: chan.offsets for c, chan in self.channels.items()}

    def discard_invalid_traces(self, **pparams):
        return {c: chan.discard_invalid_traces(**pparams)
                for c, chan in self.channels.items()}

    def multiplicative_delta_median_adjustments(self, tag="mdma",
                                                method="mexican_hat",
                                                channels=None, **kwargs):
        return {c: chan.multiplicative_delta_median_adjustments(
            tag=tag, method=method, **kwargs)
            for c, chan in self.channels.items()
            if channels is None or c in channels}

    def count_remainders(self):
        return {c: chan.count_remainders()
                for c, chan in self.channels.items()}


class MultifieldMultichannelSequenceExperiment(Experiment):
    """Multi-field aggregator + CSV emitters (flexlibrary.py:2632-3263)."""

    def __init__(self, experimental_fields, invalid_fields_mask=None):
        if not (len(set(len(chan.peptide_frames)
                        for ex in experimental_fields
                        for chan in ex.channels.values())) ==
                len(set(len(chan.alignment_frames)
                        for ex in experimental_fields
                        for chan in ex.channels.values())) == 1):
            raise AttributeError("Number of peptide_frames and "
                                 "alignment_frames does not match across "
                                 "fields and channels.")
        self.experimental_fields = experimental_fields
        if invalid_fields_mask is not None:
            if len(invalid_fields_mask) != len(experimental_fields):
                raise AttributeError("invalid_fields_mask must be the same "
                                     "length as experimental_fields.")
            self.invalid_fields_mask = invalid_fields_mask
        else:
            self.invalid_fields_mask = [True] * len(experimental_fields)

    def _valid_fields(self, ignore_invalid_fields):
        for e, ex in enumerate(self.experimental_fields):
            if ignore_invalid_fields and not self.invalid_fields_mask[e]:
                continue
            yield e, ex

    def trace_existing_spots(self, parallel=False,
                             ignore_invalid_fields=False):
        # `parallel` kept for API parity; tracking is already batched.
        for e, ex in self._valid_fields(ignore_invalid_fields):
            ex.trace_existing_spots()

    def plot_traces(self, timestamp_epoch=None, trace_directory=None,
                    prefix="", ignore_invalid_fields=False):
        for e, ex in self._valid_fields(ignore_invalid_fields):
            ex.plot_traces(timestamp_epoch=timestamp_epoch,
                           trace_directory=trace_directory,
                           prefix=prefix + "_field_" + str(e))

    def binary_trace_categories(self, ignore_invalid_fields=False):
        merged = {}
        for e, ex in self._valid_fields(ignore_invalid_fields):
            for c, chan in ex.binary_trace_categories().items():
                merged.setdefault(c, {}).setdefault(e, {})
                for k, v in chan.items():
                    merged[c][e].setdefault(k, [])
                    merged[c][e][k] += v
        return merged

    def binary_trace_categories_photometry(self, method="mexican_hat",
                                           interpolate=False,
                                           discard_invalid=False,
                                           adjustment_function=None,
                                           ignore_invalid_fields=False,
                                           **kwargs):
        if discard_invalid:
            raise DeprecationWarning("discard_invalid is deprecated. Use "
                                     "discard_invalid_traces() functions")
        merged = {}
        for e, ex in self._valid_fields(ignore_invalid_fields):
            to_merge = ex.binary_trace_categories_photometry(
                method=method, interpolate=interpolate,
                discard_invalid=discard_invalid,
                adjustment_function=adjustment_function, **kwargs)
            for c, chan in to_merge.items():
                merged.setdefault(c, {}).setdefault(e, {})
                for k, v in chan.items():
                    merged[c][e].setdefault(k, [])
                    merged[c][e][k] += v
        return merged

    def all_raw_photometries(self, method="mexican_hat", interpolate=False):
        """Unimplemented stub in the reference (flexlibrary.py:2750-2753:
        the body is ``pass``) — kept for API parity."""
        pass

    def track_photometries_as_csv(self, filepath, dialect="excel",
                                  photometry_method="mexican_hat",
                                  save_averages=True, discard_invalid=False,
                                  ignore_invalid_fields=False,
                                  adjustment_function=None, **kwargs):
        """Write the CHANNEL,FIELD,H,W,CATEGORY[,FRAME i...] CSV
        (flexlibrary.py:2755-2892)."""
        if discard_invalid:
            raise DeprecationWarning("discard_invalid is deprecated. Use "
                                     "discard_invalid_traces() functions")
        btcp = self.binary_trace_categories_photometry(
            method=photometry_method, interpolate=not save_averages,
            discard_invalid=discard_invalid,
            ignore_invalid_fields=ignore_invalid_fields,
            adjustment_function=adjustment_function, **kwargs)
        with open(filepath, "w", newline="") as f:
            output_writer = csv_module.writer(f, dialect=dialect)
            if save_averages:
                output_writer.writerow(["CHANNEL", "FIELD", "H", "W",
                                        "CATEGORY", "AVERAGE_INTENSITY"])
            else:
                number_of_frames = len(
                    next(iter(self.experimental_fields[0].channels.values()))
                    .peptide_frames)
                output_writer.writerow(
                    ["CHANNEL", "FIELD", "H", "W", "CATEGORY"] +
                    ["FRAME " + str(i) for i in range(number_of_frames)])
            row_counter = 0
            for chan, categories in btcp.items():
                for e, ex in categories.items():
                    for category, trace_photometries in ex.items():
                        for photometry in trace_photometries:
                            # Reference quirk: the guard there is
                            # ``fp is not (None, None, None)`` — an
                            # IDENTITY test against a fresh tuple, always
                            # true — so H/W always come from frame 0,
                            # including (None, None) when save_averages'
                            # uninterpolated trace is absent there
                            # (flexlibrary.py:2872-2874).
                            h, w = photometry[0][:2]
                            if save_averages:
                                mean = np.mean([fp[2] for fp in photometry
                                                if fp[2] is not None])
                                output_writer.writerow(
                                    [str(chan), str(e), str(h), str(w),
                                     str(category), str(mean)])
                            else:
                                all_p = [str(fp[2]) if fp[2] is not None
                                         else "0" for fp in photometry]
                                output_writer.writerow(
                                    [str(chan), str(e), str(h), str(w),
                                     str(category)] + all_p)
                            row_counter += 1
        return row_counter

    def count_binary_trace_categories(self, ignore_invalid_fields=False):
        merged = self.binary_trace_categories(
            ignore_invalid_fields=ignore_invalid_fields)
        counts = {c: {e: {k: len(v) for k, v in ex.items()}
                      for e, ex in chan.items()}
                  for c, chan in merged.items()}
        return counts, merged

    def filtered_binary_trace_category_counts(self,
                                              include_first_frame_only=True,
                                              ignore_invalid_fields=False):
        counts, merged = self.count_binary_trace_categories(
            ignore_invalid_fields=ignore_invalid_fields)
        if include_first_frame_only:
            return {c: {e: {bt: count for bt, count in ex.items()
                            if tuple(sorted(bt, reverse=True)) == bt}
                        for e, ex in chan.items()}
                    for c, chan in counts.items()}
        return {c: {e: {bt: count for bt, count in ex.items()
                        if tuple(sorted(bt, reverse=True)) == bt and bt[1]}
                    for e, ex in chan.items()}
                for c, chan in counts.items()}

    def category_counts_as_csv(self, filepath, filtered=True,
                               collate_fields=False, dialect="excel",
                               ignore_invalid_fields=False):
        """Pattern/Channel/Count CSV (flexlibrary.py:2948-3024)."""
        if filtered:
            to_save = self.filtered_binary_trace_category_counts(
                ignore_invalid_fields=ignore_invalid_fields)
        else:
            to_save = self.count_binary_trace_categories(
                ignore_invalid_fields=ignore_invalid_fields)[0]
        return write_category_counts_csv(to_save, filepath,
                                         collate_fields=collate_fields,
                                         dialect=dialect)

    def category_counts_as_string(self, filtered=True, collate_fields=False,
                                  ignore_invalid_fields=False):
        if not filtered:
            raise NotImplementedError("filtered=False not yet implemented.")
        to_string = self.filtered_binary_trace_category_counts(
            ignore_invalid_fields=ignore_invalid_fields)
        out = ""
        for chan, ex in sorted(to_string.items(), key=lambda x: x[0]):
            if collate_fields:
                for e, patterns in ex.items():
                    out += (" Channel " + str(chan) + " Frame " + str(e) +
                            "\n")
                    for pattern, count in sorted(patterns.items(),
                                                 key=lambda x: x[0]):
                        out += ("    " +
                                str(Experiment.truefalse_to_onoff(pattern)) +
                                "    " + str(count) + "\n")
            else:
                merged_patterns = {}
                for e, patterns in ex.items():
                    for pattern, count in patterns.items():
                        merged_patterns.setdefault(pattern, 0)
                        merged_patterns[pattern] += count
                out += str(chan) + "\n"
                for pattern, count in sorted(merged_patterns.items(),
                                             key=lambda x: x[0]):
                    out += ("    " +
                            str(Experiment.truefalse_to_onoff(pattern)) +
                            "    " + str(count) + "\n")
        return out

    def count_discarded_spots(self, ignore_invalid_fields=False):
        count = {}
        for e, ex in self._valid_fields(ignore_invalid_fields):
            for c, num in ex.count_discarded_spots().items():
                count.setdefault(c, 0)
                count[c] += num
        return count

    def spot_count(self, ignore_invalid_fields=False):
        count = {}
        for e, ex in self._valid_fields(ignore_invalid_fields):
            for c, num in ex.spot_count().items():
                count.setdefault(c, 0)
                count[c] += num
        return count

    def trace_count(self, ignore_invalid_fields=False):
        count = {}
        for e, ex in self._valid_fields(ignore_invalid_fields):
            for c, num in ex.trace_count().items():
                count.setdefault(c, 0)
                count[c] += num
        return count

    def singleton_count(self, ignore_invalid_fields=False):
        count = {}
        for e, ex in self._valid_fields(ignore_invalid_fields):
            for c, num in ex.singleton_count().items():
                count.setdefault(c, 0)
                count[c] += num
        return count

    def extract_tracks(self, trace_category, radius=4, number=5,
                       ignore_invalid_fields=False):
        tracks = {}
        for e, ex in self._valid_fields(ignore_invalid_fields):
            for sc, subtrack in ex.extract_tracks(
                    trace_category=trace_category, radius=radius,
                    number=number).items():
                tracks.setdefault(sc, [])
                tracks[sc] += subtrack
        return tracks

    def get_offsets(self, ignore_invalid_fields=False):
        return {e: ex.get_offsets()
                for e, ex in self._valid_fields(ignore_invalid_fields)}

    def get_offsets_by_frame(self, ignore_invalid_fields=False):
        all_offsets = self.get_offsets()
        by_frame = {}
        for e, ex_offsets in all_offsets.items():
            if ignore_invalid_fields and not self.invalid_fields_mask[e]:
                continue
            for c, chan_offsets in ex_offsets.items():
                for f, off in enumerate(chan_offsets):
                    by_frame.setdefault(f, {}).setdefault(e, {})
                    by_frame[f][e].setdefault(c, (off[0], off[1]))
        return by_frame

    def save_offsets_as_dict(self, filename, ignore_invalid_fields=False):
        with open(filename, "wb") as f:
            pickle.dump(self.get_offsets_by_frame(
                ignore_invalid_fields=ignore_invalid_fields), f)

    def offsets_as_string(self, ignore_invalid_fields=False):
        to_string = self.get_offsets_by_frame(
            ignore_invalid_fields=ignore_invalid_fields)
        out = ""
        for f, frame_offsets in sorted(to_string.items()):
            out += "Frame " + str(f) + "\n"
            for e, ex_offsets in sorted(frame_offsets.items()):
                out += "    Field " + str(e) + "\n"
                for c, (h, w) in sorted(ex_offsets.items()):
                    out += ("        Channel " + str(c) + " " +
                            str((h, w)) + "\n")
                all_h = [h for h, w in ex_offsets.values()]
                all_w = [w for h, w in ex_offsets.values()]
                out += ("        Mean Offsets for Field " + str(e) + " = " +
                        str((np.mean(all_h), np.mean(all_w))) + "\n")
                out += ("        Std.Dev. Offsets for Field " + str(e) +
                        " = " + str((np.std(all_h), np.std(all_w))) + "\n")
            all_h = [h for exo in frame_offsets.values()
                     for h, w in exo.values()]
            all_w = [w for exo in frame_offsets.values()
                     for h, w in exo.values()]
            out += ("    Mean Offsets for Frame " + str(f) +
                    str((np.mean(all_h), np.mean(all_w))) + "\n")
            out += ("        Std.Dev. Offsets for Field " + str(f) + " = " +
                    str((np.std(all_h), np.std(all_w))) + "\n")
        return out

    def discard_invalid_traces(self, ignore_invalid_fields=False, **pparams):
        return [ex.discard_invalid_traces(**pparams)
                if not (ignore_invalid_fields and
                        not self.invalid_fields_mask[e])
                else False
                for e, ex in enumerate(self.experimental_fields)]

    def multiplicative_delta_median_adjustments(self, tag="mdma",
                                                method="mexican_hat",
                                                channels=None,
                                                ignore_invalid_fields=False,
                                                **kwargs):
        return [ex.multiplicative_delta_median_adjustments(
            tag=tag, method=method, channels=None, **kwargs)
            if not (ignore_invalid_fields and
                    not self.invalid_fields_mask[e])
            else False
            for e, ex in enumerate(self.experimental_fields)]

    def count_remainders(self, ignore_invalid_fields=False):
        return [ex.count_remainders()
                if not (ignore_invalid_fields and
                        not self.invalid_fields_mask[e])
                else False
                for e, ex in enumerate(self.experimental_fields)]

    def remainder_threshold_fields(self, channels=None, min_remainders=5):
        """QC mask: invalidate fields with too few persistent remainders
        (flexlibrary.py:3231-3263)."""
        remainder_counts = self.count_remainders(ignore_invalid_fields=True)
        for e, ex_counts in enumerate(remainder_counts):
            if ex_counts is False:
                continue
            relevant = (ex_counts.items() if channels is None else
                        [(c, n) for c, n in ex_counts.items()
                         if c in channels])
            if any(n < min_remainders for c, n in relevant):
                self.invalid_fields_mask[e] = False
        return self.invalid_fields_mask


class TimetraceExperiment(Experiment):
    """Continuously-filmed single field (flexlibrary.py:3266-3713)."""

    def __init__(self, frames, spot_traces=None, step_fits=None,
                 step_fit_intermediates=None):
        self.frames = frames
        self.spot_traces = spot_traces
        self.step_fits = step_fits
        self.step_fit_intermediates = (step_fit_intermediates
                                       if step_fit_intermediates is not None
                                       else {})

    def lc_create_traces(self, initial_spots=None, search_radius=3.0,
                         s_n_cutoff=3.0):
        first_frame, first_frame_index = None, None
        if initial_spots is not None:
            parent = initial_spots[0].parent_Image
            for f, frame in enumerate(self.frames):
                if frame is parent:
                    first_frame, first_frame_index = frame, f
                    break
            else:
                raise ValueError("All initial_spots must have the same "
                                 "parent_image, and it must be one of the "
                                 "frames in this experiment.")
        elif self.frames[0].spots is not None:
            initial_spots = self.frames[0].spots
            first_frame, first_frame_index = self.frames[0], 0
        else:
            raise ValueError("Cannot create traces unless either the first "
                             "frame does has Spots, or initial_spots are "
                             "specified via argument.")
        if not all(s.parent_Image is first_frame for s in initial_spots):
            raise ValueError("All initial_spots must have the same "
                             "parent_image, and it must be one of the frames "
                             "in this experiment.")
        raw_traces = tracking.luminosity_centroid_particle_tracking(
            frames=self.frames[first_frame_index:],
            initial_spots=initial_spots,
            search_radius=int(search_radius), s_n_cutoff=s_n_cutoff,
            offsets=None)
        for trace in raw_traces:
            for spot in trace:
                if spot is None:
                    continue
                if spot.parent_Image.spots is None:
                    spot.parent_Image.spots = []
                spot.parent_Image.spots.append(spot)
        self.spot_traces = [SimpleTrace(trace) for trace in raw_traces]
        return self.spot_traces

    def wildcolor_plot_tracks(self, filepath_prefix,
                              color_list=("red", "blue", "yellow", "purple",
                                          "orange", "pink", "lightblue",
                                          "green"), num_colors=8):
        saved = []
        if self.spot_traces is not None:
            colors = {t: random.choice(color_list[:num_colors])
                      for t, _ in enumerate(self.spot_traces)}
            frame_zfill = int(np.ceil(math.log(max(len(self.frames), 2), 10)))
            for f, frame in enumerate(self.frames):
                output_path = (filepath_prefix + str(f).zfill(frame_zfill) +
                               ".png")
                filler = tuple([0] * 12)
                psfs, square_colors = {}, {}
                for t, track in enumerate(self.spot_traces):
                    h, w = track.coordinates(f)
                    if h is None or w is None:
                        continue
                    psfs.setdefault((h, w), filler)
                    square_colors.setdefault((h, w), colors[t])
                saved.append(save_psfs_png(
                    psfs=psfs, image_path=frame.metadata["filepath"],
                    timestamp_epoch=None, output_path=output_path,
                    square_size=9, square_color=None,
                    square_colors=square_colors))
        return tuple(saved)

    def stepfit_tracks(self, photometry_min=None,
                       photometry_method="mexican_hat", mirror_start=0,
                       chung_kennedy=0, p_threshold=0.01, batched=True,
                       **kwargs):
        """Step-fit every track (flexlibrary.py:3642-3713).

        With ``batched=True`` (default) the Chung-Kennedy filter and the
        sliding-t detector run on the process default device over the full
        (num_tracks, num_frames) photometry stack (ops/stepfit_batch.py);
        results are identical to the per-trace host chain.
        """
        if batched and len(self.spot_traces) > 1:
            return self._stepfit_tracks_batched(
                photometry_min=photometry_min,
                photometry_method=photometry_method,
                mirror_start=mirror_start, chung_kennedy=chung_kennedy,
                p_threshold=p_threshold, **kwargs)
        step_fits = {}
        step_fit_intermediates = {}
        for t, trace in enumerate(self.spot_traces):
            h, w = trace.h, trace.w
            if (h, w) in step_fits:
                raise Exception("Two tracks have initial Spots with "
                                "identical (h, w).")
            (photometries, ck, plateaus, t_filtered) = \
                trace.stepfit_photometries(
                    h, w, mirror_start=mirror_start,
                    chung_kennedy=chung_kennedy, p_threshold=p_threshold,
                    photometry_min=photometry_min,
                    photometry_method=photometry_method, **kwargs)
            step_fits[(h, w)] = t_filtered
            step_fit_intermediates[(h, w)] = {
                "photometries": photometries,
                "ck_filtered_photometries": ck,
                "plateaus": plateaus,
                "t_filtered_plateaus": t_filtered,
            }
        self.step_fits = step_fits
        for (h, w), intermediates in step_fit_intermediates.items():
            self.step_fit_intermediates.setdefault((h, w), {})
            try:
                self.step_fit_intermediates[(h, w)].update(intermediates)
            except Exception:
                self.step_fit_intermediates[(h, w)] = intermediates
        return self.step_fits, self.step_fit_intermediates

    def _stepfit_tracks_batched(self, photometry_min=None,
                                photometry_method="mexican_hat",
                                mirror_start=0, chung_kennedy=0,
                                p_threshold=0.01, **kwargs):
        """Batched fast path of stepfit_tracks: the CK filter and the
        sliding-t detector over all tracks at once on the device."""
        from ..ops.stepfit_batch import stepfit_batched
        from .traces import PhotometryTrace, PlateauTrace
        hw = []
        phot_rows = []
        for trace in self.spot_traces:
            h, w = trace.h, trace.w
            if (h, w) in set(hw):
                raise Exception("Two tracks have initial Spots with "
                                "identical (h, w).")
            hw.append((h, w))
            phot_rows.append(trace.photometries(
                photometry_min=photometry_min,
                photometry_method=photometry_method, **kwargs))
        results = stepfit_batched(np.asarray(phot_rows, dtype=np.float64),
                                  mirror_start=mirror_start,
                                  chung_kennedy=chung_kennedy,
                                  p_threshold=p_threshold,
                                  device=default_device())
        step_fits = {}
        step_fit_intermediates = {}
        for (h, w), (photometries, ck, plateaus, t_filtered) in zip(hw,
                                                                    results):
            step_fits[(h, w)] = PlateauTrace(t_filtered, h, w)
            step_fit_intermediates[(h, w)] = {
                "photometries": PhotometryTrace(photometries, h, w),
                "ck_filtered_photometries": PhotometryTrace(ck, h, w),
                "plateaus": PlateauTrace(plateaus, h, w),
                "t_filtered_plateaus": PlateauTrace(t_filtered, h, w),
            }
        self.step_fits = step_fits
        for (h, w), intermediates in step_fit_intermediates.items():
            self.step_fit_intermediates.setdefault((h, w), {})
            try:
                self.step_fit_intermediates[(h, w)].update(intermediates)
            except Exception:
                self.step_fit_intermediates[(h, w)] = intermediates
        return self.step_fits, self.step_fit_intermediates

    def _get_all_intermediates(self):
        key_sets = {hw: set(d.keys())
                    for hw, d in self.step_fit_intermediates.items()}
        test_hw, test_set = key_sets.popitem()
        if not all(test_set == s for s in key_sets.values()):
            raise Exception("All traces must have identical intermediates.")
        return test_set

    def save_experiment_as_csv(self, output_path, dialect="excel",
                               include_step_fits=False,
                               photometry_method="mexican_hat",
                               include_intermediates=None, **kwargs):
        """Per-frame trace/step-fit CSV (flexlibrary.py:3550-3709)."""
        rows_written = 0
        with open(output_path, "w", newline="") as writer_file:
            writer = csv_module.writer(writer_file, dialect=dialect)
            header = ["Trace #", "Hcoord", "Wcoord", "Frame #", "Photometry"]
            if include_step_fits:
                header += ["Step #", "Plateau Height", "Step Size",
                           "Plateau Length", "Overall Fit R^2"]
            if include_intermediates is True:
                include_intermediates = list(self._get_all_intermediates())
            if include_intermediates is not None:
                include_intermediates = sorted(include_intermediates)
                header += [str(i) for i in include_intermediates]
            writer.writerow(header)
            rows_written += 1
            for t, trace in enumerate(self.spot_traces):
                row_base = [str(t), str(trace.h), str(trace.w)]
                trace_intermediates = \
                    self.step_fit_intermediates[(trace.h, trace.w)]
                if include_step_fits:
                    sf = self.step_fits[(trace.h, trace.w)]
                    sf_starts = sf.plateau_starts()
                    ls_num, ls_pos, ls_mag = sf.last_step_info(0)
                    (pa, po, ph), pi = sf.frame_plateau(0)
                    plateau_length = po - pa + 1
                    r_2 = Trace.coefficient_of_determination(
                        trace, sf, photometry_method=photometry_method,
                        **kwargs)
                if include_intermediates is not None:
                    inter_starts = {
                        i: trace_intermediates[i].plateau_starts()
                        for i in include_intermediates}
                    cache = {i: None for i in include_intermediates}
                for f in range(trace.num_frames):
                    row = row_base + [str(f)]
                    row += [trace.photometry(
                        f, photometry_method=photometry_method, **kwargs)]
                    if include_step_fits and f in sf_starts:
                        ls_num, ls_pos, ls_mag = sf.last_step_info(f)
                        (pa, po, ph), pi = sf.frame_plateau(f)
                        plateau_length = po - pa + 1
                    if include_step_fits:
                        row += [str(ls_num), str(ph), str(ls_mag),
                                str(plateau_length), str(r_2)]
                    if include_intermediates is not None:
                        for i, starts in inter_starts.items():
                            if f in starts:
                                cache[i] = (trace_intermediates[i].
                                            frame_output(f))
                        row += [str(cache[i]) for i in include_intermediates]
                    writer.writerow(row)
                    rows_written += 1
        return rows_written

    def save_traces_pkl(self, path):
        with open(path, "wb") as f:
            pickle.dump(self.spot_traces, f)

    def save_stepfits_as_csv(self, *args, **kwargs):
        raise DeprecationWarning(
            "save_stepfits_as_csv is deprecated in the reference "
            "(flexlibrary.py:3715, 'giant hairball') — use stepfit_tracks + "
            "save_experiment_as_csv(include_step_fits=True).")


def next_frame_spot_by_luminosity_centroid(spot, next_frame, offset=(0, 0),
                                           search_radius=3, s_n_cutoff=3.0):
    """Single-spot centroid descendant (flexlibrary.py:1172-1259).

    Retained for API parity; the batched path in tracking.py is used by
    luminosity_centroid_particle_tracking.
    """
    from scipy.ndimage import center_of_mass
    o_h, o_w = Experiment.unapply_offset((spot.h, spot.w), offset)
    o_h, o_w = int(o_h), int(o_w)
    sl = next_frame.image[o_h - search_radius:o_h + search_radius + 1,
                          o_w - search_radius:o_w + search_radius + 1]
    if sl.shape != (1 + 2 * search_radius, 1 + 2 * search_radius):
        return None
    c_h, c_w = center_of_mass(sl)
    r_c_h = int(tracking._py2_round(c_h + o_h - search_radius))
    r_c_w = int(tracking._py2_round(c_w + o_w - search_radius))
    try:
        next_spot = Spot(next_frame, r_c_h, r_c_w, spot.size,
                         gaussian_fit=None)
    except AttributeError:
        return None
    if next_spot.illumina_s_n() < s_n_cutoff:
        try:
            next_spot = Spot(next_frame, int(tracking._py2_round(spot.h)),
                             int(tracking._py2_round(spot.w)), spot.size,
                             gaussian_fit=None)
        except AttributeError:
            next_spot = None
    return next_spot


Experiment.next_frame_spot_by_luminosity_centroid = staticmethod(
    next_frame_spot_by_luminosity_centroid)
