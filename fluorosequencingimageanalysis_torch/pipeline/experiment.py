"""The category-counts CSV of an experiment, and the timetrace container.

Counterpart of ``write_category_counts_csv`` in
fluorosequencingimageanalysis_tpu/pipeline/experiment.py (the reference's
category_counts_as_csv), of ``Experiment.easy_sort_target_images``, as a
function, and of ``TimetraceExperiment``'s container and CSV half. The
other experiment classes are not ported; ``api.Pipeline.run_experiment``
and ``run_timetrace`` are the port's experiment surfaces.
"""

from __future__ import annotations

import csv as csv_module
import os
import pickle

from .traces import Trace


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


def truefalse_to_onoff(pattern):
    """A category tuple as the reference's ``[ON] [OFF] ...`` string."""
    return " ".join(["[ON] " if p else "[OFF]" for p in pattern])


def write_category_counts_csv(to_save, filepath, collate_fields=False,
                              dialect="excel"):
    """Write a {channel: {field: {pattern: count}}} dict as the reference's
    Pattern[,Field],Channel,Count CSV. Patterns are sorted; fields present
    in the dict with zero patterns still contribute count-0 rows under
    ``collate_fields``. Returns ``filepath``."""
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
            base = [truefalse_to_onoff(pattern)]
            for chan in to_save_channels:
                if collate_fields:
                    for e, ex in to_save[chan].items():
                        output_writer.writerow(
                            base + [str(e), str(chan),
                                    str(ex.get(pattern, 0))])
                else:
                    count = sum(ex.get(pattern, 0)
                                for ex in to_save[chan].values())
                    output_writer.writerow(base + [str(chan), str(count)])
    return filepath


class TimetraceExperiment:
    """Continuously-filmed single field (flexlibrary.py:3266-3713): the
    container ``api.Pipeline.run_timetrace`` fills and its per-frame CSV.

    Of the JAX package's class this holds ``__init__``,
    ``_get_all_intermediates``, ``save_experiment_as_csv`` and
    ``save_traces_pkl``. ``lc_create_traces``, ``stepfit_tracks`` and
    ``wildcolor_plot_tracks`` work on ``Spot`` and ``Image`` objects, which
    the port does not have yet (ROADMAP.md Queue 1 item 17); the
    array-native ``run_timetrace`` does their work.
    """

    def __init__(self, frames, spot_traces=None, step_fits=None,
                 step_fit_intermediates=None):
        self.frames = frames
        self.spot_traces = spot_traces
        self.step_fits = step_fits
        self.step_fit_intermediates = (step_fit_intermediates
                                       if step_fit_intermediates is not None
                                       else {})

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
