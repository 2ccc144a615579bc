"""The category-counts CSV of an experiment.

Counterpart of ``write_category_counts_csv`` in
fluorosequencingimageanalysis_tpu/pipeline/experiment.py (the reference's
category_counts_as_csv) and of ``Experiment.easy_sort_target_images``, as
a function. The experiment classes themselves are not ported;
``api.Pipeline.run_experiment`` is the port's experiment surface.
"""

from __future__ import annotations

import csv as csv_module
import os


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
