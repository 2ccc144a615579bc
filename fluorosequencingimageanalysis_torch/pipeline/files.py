"""The sequencing run's file front door: image files sorted by the
directory = cycle, file name = field convention (flexlibrary.py:1105-1154)
and read into the [F, C, H, W] stack that ``Pipeline.run_experiment``
takes (``Pipeline.run_experiment_files``, the ``run-experiment``
subcommand).

While tracing is on (``utils.profiling``), host spans ``api/files/sort``,
``api/files/read`` (the decodes) and ``api/files/assemble`` (the stacking)
time the three steps, and counters ``files/read`` and ``files/bytes``
count the files decoded and the bytes of their arrays.
"""

from __future__ import annotations

import numpy as np

from ..utils import profiling


class FileLayoutError(ValueError):
    """Files that do not make one stack: cycle directories that hold
    different numbers of field files, or channels of different cycle
    counts."""


def load_stack(files):
    """files -> ([F, C, H, W] array, cycle count): one
    ``read_image_array`` a file, each field's cycles stacked as they are
    read, then the fields."""
    from ..utils.imageio import read_image_array
    from .experiment import Experiment

    with profiling.span("api/files/sort"):
        frame_indexed, field_indexed = \
            Experiment.easy_sort_target_images(files)
    n_fields = {len(v) for v in frame_indexed.values()}
    if len(n_fields) != 1:
        raise FileLayoutError(
            "every cycle directory must hold the same number of field "
            f"files (got counts {sorted(n_fields)})")
    fields = []
    for f in sorted(field_indexed):
        with profiling.span("api/files/read"):
            cycles = [read_image_array(p) for p in field_indexed[f]]
        with profiling.span("api/files/assemble"):
            fields.append(np.stack(cycles))
        # Freed before the next field's reads, which then reuse its pages:
        # held one field longer, every read faults in new memory (twice
        # the page faults of the whole load, measured).
        del cycles
    with profiling.span("api/files/assemble"):
        stack = np.stack(fields)
    if profiling.enabled():
        profiling.bump("files/read", stack.shape[0] * stack.shape[1])
        profiling.bump("files/bytes", stack.nbytes)
    return stack, stack.shape[1]
