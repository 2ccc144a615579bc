"""Device time of the port's span ``api/detect/consolidate`` (CUDA events on
the calling thread's stream around ``consolidate`` in
``models/detect.py::detect_and_fit_batch``, host waits between the
fixpoint rounds included), its total over the window per call."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "NMS: ops/consolidate.py::consolidate"
MOVES = "images_per_s"

SPAN = "api/detect/consolidate"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN)
