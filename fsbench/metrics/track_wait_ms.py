"""Host time of the port's span ``api/run_experiment/track_wait``
(``api.py::run_experiment``: the calling thread's wait on the worker's
host half after the last group's step, the part of it the steps do not
hide), its total over the window per call. A port without the span reads
None."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host tracking and photometry: pipeline/fast_experiment.py, native/tracklink.py"
MOVES = "images_per_s"

SPAN = "api/run_experiment/track_wait"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN, key="total")
