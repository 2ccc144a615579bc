"""Host time of the port's span ``api/track/lookup``
(``pipeline/fast_experiment.py::run_experiment_stack``: the group's
traces concatenated, the step's per-spot values looked up at their
detected positions and the hole mask, once a group on the worker
thread), its total over the window per call. A port without the span
reads None."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host tracking and photometry: pipeline/fast_experiment.py, native/tracklink.py"
MOVES = "images_per_s"

SPAN = "api/track/lookup"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN, key="total")
