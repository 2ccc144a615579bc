"""Host time of the port's span ``api/track/link``
(``pipeline/fast_experiment.py::run_experiment_stack``: a field's
cumulative offsets and ``_link_field`` (the dropout discard, the native
greedy linking of ``csrc/tracklink.cpp``, the chain roots and trace
ranks), once a field on the worker thread), its total over the window
per call. A port without the span reads None."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host tracking and photometry: pipeline/fast_experiment.py, native/tracklink.py"
MOVES = "images_per_s"

SPAN = "api/track/link"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN, key="total")
