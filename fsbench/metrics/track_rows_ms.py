"""Host time of the port's span ``api/track/rows``
(``pipeline/fast_experiment.py::_rows_by_field``: the group's per-field
row lists, once a group on the worker thread), its total over the window
per call. A port without the span reads None."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host tracking and photometry: pipeline/fast_experiment.py, native/tracklink.py"
MOVES = "images_per_s"

SPAN = "api/track/rows"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN, key="total")
