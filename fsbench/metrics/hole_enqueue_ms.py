"""Host time of the port's span ``api/track/hole_enqueue``
(``pipeline/fast_experiment.py::run_experiment_stack``: the hole
gathers' index arrays, their pinned copy, the gather and reduction
launches and their fetch started, once a group with holes on the worker
thread), its total over the window per call. A port without the span
reads None."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host tracking and photometry: pipeline/fast_experiment.py, native/tracklink.py"
MOVES = "images_per_s"

SPAN = "api/track/hole_enqueue"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN, key="total")
