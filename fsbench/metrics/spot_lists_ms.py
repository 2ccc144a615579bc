"""Host time of the port's span ``api/track/spot_lists``
(``api.py::run_experiment``'s ``_spot_lists``: the step's per-image spot
buckets cut into per-field, per-cycle lists, once a group on the worker
thread), its total over the window per call. A port without the span
reads None."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host tracking and photometry: pipeline/fast_experiment.py, native/tracklink.py"
MOVES = "images_per_s"

SPAN = "api/track/spot_lists"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN, key="total")
