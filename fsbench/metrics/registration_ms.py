"""Device time of the port's span ``api/step/registration`` (CUDA events
around ``phase_correlate_stack`` in
``parallel/mesh.py::experiment_step``), its total over the window per
call."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "registration: ops/registration.py::phase_correlate_stack"
MOVES = "images_per_s"

SPAN = "api/step/registration"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN)
