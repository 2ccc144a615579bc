"""Device time of the port's span ``api/zstack/background`` (CUDA events
around ``stack_background`` and the subtraction in
``api.py::run_zstack``'s ``dispatch_piece``), its total over the window
per call."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "background: ops/background.py::stack_background"
MOVES = "images_per_s"

SPAN = "api/zstack/background"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN)
