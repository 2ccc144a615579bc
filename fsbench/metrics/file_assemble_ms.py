"""Host time of the port's span ``api/files/assemble`` (the stacking of
the decoded images into the [F, C, H, W] stack: each field's cycles, then
the fields, in ``pipeline/files.py::load_stack``), its total over the
window per call. A port without the span reads None."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "file front door: pipeline/files.py::load_stack"
MOVES = "images_per_s"

SPAN = "api/files/assemble"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN, key="total")
