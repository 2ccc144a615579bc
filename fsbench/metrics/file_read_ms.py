"""Host time of the port's span ``api/files/read`` (the decodes of the
call's image files, ``utils/imageio.py::read_image_array`` a file, in
``pipeline/files.py::load_stack``), its total over the window per call.
A port without the span reads None."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "file front door: pipeline/files.py::load_stack"
MOVES = "images_per_s"

SPAN = "api/files/read"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN, key="total")
