"""Host time of the port's span ``api/detect/host_nms``
(``models/detect.py::detect_and_fit_exhaustive``: the wait on the chunks'
copies to the host, their concatenation and ``ops/consolidate.py::
consolidate_host`` over every image of the group, on the calling thread),
its total over the window per call. A port without the span reads None."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "host NMS: ops/consolidate.py::consolidate_host"
MOVES = "images_per_s"

SPAN = "api/detect/host_nms"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN, key="total")
