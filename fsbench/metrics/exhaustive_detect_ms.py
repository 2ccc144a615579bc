"""Device time of the port's span ``api/detect/exhaustive`` (CUDA events
on the calling thread's stream in ``models/detect.py::
detect_and_fit_exhaustive``, from the candidate maps to the last chunk's
fits and the start of its copy to the host), its total over the window per
call. The span holds the host read of the candidate counts after the first
extraction, so the device interval includes the host's wait there and the
enqueueing after it. A port without the span reads None."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "exhaustive detect: models/detect.py::detect_and_fit_exhaustive"
MOVES = "images_per_s"

SPAN = "api/detect/exhaustive"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN)
