"""Device time of the port's span ``api/step/photometry`` (CUDA events
around ``parallel/mesh.py::experiment_step``'s compaction of the kept
fits by R^2 and its spot photometry), its total over the window per call.
The worker thread's hole gathers share the stream and may fall inside."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "spot compaction and photometry: parallel/mesh.py::experiment_step, ops/photometry.py"
MOVES = "images_per_s"

SPAN = "api/step/photometry"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN)
