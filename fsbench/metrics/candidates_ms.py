"""Device time of the port's span ``api/detect/candidates`` (CUDA events
around ``find_candidates_batch`` in
``models/detect.py::detect_and_fit_batch``: kernel A, the threshold, the
ordered extraction), its total over the window per call."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "candidates: ops/candidates.py::find_candidates_batch -> csrc/candidate_map.cu"
MOVES = "images_per_s"

SPAN = "api/detect/candidates"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN)
