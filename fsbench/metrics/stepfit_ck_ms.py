"""Device time of the port's span ``api/stepfit/ck_masks`` (CUDA events
around each dispatch's enqueueing of the float64 Chung-Kennedy filter and
sliding-t step masks in ``ops/stepfit_batch.py::stepfit_batched``), its
total over the window per call."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "step-fit device stage: ops/stepfit_batch.py::_ck_and_masks"
MOVES = "images_per_s"

SPAN = "api/stepfit/ck_masks"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN)
