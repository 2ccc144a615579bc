"""Host time of the port's span ``api/fetch_wait``: the calling thread
waiting for a group's results to reach the host (``api.py::run_zstack``'s
``collect``, ``_stack_step_groups``' ``resolve``), its total over the
window per call."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "result fetch: api.py::run_zstack collect, _stack_step_groups resolve"
MOVES = "images_per_s"

SPAN = "api/fetch_wait"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN, key="total")
