"""The port's host-clock stage ``api/run_stack`` (``Pipeline(profile=True)``),
its total over the window per call."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "grouped step: api.py::_stack_step_groups -> parallel/mesh.py::experiment_step"
MOVES = "images_per_s"
STAGE = "api/run_stack"


def read(run):
    total = (run.stages or {}).get(STAGE)
    if total is None or not run.calls:
        return None
    return 1e3 * total / len(run.calls)
