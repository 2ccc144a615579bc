"""Host time of the port's span ``api/run_timetrace/csv`` (the result
objects' CSV with the step-fit and intermediate columns,
``pipeline/experiment.py::TimetraceExperiment.save_experiment_as_csv``),
its total over the window per call."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "timetrace CSV: pipeline/experiment.py::TimetraceExperiment.save_experiment_as_csv"
MOVES = "images_per_s"

SPAN = "api/run_timetrace/csv"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN, key="total")
