"""The port's counter ``experiment/holes`` per call: the hole positions
that ``pipeline/fast_experiment.py::run_experiment_stack`` handed to the
device gathers, counted once a group while tracing is on. A port without
the counter reads None."""

from fsbench import program_registry

UNIT = "holes"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "host tracking and photometry: pipeline/fast_experiment.py, native/tracklink.py"
MOVES = "images_per_s"

COUNTER = "experiment/holes"


def read(run):
    return program_registry.counter_per_call(run, COUNTER)
