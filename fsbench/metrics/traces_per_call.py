"""The port's counter ``experiment/traces`` per call: the traces that
``pipeline/fast_experiment.py::_link_field`` linked, summed over fields
before the validity filter, counted once a group while tracing is on. A
port without the counter reads None."""

from fsbench import program_registry

UNIT = "traces"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "host tracking and photometry: pipeline/fast_experiment.py, native/tracklink.py"
MOVES = "images_per_s"

COUNTER = "experiment/traces"


def read(run):
    return program_registry.counter_per_call(run, COUNTER)
