"""The port's counter ``detect/consolidate_rounds``: the fixpoint rounds
``ops/consolidate.py::consolidate`` ran (one host read each), summed over
its groups of images, over the window per call."""

from fsbench import program_registry

UNIT = "rounds"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "NMS: ops/consolidate.py::consolidate"
MOVES = "images_per_s"

COUNTER = "detect/consolidate_rounds"


def read(run):
    return program_registry.counter_per_call(run, COUNTER)
