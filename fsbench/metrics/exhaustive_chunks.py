"""The port's counter ``detect/exhaustive_chunks`` per call: the chunks
of ``EXHAUSTIVE_CHUNK`` candidates that ``models/detect.py::
detect_and_fit_exhaustive`` extracted and fitted, counted once a group
while tracing is on (3 a group of 8 frames at ~11,700 candidates a frame,
12 a call of ``zstack.exhaustive``). A port without the counter reads
None."""

from fsbench import program_registry

UNIT = "chunks"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "exhaustive detect: models/detect.py::detect_and_fit_exhaustive"
MOVES = "images_per_s"

CHUNKS = "detect/exhaustive_chunks"


def read(run):
    return program_registry.counter_per_call(run, CHUNKS)
