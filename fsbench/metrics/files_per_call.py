"""The port's counter ``files/read`` per call: the image files that
``pipeline/files.py::load_stack`` decoded, counted while tracing is on
(fields x cycles, 384 a call of ``seqrun.files``). A port without the
counter reads None."""

from fsbench import program_registry

UNIT = "files"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "file front door: pipeline/files.py::load_stack"
MOVES = "images_per_s"

FILES = "files/read"


def read(run):
    return program_registry.counter_per_call(run, FILES)
