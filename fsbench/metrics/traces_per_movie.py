"""The port's counter ``timetrace/traces`` per call: the tracks that
``run_timetrace`` started on frame 0 (the rounded centers of its kept
fits), counted once a call while tracing is on."""

from fsbench import program_registry

UNIT = "traces"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "movie tracker and photometry: pipeline/fast_timetrace.py::lc_track_and_photometry"
MOVES = "images_per_s"

TRACES = "timetrace/traces"


def read(run):
    return program_registry.counter_per_call(run, TRACES)
