"""Device time of the port's span ``api/timetrace/track`` (CUDA events on
the calling thread's stream around the enqueueing of
``pipeline/fast_timetrace.py::lc_track_and_photometry``: the tracker's walk
over the frames, the window gathers of the photometry and the result
copies), its total over the window per call."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "movie tracker and photometry: pipeline/fast_timetrace.py::lc_track_and_photometry"
MOVES = "images_per_s"

SPAN = "api/timetrace/track"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN)
