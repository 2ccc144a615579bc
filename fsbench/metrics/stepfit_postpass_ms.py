"""Host time of the port's span ``api/stepfit/postpass`` (the native
step-fit post-pass, ``native/stepchain.py`` over ``csrc/stepchain.cpp``:
plateau assembly, refit and the drop-sort t-test merge, threaded over the
traces), its total over the window per call."""

from fsbench import program_registry

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "step-fit post-pass: native/stepchain.py -> csrc/stepchain.cpp"
MOVES = "images_per_s"

SPAN = "api/stepfit/postpass"


def read(run):
    return program_registry.span_ms_per_call(run, SPAN, key="total")
