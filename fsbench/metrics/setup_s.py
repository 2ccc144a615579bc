"""Process start to the start of the window: the imports, the CUDA
context, the kernels' load (and build, in a new checkout), the inputs
drawn on the device and the warm-up calls."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
