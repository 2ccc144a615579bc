"""Kernel A (the candidate map) against its roofline over the window: the
least time the chip could take for every call's pixels, over the device
time of the kernel by its symbol in the trace."""

from fsbench.roofline import kernel_a_bound_s

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = ("candidate map: ops/fused_candidates.py -> "
         "csrc/candidate_map.cu")
MOVES = "images_per_s"
SYMBOL = "candidate_map_kernel"


def read(run):
    spent = run.kernel_seconds(SYMBOL)
    if not spent:
        return None
    bound = sum(kernel_a_bound_s(w["pixels"]) for w in run.call_work())
    return 100.0 * bound / spent
