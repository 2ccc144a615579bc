"""Kernel B (LM fit + quality) against its roofline over the window: the
least time the chip could take for the fits that every call's inputs
need (their candidates, capped at the bucket, as the benchmark's own
extraction counts them), over the device time of the kernel by its
symbol in the trace."""

from fsbench.roofline import kernel_b_bound_s

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "fit + quality: ops/fused_fit.py -> csrc/fit_quality.cu"
MOVES = "images_per_s"
SYMBOL = "fit_quality_kernel"


def read(run):
    spent = run.kernel_seconds(SYMBOL)
    if not spent:
        return None
    bound = sum(kernel_b_bound_s(w["fits"], w["num_iters"],
                                 w["theta_starts"])
                for w in run.call_work())
    return 100.0 * bound / spent
