"""Peaks of the chip and the operations and bytes of the port's kernels.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
67 TFLOP/s in float32 outside the tensor cores (an FMA counts 2) and
3.35 TB/s of HBM3. A card set below 700 W reaches less; the share is
stated against the published peak.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# Kernel A (candidate map), per pixel: the 25-element median (174
# min/max), x - min(med, x) (2), 25 template taps (25 FMAs = 50) and the
# clamp at 0 (1). Bytes: the image pixel in and the map pixel out.
A_OPS_PER_PIXEL = 174 + 2 + 50 + 1
A_BYTES_PER_PIXEL = 2 * 4

# Kernel B (LM fit + quality), per fit, start and iteration: 25 pixels x
# ~130 flops (~110 for the model, Jacobian, gradient and the 28 entries of
# the normal matrix, ~20 for the trial cost) and ~250 for the damped 7x7
# Cholesky solve. The kernel runs at most two starts. Bytes per fit: its
# 25 pixels and 2 coordinates in, 12 floats out.
B_FLOPS_PER_PIXEL_ITER, B_FLOPS_SOLVE = 130, 250
B_BYTES_PER_FIT = 25 * 4 + 2 * 4 + 12 * 4


def bound_s(nbytes, ops):
    """The least time (s) the chip could take: bytes over the memory rate
    or operations over the float32 rate, whichever is longer."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS)


def kernel_a_bound_s(pixels):
    return bound_s(pixels * A_BYTES_PER_PIXEL, pixels * A_OPS_PER_PIXEL)


def kernel_b_bound_s(fits, num_iters, theta_starts):
    ops = (fits * min(theta_starts, 2) * num_iters *
           (25 * B_FLOPS_PER_PIXEL_ITER + B_FLOPS_SOLVE))
    return bound_s(fits * B_BYTES_PER_FIT, ops)
