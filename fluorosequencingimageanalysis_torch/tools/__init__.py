"""Measurement scripts for the port's kernels; each needs a CUDA card."""
