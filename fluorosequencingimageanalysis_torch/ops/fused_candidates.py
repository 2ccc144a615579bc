"""Kernel A: the fused candidate map, and its plain PyTorch twin.

Counterpart of fluorosequencingimageanalysis_tpu/ops/pallas_candidates.py.
``candidate_map_fused`` launches csrc/candidate_map.cu on a CUDA tensor and
runs ``candidate_map_plain`` on a CPU tensor. Like the JAX package it takes
the kernel only for a 5x5 median with a 5x5 template; other sizes take the
plain recipe on either device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .candidates import correlation_maps


def candidate_map_plain(images, kernel, median_filter_size=5):
    """The ``_correlation_maps`` recipe: ``max(correlate(x - min(med(x),
    x), kernel, 'same'), 0)`` with a symmetric-boundary median and a
    zero-padded correlation, over the last two axes."""
    k = torch.as_tensor(np.asarray(kernel), dtype=images.dtype,
                        device=images.device)
    return correlation_maps(images, median_filter_size, k)


def _launch(images, taps):
    from .. import _build
    lib = _build.load("candidate_map")
    fn = lib.candidate_map_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, H, W = images.shape
    out = torch.empty_like(images)
    taps_c = (ctypes.c_float * 25)(*taps)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    with torch.cuda.device(images.device):
        err = fn(images.data_ptr(), out.data_ptr(), B, H, W,
                 ctypes.cast(taps_c, ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"candidate_map kernel launch failed: CUDA "
                           f"error {err}")
    candidate_map_fused.launches += 1
    return out


def candidate_map_fused(images, kernel, median_filter_size=5):
    """Correlation maps of (B, H, W) or (H, W) float32 images.

    kernel: the correlation template (numpy or sequence). CUDA tensors go
    through the hand-written kernel (float32, contiguous, at most 65535
    images); CPU tensors through ``candidate_map_plain``.
    """
    kern = np.asarray(kernel, dtype=np.float64)
    if median_filter_size != 5 or kern.shape != (5, 5):
        return candidate_map_plain(images, kern, median_filter_size)
    if images.device.type == "cpu":
        return candidate_map_plain(images, kern)
    if images.device.type != "cuda":
        raise ValueError(f"candidate_map_fused: unsupported device "
                         f"{images.device}")
    if images.dtype != torch.float32:
        raise TypeError(f"candidate_map_fused: float32 required, got "
                        f"{images.dtype}")
    if images.ndim not in (2, 3) or min(images.shape) == 0:
        raise ValueError(f"candidate_map_fused: (B, H, W) or (H, W) "
                         f"images required, got {tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("candidate_map_fused: contiguous images required")
    single = images.ndim == 2
    batch = images[None] if single else images
    if batch.shape[0] > 65535:
        raise ValueError("candidate_map_fused: at most 65535 images per "
                         "launch")
    out = _launch(batch, kern.astype(np.float32).reshape(-1).tolist())
    return out[0] if single else out


candidate_map_fused.launches = 0
