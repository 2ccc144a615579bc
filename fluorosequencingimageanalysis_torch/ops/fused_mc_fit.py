"""Kernel D: the Monte-Carlo random-search fit of every candidate, and the
switch to its twin.

``mc_fit`` launches csrc/mc_fit.cu on CUDA tensors and runs
``ops/mc_fit.py::mc_fit_plain`` on CPU tensors. Both return, for K
normalised 5x5 patches and (6, n_iter, K) sampled parameter vectors, the
first sample of least norm and that norm (see mc_fit_plain). A failed build
or launch raises; a CUDA tensor never takes the twin.
"""

from __future__ import annotations

import ctypes

import torch

from .mc_fit import mc_fit_plain


def _launch(patches, samples):
    from .. import _build
    fn = _build.load("mc_fit").mc_fit_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 +
                   [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    K, n_iter = patches.shape[0], samples.shape[1]
    dev = patches.device
    best_p = torch.empty((K, 6), dtype=torch.float32, device=dev)
    best_norm = torch.empty((K,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(patches.data_ptr(), samples.data_ptr(), K, n_iter,
                 best_p.data_ptr(), best_norm.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mc_fit kernel launch failed: CUDA error {err}")
    mc_fit.launches += 1
    return best_p, best_norm


def mc_fit(patches, samples):
    """(best_p (K, 6), best_norm (K,)) of K normalised (K, 5, 5) patches
    over (6, n_iter, K) samples: the hand-written kernel for contiguous
    float32 CUDA tensors, ``mc_fit_plain`` for CPU tensors."""
    if patches.ndim != 3 or patches.shape[1:] != (5, 5):
        raise ValueError(f"mc_fit: (K, 5, 5) patches required, got "
                         f"{tuple(patches.shape)}")
    if samples.ndim != 3 or samples.shape[0] != 6 or \
            samples.shape[2] != patches.shape[0]:
        raise ValueError(f"mc_fit: (6, n_iter, K) samples required for "
                         f"K = {patches.shape[0]}, got "
                         f"{tuple(samples.shape)}")
    if patches.device.type == "cpu":
        return mc_fit_plain(patches, samples)
    if patches.device.type != "cuda":
        raise ValueError(f"mc_fit: unsupported device {patches.device}")
    if samples.device != patches.device:
        raise ValueError("mc_fit: patches and samples must share a device")
    if patches.dtype != torch.float32 or samples.dtype != torch.float32:
        raise TypeError(f"mc_fit: float32 inputs required on the card, got "
                        f"{patches.dtype} and {samples.dtype}")
    if not (patches.is_contiguous() and samples.is_contiguous()):
        raise ValueError("mc_fit: contiguous inputs required")
    return _launch(patches, samples)


mc_fit.launches = 0
