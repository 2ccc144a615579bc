"""ctypes binding of the native step-fit post-pass (csrc/stepchain.cpp).

Counterpart of fluorosequencingimageanalysis_tpu/native/stepchain.py; the
C++ source is that package's. The device stage (ops/stepfit_batch.py)
computes Chung-Kennedy traces and sliding-t step masks for thousands of
traces at once; this core runs the rest of the per-trace chain (plateau
assembly, refit on the raw trace, the iterated drop-sort Welch-t merge
filter of stepfitting.py's ``t_test_filter``) in C++, threaded over the
traces. ``_build`` compiles the source with g++ at first use, without
FMA contraction (the core promises the Python chain's float results bit
for bit); a failed build raises with the compiler's output, and there is
no Python fallback.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build

_I32 = np.ctypeslib.ndpointer(np.int32, flags="C")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C")


def default_threads() -> int:
    """Threads the native step-fit cores use unless told otherwise."""
    return min(os.cpu_count() or 1, 16)


def _lib():
    lib = _build.load("stepchain")
    fn = lib.sc_postpass
    fn.restype = ctypes.c_int
    fn.argtypes = [
        _F64, _U8,                       # raw, mask (N, Tm)
        ctypes.c_int32, ctypes.c_int32,  # N, Tm
        ctypes.c_double, ctypes.c_int32,  # p_threshold, no_merge
        ctypes.c_int32,                  # n_threads
        _I32, _I32, _I32, _F64,          # refit n/start/stop/height
        _I32, _I32, _I32, _F64,          # tfil n/start/stop/height
    ]
    wb = lib.sc_welch_p_batch
    wb.restype = None
    wb.argtypes = [_F64, _I32, _I32, _F64, _I32, _I32,
                   ctypes.c_int32, _F64]
    return lib


def stepfit_postpass(raw, mask, p_threshold, no_merge_start, n_threads=None):
    """Run the plateau-assembly + refit + drop-sort-t-merge chain on
    (N, Tm) mirrored raw traces and their step masks.

    Returns (refit_n, refit_start, refit_stop, refit_height,
    tfil_n, tfil_start, tfil_stop, tfil_height): plateau triples are
    (start[i, :n], stop[i, :n], height[i, :n]) per trace i.
    """
    lib = _lib()
    raw = np.ascontiguousarray(raw, dtype=np.float64)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    N, Tm = raw.shape
    if mask.shape != (N, Tm):
        raise ValueError("mask must match raw's (N, T) shape")
    if Tm and mask[:, 0].any():
        # A step at frame 0 would open a plateau that ends before it
        # starts; the host chain raises ValueError on the same input
        # (stepfitting._fit_plateau), and excluding it also bounds the
        # plateau count at Tm (the width of the output buffers).
        raise ValueError("step mask hit at frame 0: plateaus start "
                         "after the first step frame")
    if n_threads is None:
        n_threads = default_threads()
    refit_n = np.zeros(N, np.int32)
    tfil_n = np.zeros(N, np.int32)
    refit_start = np.zeros((N, Tm), np.int32)
    refit_stop = np.zeros((N, Tm), np.int32)
    refit_height = np.zeros((N, Tm), np.float64)
    tfil_start = np.zeros((N, Tm), np.int32)
    tfil_stop = np.zeros((N, Tm), np.int32)
    tfil_height = np.zeros((N, Tm), np.float64)
    rc = lib.sc_postpass(raw, mask, np.int32(N), np.int32(Tm),
                         float(p_threshold), np.int32(no_merge_start),
                         np.int32(n_threads), refit_n, refit_start,
                         refit_stop, refit_height, tfil_n, tfil_start,
                         tfil_stop, tfil_height)
    if rc != 0:
        raise RuntimeError(f"sc_postpass failed (rc={rc})")
    return (refit_n, refit_start, refit_stop, refit_height,
            tfil_n, tfil_start, tfil_stop, tfil_height)


def welch_p_batch(segments_a, segments_b):
    """Two-tailed Welch p for pairs of 1-D arrays (testing hook)."""
    lib = _lib()
    a_cat = np.ascontiguousarray(np.concatenate(segments_a), np.float64)
    b_cat = np.ascontiguousarray(np.concatenate(segments_b), np.float64)
    a_len = np.array([len(s) for s in segments_a], np.int32)
    b_len = np.array([len(s) for s in segments_b], np.int32)
    a_off = np.concatenate([[0], np.cumsum(a_len[:-1])]).astype(np.int32)
    b_off = np.concatenate([[0], np.cumsum(b_len[:-1])]).astype(np.int32)
    out = np.empty(len(segments_a), np.float64)
    lib.sc_welch_p_batch(a_cat, a_off, a_len, b_cat, b_off, b_len,
                         np.int32(len(segments_a)), out)
    return out
