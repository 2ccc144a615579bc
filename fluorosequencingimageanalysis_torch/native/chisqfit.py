"""ctypes binding of the batched Kerssemakers chi-squared step fitter
(csrc/chisqfit.cpp).

Counterpart of fluorosequencingimageanalysis_tpu/native/chisqfit.py; the
C++ source is that package's. The reference's chi-squared fitter
(stepfitting_library.py:342-505) is sequential per trace but independent
across traces; this core runs the exact per-trace chain in C++ for a whole
(N, T) batch, threaded. Per-trace results are bit-equal to
``stepfitting.chi_squared_step_fitter`` (the host oracle). ``_build``
compiles the source with g++ at first use, without FMA contraction; a
failed build raises with the compiler's output, and there is no Python
fallback. Host work only: it has no device part.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build
from .stepchain import default_threads

_I32 = np.ctypeslib.ndpointer(np.int32, flags="C")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C")


def _lib():
    lib = _build.load("chisqfit")
    fn = lib.cs_chisq_batch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        _F64,                              # traces (N, T)
        ctypes.c_int32, ctypes.c_int32,    # N, T
        ctypes.c_int32, ctypes.c_int32,    # num_plateaus, min_step_length
        ctypes.c_double, ctypes.c_int32,   # min_step_magnitude, ignore_cf
        ctypes.c_int32,                    # n_threads
        _I32, _I32, _I32, _F64,            # out n/start/stop/height
    ]
    return lib


def chisq_fit_batch_native(traces, num_plateaus, min_step_length,
                           min_step_magnitude, ignore_counterfits,
                           n_threads=None):
    """Run the chi-squared fitter over (N, T) traces in the native core.

    Returns (n, start, stop, height): per-trace plateau counts and the
    [N, T]-buffered plateau triples (row i's plateaus are
    (start[i, :n[i]], stop[i, :n[i]], height[i, :n[i]])).
    """
    traces = np.ascontiguousarray(traces, dtype=np.float64)
    if traces.ndim != 2:
        raise ValueError("traces must be (N, T)")
    N, T = traces.shape
    if T < 2:
        raise ValueError("chi-squared fitting needs at least 2 frames")
    if not 1 <= num_plateaus <= T:
        raise ValueError(f"num_plateaus={num_plateaus} out of range for "
                         f"T={T}")
    lib = _lib()
    if n_threads is None:
        n_threads = default_threads()
    out_n = np.zeros(N, np.int32)
    out_start = np.zeros((N, T), np.int32)
    out_stop = np.zeros((N, T), np.int32)
    out_height = np.zeros((N, T), np.float64)
    rc = lib.cs_chisq_batch(traces, np.int32(N), np.int32(T),
                            np.int32(num_plateaus),
                            np.int32(min_step_length),
                            float(min_step_magnitude),
                            np.int32(1 if ignore_counterfits else 0),
                            np.int32(n_threads), out_n, out_start,
                            out_stop, out_height)
    if rc != 0:
        raise RuntimeError(f"cs_chisq_batch failed (rc={rc})")
    return out_n, out_start, out_stop, out_height
