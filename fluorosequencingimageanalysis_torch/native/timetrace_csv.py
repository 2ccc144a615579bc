"""ctypes binding of the native timetrace CSV writer
(csrc/timetrace_csv.cpp).

``run_timetrace`` writes its CSV here, from the step fitter's arrays
(``ops/stepfit_batch.py::stepfit_arrays``): the same bytes that
``pipeline/experiment.py::TimetraceExperiment.save_experiment_as_csv``
writes for the same results, with no Python object per row or cell. The
core formats contiguous blocks of traces on several threads and writes
them in order; the file is complete and closed when :func:`write` returns.
``_build`` compiles the source with g++ at first use; a failed build
raises with the compiler's output, and there is no Python fallback.
"""

from __future__ import annotations

import csv
import ctypes
import io
import os
import sys

import numpy as np

from .. import _build
from .stepchain import default_threads

# The intermediates of every run_timetrace fit, by the code the core
# takes for each.
INTERMEDIATES = {"ck_filtered_photometries": 0, "photometries": 1,
                 "plateaus": 2, "t_filtered_plateaus": 3}
HEADER = ["Trace #", "Hcoord", "Wcoord", "Frame #", "Photometry"]
STEP_FIT_HEADER = ["Step #", "Plateau Height", "Step Size",
                   "Plateau Length", "Overall Fit R^2"]

_I32 = np.ctypeslib.ndpointer(np.int32, flags="C")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C")
_C64 = ctypes.c_int64

# CPython's sum() of floats is Neumaier-compensated from 3.12 on; the
# fit's R^2 follows the running interpreter's.
_NEUMAIER = int(sys.version_info >= (3, 12))


def _lib():
    lib = _build.load("timetrace_csv")
    fn = lib.ttcsv_write
    fn.restype = _C64
    fn.argtypes = [
        ctypes.c_int32, ctypes.c_char_p, _C64,   # fd, header, its length
        _C64, _C64, _I64, _I64,                  # N, T, h0, w0
        _F64, _F64,                              # photometries, CK (N, T)
        _I32, _I32, _I32, _F64, _C64,            # refit n/start/stop/h, W
        _I32, _I32, _I32, _F64, _C64,            # t-filtered, the same
        ctypes.c_int32, _I32, ctypes.c_int32,    # step fits, columns
        ctypes.c_int32, ctypes.c_int32, _I64,    # neumaier, threads, fault
    ]
    fmt = lib.ttcsv_format_doubles
    fmt.restype = None
    fmt.argtypes = [_F64, _C64, ctypes.c_char_p, _I64]
    r2 = lib.ttcsv_r_squared
    r2.restype = None
    r2.argtypes = [_F64, _C64, _C64, _I32, _I32, _I32, _F64, _C64,
                   ctypes.c_int32, _F64, _F64, _I64]
    return lib


def _plateaus(p, N):
    """(n, start, stop, height) as C arrays of N rows."""
    n, s, e, h = p
    n = np.ascontiguousarray(n, np.int32)
    s, e, h = (np.ascontiguousarray(a, dt)
               for a, dt in ((s, np.int32), (e, np.int32), (h, np.float64)))
    if n.shape != (N,) or s.ndim != 2 or s.shape[0] != N or \
            not s.shape == e.shape == h.shape or \
            (N and int(n.max()) > s.shape[1]) or (N and int(n.min()) < 0):
        raise ValueError("plateaus must be (n, start, stop, height) with "
                         "0 <= n <= the arrays' width, one row a trace")
    return n, s, e, h


def _header(include_step_fits, names):
    buf = io.StringIO(newline="")
    csv.writer(buf, dialect="excel").writerow(
        HEADER + (STEP_FIT_HEADER if include_step_fits else []) +
        [str(i) for i in names])
    return buf.getvalue().encode()


def _raise(code, trace, frame, refit, t_filtered):
    """The exception the class method raises for the core's fault."""
    if code == 1:
        raise TypeError("unsupported operand type(s) for -: 'NoneType' and "
                        f"'NoneType' (trace {trace}: no t-filtered plateau "
                        f"holds frame {frame})")
    if code == 2:
        raise Exception("trace_A and trace_B must cover an identical "
                        "number of frames for comparison to be valid.")
    if code in (3, 4):
        n, s, e, h = t_filtered if code == 3 else refit
        k = int(n[trace])
        plateaus = list(zip(s[trace, :k].tolist(), e[trace, :k].tolist(),
                            h[trace, :k].tolist()))
        raise ValueError("frame " + str(frame) + " is outside of plateaus " +
                         str(plateaus))
    if code == 5:
        raise ZeroDivisionError("float division by zero")
    raise OverflowError(34, "Numerical result out of range")


def write(path, h0, w0, fits, include_step_fits=False,
          include_intermediates=None, n_threads=None):
    """Write the timetrace CSV of N traces to ``path``.

    ``h0``, ``w0``: the traces' integer start keys (N); ``fits``: a
    ``stepfit_batch.StepfitArrays`` (or any object with its fields
    ``phot``, ``ck``, ``refit``, ``t_filtered``) of the same N traces of
    T frames. ``include_step_fits`` and ``include_intermediates`` are
    ``save_experiment_as_csv``'s: True means the four intermediates every
    fit has, and the names come in sorted order. Row i is trace i with its
    own fits (the class method looks a trace's fits up by its start key,
    which ``run_timetrace`` keeps unique). Returns the rows written, the
    header included, as the class method does. Where the class method
    raises (an unknown intermediate, a frame no plateau holds, a constant
    trace's R^2), this raises the same exception type, and the file holds
    the header and at most the rows of traces before the one at fault.
    The core formats ~500,000 rows at a time (``ROUND_ROWS``), so the text
    it holds stays bounded. ``n_threads``: formatting threads (None =
    ``stepchain.default_threads()``).
    """
    phot = np.ascontiguousarray(fits.phot, np.float64)
    N, T = phot.shape
    if include_intermediates is True:
        include_intermediates = list(INTERMEDIATES)
    names = ([] if include_intermediates is None
             else sorted(include_intermediates))
    if N:
        for name in names:
            if name not in INTERMEDIATES:
                raise KeyError(name)
    columns = np.array([INTERMEDIATES.get(name, 0) for name in names],
                       np.int32)
    h0 = np.ascontiguousarray(h0)
    w0 = np.ascontiguousarray(w0)
    if h0.shape != (N,) or w0.shape != (N,) or (
            N and not (np.issubdtype(h0.dtype, np.integer) and
                       np.issubdtype(w0.dtype, np.integer))):
        raise ValueError("h0 and w0 must be N integer start keys")
    h0 = h0.astype(np.int64, copy=False)
    w0 = w0.astype(np.int64, copy=False)
    ck = np.ascontiguousarray(fits.ck, np.float64)
    if ck.shape != (N, T):
        raise ValueError("the CK traces must be (N, T) like the "
                         "photometries")
    rf = _plateaus(fits.refit, N)
    tf = _plateaus(fits.t_filtered, N)
    header = _header(include_step_fits, names)
    if n_threads is None:
        n_threads = default_threads()
    fault = np.zeros(3, np.int64)
    lib = _lib()
    with open(path, "wb") as f:
        rows = lib.ttcsv_write(
            f.fileno(), header, len(header), N, T, h0, w0, phot, ck,
            *rf, rf[1].shape[1], *tf, tf[1].shape[1],
            int(bool(include_step_fits)), columns, len(columns), _NEUMAIER,
            int(n_threads), fault)
    if rows == -2:
        raise OSError(int(fault[0]), os.strerror(int(fault[0])), path)
    if rows < 0:
        _raise(int(fault[0]), int(fault[1]), int(fault[2]), rf, tf)
    return rows + 1


def format_doubles(values):
    """repr(float) of each value, by the core (testing hook)."""
    v = np.ascontiguousarray(values, np.float64).ravel()
    out = ctypes.create_string_buffer(24 * max(len(v), 1))
    ends = np.zeros(len(v), np.int64)
    _lib().ttcsv_format_doubles(v, len(v), out, ends)
    raw = out.raw
    starts = np.concatenate([[0], ends[:-1]]) if len(v) else ends
    return [raw[a:b].decode() for a, b in zip(starts.tolist(),
                                                ends.tolist())]


def r_squared(phot, t_filtered):
    """The R^2 and the mean of each row of ``phot`` against its
    t-filtered plateaus, by the core, and each row's fault code (0, or as
    :func:`write`'s; testing hook)."""
    phot = np.ascontiguousarray(phot, np.float64)
    N, T = phot.shape
    n, s, e, h = _plateaus(t_filtered, N)
    r2 = np.zeros(N)
    mean = np.zeros(N)
    codes = np.zeros(N, np.int64)
    _lib().ttcsv_r_squared(phot, N, T, n, s, e, h, s.shape[1], _NEUMAIER,
                           r2, mean, codes)
    return r2, mean, codes
