"""ctypes binding of the native greedy linker (csrc/tracklink.cpp).

Counterpart of fluorosequencingimageanalysis_tpu/native/tracklink.py; the
C++ source is a byte-for-byte copy of that package's. The linking
semantics (the reference's Experiment.greedy_particle_tracking) live in
C++; this module only marshals arrays. ``_build`` compiles the source with
g++ at first use; a failed build raises with the compiler's output, and
there is no Python fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build


def _lib():
    lib = _build.load("tracklink")
    fn = lib.trk_greedy_link
    fn.restype = ctypes.c_int
    fn.argtypes = [
        np.ctypeslib.ndpointer(np.float64, flags="C"),  # h
        np.ctypeslib.ndpointer(np.float64, flags="C"),  # w
        np.ctypeslib.ndpointer(np.int32, flags="C"),    # frame_start
        ctypes.c_int32, ctypes.c_int32,                 # frames, spots
        ctypes.c_int32, ctypes.c_int32,                 # H, W
        ctypes.c_double,                                # radius
        np.ctypeslib.ndpointer(np.int32, flags="C"),    # out_ancestor
        np.ctypeslib.ndpointer(np.int32, flags="C"),    # out_descendant
        np.ctypeslib.ndpointer(np.int64, flags="C"),    # err_out
    ]
    return lib


def greedy_link(h, w, frame_start, frame_shape, candidate_radius):
    """Run the C++ linker on offset-adjusted positions.

    h, w: (n_spots,) float64, frame-major, already offset-adjusted and
    inside the frame. frame_start: (n_frames + 1,) int32 prefix offsets
    into h/w. Returns (ancestor, descendant): per-spot global links, -1 for
    none. Raises ValueError for a spot that rounds outside the frame and
    AssertionError for two spots of one frame in one bin (the reference's
    precondition).
    """
    lib = _lib()
    h = np.ascontiguousarray(h, dtype=np.float64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    frame_start = np.ascontiguousarray(frame_start, dtype=np.int32)
    n_spots = int(h.shape[0])
    n_frames = int(frame_start.shape[0]) - 1
    anc = np.empty(n_spots, dtype=np.int32)
    desc = np.empty(n_spots, dtype=np.int32)
    err = np.zeros(2, dtype=np.int64)
    rc = lib.trk_greedy_link(h, w, frame_start, n_frames, n_spots,
                             int(frame_shape[0]), int(frame_shape[1]),
                             float(candidate_radius), anc, desc, err)
    if rc == 2:
        s = int(err[1])
        raise ValueError(
            f"spot {s} at (h, w) = ({float(h[s])}, {float(w[s])}) rounds "
            f"outside the {tuple(int(v) for v in frame_shape)} frame: "
            "positions must be offset-adjusted and in range")
    if rc != 0:
        W = int(frame_shape[1])
        cell = int(err[1])
        raise AssertionError(
            str((cell // W, cell % W)) + " is already filled in frame_bins["
            + str(int(err[0])) + "]")
    return anc, desc
