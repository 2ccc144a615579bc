"""ctypes binding of the native track-photometries CSV parser
(csrc/trackcsv.cpp).

Counterpart of fluorosequencingimageanalysis_tpu/native/trackcsv.py; the
C++ source is a byte-for-byte copy of that package's. Tokenizing and
number-parsing 10^4-10^5 rows dominates ingestion of
inference/photometries.py::read_track_photometries_csv (the port of
MCsimlib.py:2534-2575); the C++ pass returns flat arrays and the dict
assembly stays in Python. ``_build`` compiles the source with g++ at first
use; a failed build raises with the compiler's output (no Python fallback
for a missing core). A file the parser itself refuses (ragged frame
counts) returns None, and the caller reads it with the Python reader: that
is the reference's semantics for such files.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build


def _prototypes(lib):
    lib.tcsv_parse.restype = ctypes.c_void_p
    lib.tcsv_parse.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                               ctypes.c_int32, ctypes.c_int32,
                               ctypes.c_int32]
    lib.tcsv_n_rows.restype = ctypes.c_int64
    lib.tcsv_n_rows.argtypes = [ctypes.c_void_p]
    lib.tcsv_n_frames.restype = ctypes.c_int32
    lib.tcsv_n_frames.argtypes = [ctypes.c_void_p]
    lib.tcsv_channels.restype = ctypes.c_char_p
    lib.tcsv_channels.argtypes = [ctypes.c_void_p]
    for name, ct in (("tcsv_fields", ctypes.c_int32),
                     ("tcsv_hs", ctypes.c_int32),
                     ("tcsv_ws", ctypes.c_int32),
                     ("tcsv_rows", ctypes.c_int64),
                     ("tcsv_cats", ctypes.c_uint8),
                     ("tcsv_frames", ctypes.c_int64)):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ct)
        fn.argtypes = [ctypes.c_void_p]
    lib.tcsv_free.restype = None
    lib.tcsv_free.argtypes = [ctypes.c_void_p]


def _load():
    lib = _build.load("trackcsv")
    _prototypes(lib)
    return lib


def parse_track_csv_native(path, downstep_filtered=False, head_truncate=0,
                           tail_truncate=0, omit_header=True, channels=None):
    """Native-parse a track CSV into the reference (d, d2) dict pair.

    Returns None if the parser refuses the file (ragged frame counts): the
    caller then takes the Python reader.
    """
    lib = _load()
    handle = lib.tcsv_parse(os.fsencode(path), int(head_truncate),
                            int(tail_truncate), int(bool(downstep_filtered)),
                            int(bool(omit_header)))
    if not handle:
        return None
    try:
        n = int(lib.tcsv_n_rows(handle))
        nf = int(lib.tcsv_n_frames(handle))
        if n == 0:
            return {}, {}
        chan_names = lib.tcsv_channels(handle).decode("utf-8").split("\n")
        fields = np.ctypeslib.as_array(lib.tcsv_fields(handle), (n,)).copy()
        hs = np.ctypeslib.as_array(lib.tcsv_hs(handle), (n,)).copy()
        ws = np.ctypeslib.as_array(lib.tcsv_ws(handle), (n,)).copy()
        rows = np.ctypeslib.as_array(lib.tcsv_rows(handle), (n,)).copy()
        if nf == 0:
            # head_truncate ate every frame column: the data pointers of
            # the empty vectors are NULL (as_array would raise); the rows
            # themselves are valid with empty tuples, like the Python
            # reader's.
            cats = np.zeros((n, 0), bool)
            frames = np.zeros((n, 0), np.int64)
        else:
            cats = np.ctypeslib.as_array(lib.tcsv_cats(handle),
                                         (n, nf)).copy().astype(bool)
            frames = np.ctypeslib.as_array(lib.tcsv_frames(handle),
                                           (n, nf)).copy()
    finally:
        lib.tcsv_free(handle)

    # Bulk-convert once (C speed) instead of per-row numpy scalar iteration.
    fields_l = fields.tolist()
    hs_l = hs.tolist()
    ws_l = ws.tolist()
    rows_l = rows.tolist()
    cats_l = cats.tolist()
    frames_l = frames.tolist()
    d = {}
    d2 = {}
    for i in range(n):
        channel = chan_names[i]
        if channels is not None and channel not in channels:
            continue
        parsed_cat = tuple(cats_l[i])
        parsed_frames = tuple(frames_l[i])
        r = rows_l[i]
        d.setdefault(channel, {}).setdefault(fields_l[i], {}).setdefault(
            (hs_l[i], ws_l[i]), (parsed_cat, parsed_frames, r))
        d2.setdefault(r, (channel, fields_l[i], hs_l[i], ws_l[i],
                          parsed_cat, parsed_frames))
    return d, d2


def read_track_photometries_arrays(path, downstep_filtered=False,
                                   head_truncate=0, tail_truncate=0,
                                   omit_header=True):
    """Arrays-native ingestion: parse a track CSV straight to flat numpy
    arrays, skipping the photometries-dict entirely.

    The batched fitters (ops/lognormal.py score_traces,
    ops/stepfit_batch.py) consume (N, F) arrays directly, so
    for large experiments the per-row Python dict/tuple assembly of
    read_track_photometries_csv (MCsimlib.py:2534-2575) is pure overhead.

    Returns a dict with:
        channels: list[str] per row,
        fields, hs, ws: (N,) int32,
        rows: (N,) int64 original CSV record indices,
        categories: (N, F) bool,
        intensities: (N, F) int64.
    None if the parser refuses the file (callers take the dict reader).
    """
    lib = _load()
    handle = lib.tcsv_parse(os.fsencode(path), int(head_truncate),
                            int(tail_truncate), int(bool(downstep_filtered)),
                            int(bool(omit_header)))
    if not handle:
        return None
    try:
        n = int(lib.tcsv_n_rows(handle))
        nf = int(lib.tcsv_n_frames(handle))
        if n == 0:
            return {"channels": [], "fields": np.zeros(0, np.int32),
                    "hs": np.zeros(0, np.int32), "ws": np.zeros(0, np.int32),
                    "rows": np.zeros(0, np.int64),
                    "categories": np.zeros((0, 0), bool),
                    "intensities": np.zeros((0, 0), np.int64)}
        if nf == 0:
            # NULL data pointers on the empty vectors (see the dict
            # reader above) — build the empty matrices directly.
            cats = np.zeros((n, 0), bool)
            frames = np.zeros((n, 0), np.int64)
        else:
            cats = np.ctypeslib.as_array(
                lib.tcsv_cats(handle), (n, nf)).copy().astype(bool)
            frames = np.ctypeslib.as_array(lib.tcsv_frames(handle),
                                           (n, nf)).copy()
        return {
            "channels": lib.tcsv_channels(handle).decode("utf-8").split("\n"),
            "fields": np.ctypeslib.as_array(lib.tcsv_fields(handle),
                                            (n,)).copy(),
            "hs": np.ctypeslib.as_array(lib.tcsv_hs(handle), (n,)).copy(),
            "ws": np.ctypeslib.as_array(lib.tcsv_ws(handle), (n,)).copy(),
            "rows": np.ctypeslib.as_array(lib.tcsv_rows(handle), (n,)).copy(),
            "categories": cats,
            "intensities": frames,
        }
    finally:
        lib.tcsv_free(handle)
