"""ctypes binding of the native track-photometries CSV writer
(csrc/trackrows_csv.cpp).

``run_experiment`` writes its track CSV here
(``pipeline/fast_experiment.py::write_track_rows_csv``): the bytes that
the Python writer, csv.writer over ``str()`` of every cell, writes for the
same rows, with no Python object per cell. :func:`as_arrays` turns the
rows into the core's inputs, or returns None where a row is not of the
shapes the core writes byte for byte; :func:`write` formats blocks of
rows on several threads and writes them in order as each is done, and the
file is complete and closed when it returns. ``_build`` compiles the source
with g++ at first use; a failed build raises with the compiler's output.
"""

from __future__ import annotations

import csv
import ctypes
import io
import itertools
import operator
import os
from typing import NamedTuple

import numpy as np

from .. import _build
from .stepchain import default_threads

HEADER = ["CHANNEL", "FIELD", "H", "W", "CATEGORY"]

_I32 = np.ctypeslib.ndpointer(np.int32, flags="C")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
_C64 = ctypes.c_int64
_NONE = type(None)


class TrackRows(NamedTuple):
    """N rows as arrays: each row's channel and category as an index into
    a table of the distinct ``str()`` texts; H and W with a flag where
    they are None; the values (N, C), with a flag where one is None."""
    channel: np.ndarray        # (N,) int32
    channels: list             # str
    field: np.ndarray          # (N,) int64
    h: np.ndarray              # (N,) int64, 0 where None
    w: np.ndarray
    h_none: np.ndarray         # (N,) bool
    w_none: np.ndarray
    category: np.ndarray       # (N,) int32
    categories: list           # str
    values: np.ndarray         # (N, C) float64, 0 where None
    none: np.ndarray           # (N, C) bool


def _lib():
    lib = _build.load("trackrows_csv")
    fn = lib.trcsv_write
    fn.restype = _C64
    fn.argtypes = [
        ctypes.c_int32, _C64, _C64,          # fd, N, C
        _I32, ctypes.c_char_p, _I64, _C64,   # channel, its table
        _I64, _I64, _I64, _U8, _U8,          # field, h, w, h/w None
        _I32, ctypes.c_char_p, _I64, _C64,   # category, its table
        _F64, _U8,                           # values, None
        ctypes.c_int32, _I64,                # threads, errno
    ]
    return lib


def _table(objs):
    """Each object's index into a table of distinct texts, the ``str()``
    of each distinct object. Objects are told apart by identity, so each
    text is the str() of the very object the row holds (run_experiment's
    rows share one tuple a category and field); the table then holds each
    text once."""
    if all(map(operator.is_, objs, itertools.repeat(objs[0]))):
        return np.zeros(len(objs), np.int32), [str(objs[0])]
    ids = np.fromiter(map(id, objs), np.uint64, len(objs))
    _, first, index = np.unique(ids, return_index=True, return_inverse=True)
    slot = {}
    text_of = np.fromiter(
        (slot.setdefault(str(objs[i]), len(slot)) for i in first.tolist()),
        np.int32, len(first))
    return text_of[index.reshape(-1)], list(slot)


def _ints_or_none(col):
    """(int64 values, None flags) of a column of ints and Nones, or None
    where it holds anything else."""
    kinds = set(map(type, col))
    if not kinds <= {int, _NONE}:
        return None
    n = len(col)
    try:
        if _NONE not in kinds:
            return np.fromiter(col, np.int64, n), np.zeros(n, bool)
        return (np.fromiter((0 if v is None else v for v in col), np.int64,
                            n),
                np.fromiter(map(operator.is_, col, itertools.repeat(None)),
                            bool, n))
    except OverflowError:   # beyond int64: the Python writer's
        return None


def _values(col, save_averages):
    """(float64 (N, C), None flags) of the rows' values, or None where a
    row is not a float64 vector or a tuple of floats and Nones (a mean
    with ``save_averages``)."""
    n = len(col)
    kinds = set(map(type, col))
    if save_averages:
        if not kinds <= {float, np.float64}:
            return None
        return (np.fromiter(col, np.float64, n).reshape(n, 1),
                np.zeros((n, 1), bool))
    if kinds == {np.ndarray}:
        widths = set(map(len, col))
        if len(widths) != 1:
            return None
        C = widths.pop()
        try:   # refuses any dtype but float64, and 0-d arrays
            values = np.concatenate(col, dtype=np.float64, casting="no")
        except (TypeError, ValueError):
            return None
        if values.shape != (n * C,):   # rows of more than one dimension
            return None
        return values.reshape(n, C), np.zeros((n, C), bool)
    if kinds != {tuple}:
        return None
    widths = set(map(len, col))
    if len(widths) != 1:
        return None
    C = widths.pop()
    flat = list(itertools.chain.from_iterable(col))
    cells = set(map(type, flat))
    if not cells <= {float, np.float64, _NONE}:
        return None
    if _NONE not in cells:
        return (np.fromiter(flat, np.float64, n * C).reshape(n, C),
                np.zeros((n, C), bool))
    values = np.fromiter((0.0 if v is None else v for v in flat),
                         np.float64, n * C)
    none = np.fromiter(map(operator.is_, flat, itertools.repeat(None)),
                       bool, n * C)
    return values.reshape(n, C), none.reshape(n, C)


def as_arrays(rows, save_averages=False):
    """The rows (channel, field, h, w, category, values) as a
    :class:`TrackRows`, or None where a row is not of the shapes the core
    writes as the Python writer does: every field an int, every h and w an
    int or None, and every row's values a 1-D float64 ndarray, or every
    row's a tuple of floats (Python's or numpy's float64) and Nones, all of
    one length; with ``save_averages`` every value one float."""
    n = len(rows)
    if n == 0:
        empty = np.zeros(0, np.int64)
        return TrackRows(np.zeros(0, np.int32), [], empty, empty, empty,
                         np.zeros(0, bool), np.zeros(0, bool),
                         np.zeros(0, np.int32), [], np.zeros((0, 1)),
                         np.zeros((0, 1), bool))
    if set(map(len, rows)) != {6}:
        return None
    channel, field, h, w, category, values = zip(*rows)
    if set(map(type, field)) != {int}:
        return None
    try:
        field = np.fromiter(field, np.int64, n)
    except OverflowError:
        return None
    h, w = _ints_or_none(h), _ints_or_none(w)
    values = _values(values, save_averages)
    if h is None or w is None or values is None:
        return None
    channel, channels = _table(channel)
    category, categories = _table(category)
    return TrackRows(channel, channels, field, h[0], w[0], h[1], w[1],
                     category, categories, *values)


def _quoted(texts, encoding):
    """The texts as csv.writer quotes a cell (a cell of a row of two, so
    that an empty text is written as in a longer row), encoded end to end,
    and their offsets."""
    buf = io.StringIO(newline="")
    writer = csv.writer(buf, dialect="excel")
    parts = []
    for t in texts:
        buf.seek(0)
        buf.truncate()
        writer.writerow([t, ""])
        parts.append(buf.getvalue()[:-3].encode(encoding))   # less ",\r\n"
    off = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=off[1:])
    return b"".join(parts), off


def write(path, header, rows, n_threads=None):
    """Write ``header`` and the :class:`TrackRows` ``rows`` to ``path`` as
    csv.writer writes them to a file opened with ``open(path, "w",
    newline="")``. Returns the rows written, the header apart.
    ``n_threads``: formatting threads (None = ``stepchain.
    default_threads()``; the core formats blocks of 2,048 rows, so a
    smaller file takes one)."""
    N = len(rows.field)
    C = rows.values.shape[1]
    arrays = {
        "channel": (rows.channel, np.int32, (N,)),
        "field": (rows.field, np.int64, (N,)),
        "h": (rows.h, np.int64, (N,)), "w": (rows.w, np.int64, (N,)),
        "h_none": (rows.h_none, np.uint8, (N,)),
        "w_none": (rows.w_none, np.uint8, (N,)),
        "category": (rows.category, np.int32, (N,)),
        "values": (rows.values, np.float64, (N, C)),
        "none": (rows.none, np.uint8, (N, C))}
    a = {}
    for name, (arr, dtype, shape) in arrays.items():
        a[name] = np.ascontiguousarray(arr).astype(dtype, copy=False)
        if a[name].shape != shape:
            raise ValueError(f"{name} must be {shape}, one entry a row")
    for name, table in (("channel", rows.channels),
                        ("category", rows.categories)):
        if N and not 0 <= int(a[name].min()) <= int(a[name].max()) < len(
                table):
            raise ValueError(f"{name} indices must lie in its table")
    if n_threads is None:
        n_threads = default_threads()
    err = np.zeros(1, np.int64)
    lib = _lib()
    with open(path, "w", newline="") as fh:
        csv.writer(fh, dialect="excel").writerow(header)
        fh.flush()
        channel_text, channel_off = _quoted(rows.channels, fh.encoding)
        category_text, category_off = _quoted(rows.categories, fh.encoding)
        n = lib.trcsv_write(
            fh.fileno(), N, C, a["channel"], channel_text, channel_off,
            len(rows.channels), a["field"], a["h"], a["w"], a["h_none"],
            a["w_none"], a["category"], category_text, category_off,
            len(rows.categories), a["values"], a["none"], int(n_threads),
            err)
    if n < 0:
        raise OSError(int(err[0]), os.strerror(int(err[0])), path)
    return n
