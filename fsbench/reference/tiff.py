"""A plain reader of the sequencing run's image files, for the check of
the file cell.

Reads a classic little-endian TIFF's first page: one uncompressed sample
of unsigned 16 bits a pixel, grey (BlackIsZero), in one strip or in
several (``StripOffsets``, ``StripByteCounts``, ``RowsPerStrip``). Any
other file is refused with ``ValueError``. ``read_stack`` sorts a file
list as the upstream ``easy_sort_target_images`` does (flexlibrary.py:
1105-1154): the directories in order are the cycles, the file names in
order within each directory are the fields.

numpy, ``struct`` and ``os`` only: neither the port nor JAX.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_SHORT, _LONG = 3, 4
_SIZE = {_SHORT: 2, _LONG: 4}

# Tag: the one value it may hold, where it has one (absent: the TIFF
# default, which is that value).
_FIXED = {258: 16,     # BitsPerSample
          259: 1,      # Compression: none
          262: 1,      # PhotometricInterpretation: BlackIsZero
          266: 1,      # FillOrder
          277: 1,      # SamplesPerPixel
          284: 1,      # PlanarConfiguration
          317: 1,      # Predictor: none
          339: 1}      # SampleFormat: unsigned
_REQUIRED = (256, 257, 262, 273, 279)   # width, length, photometric, strips
_TILES = (322, 323, 324, 325)


def _ifd(data, path):
    """{tag: [values]} of the first IFD of ``data``."""
    if data[:4] != b"II*\x00":
        raise ValueError(f"{path}: not a classic little-endian TIFF")
    (at,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, at)
    tags = {}
    for i in range(n):
        tag, kind, count, value = struct.unpack_from(
            "<HHII", data, at + 2 + 12 * i)
        if kind not in _SIZE:
            raise ValueError(f"{path}: tag {tag} of TIFF type {kind}")
        size = _SIZE[kind] * count
        start = at + 2 + 12 * i + 8 if size <= 4 else value
        fmt = "<" + ("H" if kind == _SHORT else "I") * count
        tags[tag] = list(struct.unpack_from(fmt, data, start))
    return tags


def read(path):
    """The image of the TIFF at ``path``: a (height, width) uint16 array."""
    with open(path, "rb") as fh:
        data = fh.read()
    tags = _ifd(data, path)
    for tag in _REQUIRED:
        if tag not in tags:
            raise ValueError(f"{path}: no TIFF tag {tag}")
    for tag, want in _FIXED.items():
        if tags.get(tag, [want]) != [want]:
            raise ValueError(f"{path}: TIFF tag {tag} is {tags[tag]}, "
                             f"only {want} is read")
    if any(t in tags for t in _TILES):
        raise ValueError(f"{path}: a tiled TIFF")
    (width,), (height,) = tags[256], tags[257]
    offsets, counts = tags[273], tags[279]
    rows = min(tags.get(278, [height])[0], height)
    if len(offsets) != len(counts) or len(offsets) != -(-height // rows):
        raise ValueError(f"{path}: {len(offsets)} strip offsets and "
                         f"{len(counts)} byte counts for {height} rows of "
                         f"{rows} a strip")
    strips = []
    for i, (at, n) in enumerate(zip(offsets, counts)):
        want = (min(height, (i + 1) * rows) - i * rows) * width * 2
        if n != want or at + n > len(data):
            raise ValueError(f"{path}: strip {i} holds {n} bytes at {at}, "
                             f"{want} wanted in a file of {len(data)}")
        strips.append(data[at:at + n])
    pixels = np.frombuffer(b"".join(strips), dtype="<u2")
    return pixels.reshape(height, width).astype(np.uint16)


def sort_files(files):
    """[[path of field f in cycle c for f] for c]: the directories sorted
    (absolute paths), each one's file names sorted."""
    by_dir = {}
    for p in files:
        d, name = os.path.split(os.path.abspath(p))
        by_dir.setdefault(d, []).append(name)
    return [[os.path.join(d, name) for name in sorted(by_dir[d])]
            for d in sorted(by_dir)]


def read_stack(files):
    """The uint16 [fields, cycles, H, W] stack that ``files`` hold."""
    cycles = sort_files(files)
    if len({len(c) for c in cycles}) != 1:
        raise ValueError("every cycle directory must hold the same number "
                         "of field files")
    return np.stack([np.stack([read(cycle[f]) for cycle in cycles])
                     for f in range(len(cycles[0]))])
