"""A sequencing run's stack as the microscope's image files: one directory
a cycle, one file a field (``cycle_NN/field_NNN.tif``), each an
uncompressed classic little-endian TIFF of one 512x512 uint16 page in one
strip.

The stack is ``experiment_stack``'s for the same parameters, seed and
index. Its files are written during set-up, with a writer of this module
(``struct``, no code of the port), into a new temporary directory outside
the checkout (``tempfile.mkdtemp``, under ``TMPDIR``), which is removed
when the input is dropped or the process ends.
"""

from __future__ import annotations

import os
import shutil
import struct
import tempfile
import weakref

import numpy as np

from .experiment_stack import generate as generate_stack


class FileSet:
    """An input of the file cell: ``stack`` (uint16 [F, C, H, W]) and
    ``files``, the paths that hold it, sorted by cycle directory, then by
    field. ``root``, the directory of the files, is removed when the set
    is dropped or the process ends."""

    def __init__(self, stack, files, root):
        self.stack, self.files, self.root = stack, files, root
        weakref.finalize(self, shutil.rmtree, root, True)


def write_tiff(path, image, rows_per_strip=None):
    """``image`` ((H, W) uint16) as a classic little-endian TIFF of one
    uncompressed page, in strips of ``rows_per_strip`` rows (default:
    one strip)."""
    H, W = image.shape
    rows = H if rows_per_strip is None else rows_per_strip
    n = -(-H // rows)
    counts = [(min(H, (i + 1) * rows) - i * rows) * W * 2 for i in range(n)]
    # The header, the IFD, the strips' two arrays where they do not fit in
    # an entry, then the pixels.
    entries = 11    # the tags below
    ifd_at = 8
    extra_at = ifd_at + 2 + 12 * entries + 4
    arrays = n * 4 * 2 if n > 1 else 0
    pixels_at = extra_at + arrays
    offsets = [pixels_at + sum(counts[:i]) for i in range(n)]

    def strip_entry(tag, values):
        if n == 1:
            return struct.pack("<HHII", tag, 4, 1, values[0])
        at = extra_at + (0 if tag == 273 else n * 4)
        return struct.pack("<HHII", tag, 4, n, at)

    ifd = [struct.pack("<HHII", 256, 4, 1, W),
           struct.pack("<HHII", 257, 4, 1, H),
           struct.pack("<HHIHH", 258, 3, 1, 16, 0),
           struct.pack("<HHIHH", 259, 3, 1, 1, 0),
           struct.pack("<HHIHH", 262, 3, 1, 1, 0),
           strip_entry(273, offsets),
           struct.pack("<HHIHH", 277, 3, 1, 1, 0),
           struct.pack("<HHII", 278, 4, 1, rows),
           strip_entry(279, counts),
           struct.pack("<HHIHH", 284, 3, 1, 1, 0),
           struct.pack("<HHIHH", 339, 3, 1, 1, 0)]
    head = (b"II*\x00" + struct.pack("<I", ifd_at) +
            struct.pack("<H", entries) + b"".join(ifd) + struct.pack("<I", 0))
    if n > 1:
        head += struct.pack(f"<{n}I", *offsets) + struct.pack(f"<{n}I",
                                                              *counts)
    with open(path, "wb") as fh:
        fh.write(head)
        fh.write(np.ascontiguousarray(image, dtype="<u2").tobytes())


def write_files(stack, root, rows_per_strip=None):
    """Each image of ``stack`` (uint16 [F, C, H, W]) as
    ``root/cycle_CC/field_FFF.tif``; returns the paths, sorted by cycle,
    then by field."""
    F, C = stack.shape[:2]
    files = []
    for c in range(C):
        d = os.path.join(root, f"cycle_{c:02d}")
        os.makedirs(d, exist_ok=True)
        for f in range(F):
            files.append(os.path.join(d, f"field_{f:03d}.tif"))
            write_tiff(files[-1], stack[f, c], rows_per_strip)
    return files


def generate(params, config, seed, index, device, return_truth=False):
    out = generate_stack(params, config, seed, index, device,
                         return_truth=return_truth)
    stack, truth = out if return_truth else (out, None)
    root = tempfile.mkdtemp(prefix="fsbench_files_")
    try:
        files = write_files(stack, root)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    inputs = FileSet(stack, files, root)
    return (inputs, truth) if return_truth else inputs
