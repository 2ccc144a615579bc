"""The sequencing run's file front door: image files sorted by the
directory = cycle, file name = field convention (flexlibrary.py:1105-1154)
and read into the [F, C, H, W] stack that ``Pipeline.run_experiment``
takes (``Pipeline.run_experiment_files``, the ``run-experiment``
subcommand).

Each decoded image is copied into its slot of one [F, C, H, W] buffer and
dropped before the next file is read, so the next decode reuses its pages.
Bound for a CUDA device, the buffer is pinned host memory from torch's
caching host allocator (reused from call to call once freed), which the
upload then reads as it is. Files whose arrays differ in shape or dtype
are stacked as they always were: each field's cycles, then the fields, so
that numpy promotes mixed dtypes and refuses mixed shapes.

While tracing is on (``utils.profiling``), host spans ``api/files/sort``,
``api/files/read`` (a decode) and ``api/files/assemble`` (its copy into
the buffer, or the stacking) time the three steps, and counters
``files/read``, ``files/bytes`` and ``files/pinned_bytes`` count the files
decoded, the bytes of the stack and the bytes of it decoded straight into
pinned memory.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import NATIVE_STACK_DTYPES
from ..utils import imageio, profiling


class FileLayoutError(ValueError):
    """Files that do not make one stack: cycle directories that hold
    different numbers of field files, or channels of different cycle
    counts."""


def load_stack(files, device=None):
    """files -> ([F, C, H, W] stack, cycle count): one
    ``read_image_array`` a file, each copied into its slot of the stack.
    With a CUDA ``device`` the stack is a pinned host tensor wherever
    ``run_experiment`` keeps the files' dtype as it is; otherwise a numpy
    array."""
    from .experiment import Experiment

    with profiling.span("api/files/sort"):
        frame_indexed, field_indexed = \
            Experiment.easy_sort_target_images(files)
    n_fields = {len(v) for v in frame_indexed.values()}
    if len(n_fields) != 1:
        raise FileLayoutError(
            "every cycle directory must hold the same number of field "
            f"files (got counts {sorted(n_fields)})")
    paths = [field_indexed[f] for f in sorted(field_indexed)]
    pin = device is not None and torch.device(device).type == "cuda"
    stack = _read_into_buffer(paths, pin) \
        if len({len(p) for p in paths}) == 1 else _stack_as_read(paths)
    if profiling.enabled():
        profiling.bump("files/read", stack.shape[0] * stack.shape[1])
        profiling.bump("files/bytes", stack.nbytes)
        profiling.bump("files/pinned_bytes",
                       stack.nbytes if isinstance(stack, torch.Tensor)
                       else 0)
    return stack, stack.shape[1]


def _read_into_buffer(paths, pin):
    """Every file of ``paths`` (a field's cycles a list, all of one
    length) into its slot of one buffer, allocated at the first file for
    its shape and dtype; pinned where ``pin`` and the dtype is one that
    ``run_experiment`` keeps. At the first array of another shape or dtype
    the files go to ``_stack_as_read``, with the arrays read so far."""
    n_cycles = len(paths[0])
    buf = host = None
    for f, field_paths in enumerate(paths):
        for c, path in enumerate(field_paths):
            with profiling.span("api/files/read"):
                arr = imageio.read_image_array(path)
            if host is None:
                # The dtype np.stack gives these arrays.
                dtype = arr.dtype.newbyteorder("=")
                shape = (len(paths), n_cycles) + arr.shape
                if pin and dtype.name in NATIVE_STACK_DTYPES:
                    buf = torch.empty(
                        shape, pin_memory=True,
                        dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
                    host = buf.numpy()
                else:
                    buf = host = np.empty(shape, dtype)
                first = arr.dtype
            if arr.shape != host.shape[2:] or arr.dtype != first:
                done = [host[i // n_cycles, i % n_cycles]
                        for i in range(f * n_cycles + c)]
                return _stack_as_read(paths, done + [arr])
            with profiling.span("api/files/assemble"):
                host[f, c] = arr
            del arr
    return buf


def _stack_as_read(paths, decoded=()):
    """The stack of ``paths`` as each field's cycles stacked, then the
    fields (numpy promotes mixed dtypes and raises for mixed shapes);
    ``decoded`` holds the arrays of the first files, already read."""
    decoded = list(decoded)
    fields = []
    for field_paths in paths:
        with profiling.span("api/files/read"):
            cycles = [decoded.pop(0) if decoded
                      else imageio.read_image_array(p)
                      for p in field_paths]
        with profiling.span("api/files/assemble"):
            fields.append(np.stack(cycles))
        # Freed before the next field's reads, which then reuse its pages.
        del cycles
    with profiling.span("api/files/assemble"):
        return np.stack(fields)
