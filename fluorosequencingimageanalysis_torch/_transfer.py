"""Copies between the host and a device: staging, streams, events and
the ledger counters that record them.

``Uploader`` takes the front doors' host rows up to their devices, in
pieces; ``fetch`` starts the copies of results back into pinned host
memory without waiting, and ``wait`` ends them. The counters:
``ledger/uploads`` and ``ledger/upload_bytes`` are bumped by the uploader
at each piece it copies; ``count_fetched`` bumps ``ledger/result_fetches``
and ``ledger/fetch_bytes`` where a caller counts what it fetched. Two
small uploads stay on the current stream, where this layer's side stream
measured slower: the step fitter's pieces and the hole gathers' indices.

On the CPU nothing is staged: pieces are slices, and fetched arrays are
views of the tensors themselves.
"""

from __future__ import annotations

import torch

from .utils import profiling


class Uploader:
    """Pieces ``(lo, hi, device)`` of a host tensor's first axis, each on
    its device.

    A piece bound for a CUDA device uploads from one pinned copy of the
    host tensor (made at the first such piece, in the host-clock span
    ``api/upload/pin``) on a side copy stream of its device, behind an
    event that ``take`` makes that device's current stream wait on. A
    piece of a tensor that already lies on the piece's device is sliced,
    not copied, unless ``from_host`` (the caller's rows came from the host,
    so every piece counts as an upload); a tensor on another device is
    copied across."""

    def __init__(self, stack, pieces, from_host=False):
        self.stack, self.pieces, self.from_host = stack, pieces, from_host
        self.parts = [None] * len(pieces)
        self.events = [None] * len(pieces)
        self.host = None
        self.streams = {}

    def upload(self, i):
        """Enqueue piece i's upload (once)."""
        if self.parts[i] is not None:
            return
        lo, hi, dev = self.pieces[i]
        if not self.from_host and self.stack.device == dev:
            self.parts[i] = self.stack[lo:hi]
            return
        if dev.type == "cuda" and self.stack.device.type == "cpu":
            if self.host is None:
                with profiling.span("api/upload/pin"):
                    self.host = (self.stack if self.stack.is_pinned()
                                 else self.stack.pin_memory())
            part = self.host[lo:hi]
            if dev not in self.streams:
                self.streams[dev] = torch.cuda.Stream(dev)
            stream = self.streams[dev]
            buf = torch.empty(part.shape, dtype=part.dtype, device=dev)
            # The buffer may reuse memory the main stream still reads.
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                buf.copy_(part, non_blocking=True)
                self.events[i] = torch.cuda.Event()
                self.events[i].record(stream)
            buf.record_stream(stream)
            self.parts[i] = buf
        else:
            part = self.stack[lo:hi]
            self.parts[i] = part.to(dev)
        profiling.bump("ledger/uploads")
        profiling.bump("ledger/upload_bytes",
                       part.numel() * part.element_size())

    def take(self, i):
        """Piece i on its device, once that device's current stream has
        been told to wait for its upload; the uploader drops its
        reference."""
        self.upload(i)
        if self.events[i] is not None:
            torch.cuda.current_stream(self.pieces[i][2]).wait_event(
                self.events[i])
        part, self.parts[i] = self.parts[i], None
        return part


def fetch(tensors):
    """Start the device->host copies of ``tensors`` (all on one device)
    into pinned memory; returns the pending ``(numpy arrays, event or
    None)`` that ``wait`` ends: the arrays hold the values only once it
    has. On the CPU nothing is copied. The event is recorded on the
    current stream of the tensors' device, where the copies run."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors], None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h.numpy())
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[0].device))
    return host, event


def wait(pending):
    """The numpy arrays of a ``fetch``, once its copies have landed."""
    arrays, event = pending
    if event is not None:
        event.synchronize()
    return arrays


def count_fetched(arrays):
    """Count fetched result arrays in ``ledger/result_fetches`` and their
    bytes in ``ledger/fetch_bytes``."""
    profiling.bump("ledger/result_fetches", len(arrays))
    profiling.bump("ledger/fetch_bytes",
                   sum(int(a.nbytes) for a in arrays))
