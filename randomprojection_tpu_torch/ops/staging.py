"""Copies between the host and the card, and the tile pipeline they feed.

The backend's, CountSketch's and the tier staging's uploads go through
``stage_upload``: the rows are copied into a pinned staging block (a
pinned tensor goes up as it is), and the copy is queued ``non_blocking``
on the card's copy stream
(``copy_stream``, one per card and process) with an event recorded behind
it.  It never queues behind kernels on the caller's stream, so a copy
issued from a producer thread, or for the next batch of a serial stream,
runs under the kernels of the batch before it.

The result is a ``StagedBatch``: the device tensor and that event.  Its
``wait`` hands the tensor to the current stream: the stream waits for the
event, and the tensor's use there is recorded with the caching allocator,
which otherwise would hand the block (allocated on the copy stream) to the
next upload while a kernel on the consumer's stream still reads it.  An
upload that is read at once is ``stage_upload(t, device).wait()``.

The way back is ``HostFetch``: a card output's copy into pinned host
memory, queued right behind its kernel with an event after it, read when
the host needs it.  ``tile_pipeline`` runs a serving call's query tiles
through both halves: each tile is dispatched (its kernels launched and its
results' fetches started) and finished (its fetches read and merged) a
fixed number of tiles later, so the host's finish of one tile rides under
the kernels of the tiles behind it.
"""

from __future__ import annotations

import collections
import sys

import numpy as np
import scipy.sparse as sp

__all__ = ["HostFetch", "StagedBatch", "copy_stream", "stage_upload",
           "tile_pipeline"]

_COPY_STREAMS: dict = {}


def copy_stream(device):
    """The host→device copy stream of ``device``: one per card and process,
    so staged copies queue behind each other, never behind kernels on the
    consumer's stream."""
    import torch

    device = torch.device(device)
    s = _COPY_STREAMS.get(device)
    if s is None:
        s = _COPY_STREAMS.setdefault(device, torch.cuda.Stream(device=device))
    return s


class StagedBatch:
    """A batch uploaded on the copy stream: the device ``tensor`` and the
    ``event`` recorded after its copy.  ``shape``/``nbytes`` mirror the
    tensor, so the stream's bookkeeping reads it as a batch.  ``wait``
    hands the tensor to the current stream: that stream waits for the
    event, and the tensor's use there is recorded with the allocator."""

    __slots__ = ("tensor", "event", "shape", "nbytes")

    def __init__(self, tensor, event):
        self.tensor = tensor
        self.event = event
        self.shape = tuple(tensor.shape)
        self.nbytes = tensor.nbytes

    def wait(self):
        import torch

        cur = torch.cuda.current_stream(self.tensor.device)
        cur.wait_event(self.event)
        self.tensor.record_stream(cur)
        return self.tensor


def stage_upload(t, device) -> StagedBatch:
    """Start the copy of CPU tensor ``t`` to the card ``device`` on its copy
    stream, from any thread.  A pinned tensor goes up as it is (the caller
    keeps it unchanged until the copy has run); any other goes through a
    pinned staging block, sized to the row bucket so torch's host cache
    reuses it, which that cache takes back only after the copy queued on
    it has run."""
    import torch

    from randomprojection_tpu_torch.parallel.sharded import row_bucket

    with torch.cuda.device(device):
        if t.is_pinned():
            src = t
        else:
            n = t.shape[0]
            src = torch.empty(
                (row_bucket(n) if n else 0,) + tuple(t.shape[1:]),
                dtype=t.dtype, pin_memory=True,
            )[:n]
            src.copy_(t)
        stream = copy_stream(device)
        with torch.cuda.stream(stream):
            x = src.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
    return StagedBatch(x, done)


class HostFetch:
    """A batch output on its way to the host.

    A card tensor's copy into pinned host memory is queued right behind
    its kernel on the current stream, with an event after it; ``result``
    waits for that event alone, then copies into pageable memory so the
    pinned block goes back to torch's allocator.  Host outputs (numpy
    arrays, CSR, CPU tensors) pass through.
    """

    __slots__ = ("_y", "_done")

    def __init__(self, y):
        self._done = None
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(y, torch.Tensor) and y.is_cuda:
            host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            host.copy_(y, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
            y = host
        self._y = y

    def result(self, out_dtype):
        y = self._y
        if self._done is not None:
            self._done.synchronize()
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(y, torch.Tensor):
            if y.dtype == torch.bfloat16:
                y = y.float()
            y = np.array(y.numpy(), dtype=out_dtype, copy=True)
        elif not sp.issparse(y):
            y = np.asarray(y)
            if out_dtype is not None:
                y = y.astype(out_dtype, copy=False)
        return y


def tile_pipeline(n: int, tile: int, dispatch, finish, *,
                  behind: int = 1) -> None:
    """Run ``dispatch(lo, hi)`` on each tile ``[lo, hi)`` of ``n`` rows in
    order, and ``finish(lo, hi, payload)`` on what it returned once
    ``behind`` more tiles are dispatched; then finish the tiles still in
    flight, in order.  An exception from either propagates at once, and
    the tiles in flight are dropped unfinished."""
    pending = collections.deque()
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        pending.append((lo, hi, dispatch(lo, hi)))
        if len(pending) > behind:
            finish(*pending.popleft())
    while pending:
        finish(*pending.popleft())
