"""Rows that a kernel reads in place from another shard, on any card.

Both row readers, ``halo_exchange_rows`` (:mod:`.halo`) and the halo staging
of ``conv3x3_reflect`` (:mod:`.conv`), take a neighbour shard's boundary rows
as a pointer and a batch stride. Rows on another card are read through its
peer pointer: :func:`reachable` orders the read after the rows' producer,
and :func:`release`, called after the launch, orders the producer's later
work (which may reuse the rows' memory) after the read. A caller that
launches one layer of shards, each reading its neighbours' rows, does it
inside :func:`one_step`, so that the layer's launches on different cards
do not wait for each other.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

__all__ = ["reachable", "release", "one_step", "ptr", "batch_stride"]

# the open one_step of this thread: its events by card, and the reads whose
# release waits for the step's end
_step = threading.local()


@functools.cache
def _peer_access(dev: int, peer: int) -> bool:
    """Whether a kernel on card ``dev`` may dereference pointers of card
    ``peer``; switches the access on the first time it is asked.

    PyTorch enables peer access in a CUDA context (and maps its allocator's
    segments for the peer) when it first copies between a pair, for the card
    the copy runs on. One element is copied each way, so that ``dev``'s
    context has the access whichever end PyTorch runs a copy on."""
    if not torch.cuda.can_device_access_peer(dev, peer):
        return False
    here, there = (torch.empty(1, device=f"cuda:{d}") for d in (dev, peer))
    there.copy_(here)
    here.copy_(there)
    return True


def reachable(t: torch.Tensor | None, dev: torch.device,
              stream: "torch.cuda.Stream") -> torch.Tensor | None:
    """``t`` as rows the kernel on ``dev``'s ``stream`` can read.

    Rows on ``dev`` are read in place. Rows on another card are read through
    the peer pointer where the cards have peer access: the consumer's stream
    waits for an event on the producer's current stream, and the rows'
    storage is held for the consumer's stream so that the allocator does not
    hand it out before the kernel has read it. Without peer access the rows
    are copied to ``dev`` first (``Tensor.to`` orders the copy after the
    producer's work); the kernel runs either way. Call :func:`release` with
    what this returns once the kernel is launched."""
    if t is None or t.device == dev:
        return t
    if not _peer_access(dev.index, t.device.index):
        return t.to(dev)
    ready = getattr(_step, "ready", {}).get(t.device)
    if ready is None:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(t.device))
    stream.wait_event(ready)
    t.record_stream(stream)
    return t


def release(t: torch.Tensor | None, dev: torch.device, stream: "torch.cuda.Stream") -> None:
    """After a launch on ``dev``'s ``stream`` that reads ``t`` in place on
    another card: the producer card's current stream waits for the launch.

    ``record_stream`` alone does not hold the rows' memory: the caching
    allocator ignores a use on a stream whose handle equals the block's own,
    and every card's default stream has the null handle, so a block of the
    producer's default stream freed while the consumer's default stream
    still reads it went back to the producer's next allocation (the per-conv
    cascade across four cards read rows overwritten under it). The producer
    reuses a block only on the stream it was allocated on, which this wait
    orders after the read. Inside :func:`one_step` the wait is queued when
    the step ends."""
    if t is None or t.device == dev:
        return
    reads = getattr(_step, "reads", None)
    if reads is not None:
        reads.append((t, stream))
        return
    done = torch.cuda.Event()
    done.record(stream)
    torch.cuda.current_stream(t.device).wait_event(done)


@contextlib.contextmanager
def one_step(devices):
    """The launches made inside, one layer of shards on ``devices``, ordered
    across cards as one step.

    On entry one event is recorded on every card's current stream. A read of
    another card's rows inside waits for that card's event: for the work
    queued there before the step, which made the rows, and not for the
    step's own launch on that card. Without it the k-th shard's launch would
    wait for the (k-1)-th's, which was queued just before it, and the cards'
    launches of one layer would run one after another. The releases are
    queued when the step ends, after every launch of the layer: each
    producer card then waits for the layer's reads of its rows. (Rows that
    :func:`reachable` copies, between cards without peer access, still wait
    for their card's launch.) On one card, or on the CPU, nothing is
    recorded."""
    cards = [d for d in dict.fromkeys(torch.device(d) for d in devices) if d.type == "cuda"]
    if len(cards) < 2 or hasattr(_step, "ready"):
        yield
        return
    _step.ready = {}
    for d in cards:
        _step.ready[d] = torch.cuda.Event()
        _step.ready[d].record(torch.cuda.current_stream(d))
    _step.reads = []
    try:
        yield
    finally:
        reads = _step.reads
        del _step.ready, _step.reads
        for t, stream in reads:
            release(t, stream.device, stream)


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def batch_stride(t: torch.Tensor | None) -> int:
    """Elements from one image's rows to the next (0 where there is none)."""
    return 0 if t is None or t.shape[0] == 1 else t.stride(0)
