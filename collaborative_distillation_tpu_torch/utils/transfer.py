"""Device-to-host copies into pinned memory.

:func:`fetch_async` queues the copy of a CUDA tensor into a page-locked host
tensor on a side stream, behind the work already queued on the current
stream, so the current stream goes on computing while the bytes cross the
link.
"""

from __future__ import annotations

import torch

__all__ = ["fetch_async"]


def fetch_async(x: torch.Tensor, out: torch.Tensor,
                stream: torch.cuda.Stream) -> torch.cuda.Event:
    """Queue the copy of the CUDA tensor ``x`` into the pinned host tensor
    ``out`` on ``stream``; ``out`` is valid after the returned event's
    ``synchronize()``. ``x``'s memory is kept from reuse until the copy is
    done."""
    stream.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(stream):
        out.copy_(x, non_blocking=True)
        x.record_stream(stream)
        done = torch.cuda.Event()
        done.record(stream)
    return done
