"""Host <-> device copies through pinned memory, on side streams.

:func:`push` uploads a host array: on the card its bytes cross the link in
chunks through two reused pinned staging buffers on a side stream, the host
filling one buffer while the other is copied, and the caller's stream waits
for the copies with an event. :func:`fetch_async` queues the copy of a CUDA
tensor into a pinned host tensor on a side stream, behind the work already
queued, so the card goes on computing while the bytes cross the link;
:func:`fetch` waits for it. On the CPU both are plain tensor <-> numpy views.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["push", "fetch", "fetch_async", "PUSH_CHUNK_BYTES"]

# push's staging chunk, from chip_smoke.py phase 6(c) on an H100 (PCIe), two
# runs: a 126 MB uint8 UHD image crossed in 8.2-12.8 ms at 16 MiB, 8.5-11.3
# ms at 64 MiB, 13.4-46.5 ms at 4 MiB, and 21.9-34.3 ms through a pageable
# .to(); 16 and 64 MiB are level, and 16 MiB holds less pinned memory
PUSH_CHUNK_BYTES = 16 << 20


def push(arr: np.ndarray, device, *, stream: torch.cuda.Stream | None = None,
         chunk_bytes: int = PUSH_CHUNK_BYTES) -> torch.Tensor:
    """Host array -> tensor on ``device``.

    On the CPU this is ``torch.as_tensor`` (a view of the array). On the
    card the array's bytes are copied in chunks of ``chunk_bytes`` through
    two pinned staging buffers on a side stream: the host fills one buffer
    while the other crosses the link, and waits for a buffer's last copy
    before filling it again. ``stream`` (default: the current stream of
    ``device``) is made to wait for the copies by an event, and the result
    is recorded as used on it, so it may be read there at once and freed
    there safely."""
    x = torch.as_tensor(np.ascontiguousarray(arr))
    device = torch.device(device)
    if device.type != "cuda":
        return x.to(device)
    stream = stream or torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)   # from PyTorch's stream pool
    flat = x.reshape(-1)
    n = flat.numel()
    step = max(1, chunk_bytes // x.element_size())
    staging = [torch.empty(min(step, n), dtype=x.dtype, pin_memory=True)
               for _ in range(min(2, -(-n // step)))]
    copied = [None] * len(staging)
    with torch.cuda.stream(side):
        out = torch.empty(n, dtype=x.dtype, device=device)
        for i, a in enumerate(range(0, n, step)):
            b = min(a + step, n)
            j = i % len(staging)
            if copied[j] is not None:
                copied[j].synchronize()   # its copy from two chunks ago is done
            staging[j][:b - a].copy_(flat[a:b])
            out[a:b].copy_(staging[j][:b - a], non_blocking=True)
            copied[j] = torch.cuda.Event()
            copied[j].record(side)
    stream.wait_stream(side)
    out.record_stream(stream)
    return out.view(x.shape)


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


def fetch(x: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy array on the host. A CUDA tensor is copied on a side
    stream, behind the work queued on the current stream, into pinned memory
    that the returned array keeps; a CPU tensor is returned as a view."""
    if x.device.type != "cuda":
        return x.numpy()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    fetch_async(x.contiguous(), out, torch.cuda.Stream(x.device)).synchronize()
    return out.numpy()
