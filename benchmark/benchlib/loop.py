"""The measured window.

``closed_loop``: items back to back, at most one dispatched ahead of the one
the card is running; the window runs from the first dispatch until the
last item dispatched before ``seconds`` had passed (and at least
``min_items``) is complete, so a rate is all the work over all the time.
``paced``: one client sending its calls at a fixed rate (every 1/rate s
from the window's start, or back to back at rate 0), each timed from when
it was due to its result, so a stall counts against the calls behind it.

With a tracer, the first ``trace_items`` items run inside the profiler's
``bench.window`` range (each call of ``paced`` in a ``bench.item`` range);
the rest of the window runs untraced."""

from __future__ import annotations

import time
from collections import deque


def closed_loop(torch, step, seconds: float, *, cuda: bool, tracer=None, trace_items=0,
                keep=None, min_items: int = 1) -> dict:
    pending = deque()

    def finish():
        j, ev, out = pending.popleft()
        if ev is not None:
            ev.synchronize()
        if keep is not None:
            keep(j, out)

    tracing = tracer is not None and trace_items > 0
    t0 = time.perf_counter()
    if tracing:
        tracer.open_window()
    i = 0
    while True:
        out = step(i)
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
        pending.append((i, ev, out))
        i += 1
        while len(pending) > 1:
            finish()
        done = time.perf_counter() - t0 >= seconds and i >= min_items
        if tracing and (i == trace_items or done):
            while pending:
                finish()
            tracer.close_window(i)
            tracing = False
        if done:
            break
    while pending:
        finish()
    return {"items": i, "window_s": time.perf_counter() - t0}


def paced(step, seconds: float, rate: float, *, sync=None, tracer=None, trace_items=0,
          keep=None, min_items: int = 1) -> dict:
    lat, late = [], []
    tracing = tracer is not None and trace_items > 0
    t0 = time.perf_counter()
    if tracing:
        tracer.open_window()
    i = 0
    while True:
        due = t0 + i / rate if rate else time.perf_counter()
        if rate and due - t0 >= seconds and i >= min_items:
            break
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late.append(max(0.0, time.perf_counter() - due))
        if tracing:
            with tracer.item():
                out = step(i)
        else:
            out = step(i)
        end = time.perf_counter()
        lat.append(end - due)
        if keep is not None:
            keep(i, out)
        i += 1
        done = not rate and end - t0 >= seconds and i >= min_items
        if tracing and (i == trace_items or done):
            if sync is not None:
                sync()
            tracer.close_window(i)
            tracing = False
        if done:
            break
    if tracing:
        tracer.close_window(i)
    return {"items": i, "window_s": time.perf_counter() - t0, "latency_s": lat,
            "late_s": late}
