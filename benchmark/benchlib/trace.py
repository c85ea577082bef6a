"""The profiler over the traced part of the window, and its reduction.

``torch.profiler`` (CUPTI on the card) records host ops and device
activity; the benchmark's own ranges mark the traced window
(``bench.window``) and, on paced cells, each call (``bench.item``). The
reduction keeps numbers, never the trace: the device's busy time (the union
of its kernels, copies and sets) within the window, device time by kernel
name, device time launched under the autograd engine's ``evaluate_function``
nodes, the device time and count of each of the program's spans (host
ranges named ``cd.*``), each call's wall and busy time, and the window's
idle gaps by what the host was doing.

A range the host opens has a card-side shadow in the trace (``CUDA``
device type, ``is_user_annotation``), which covers no work of its own: the
window, the calls and the spans are the host's ranges, never their
shadows."""

from __future__ import annotations

import bisect
import re
from collections import Counter

WINDOW = "bench.window"
ITEM = "bench.item"
SPAN = "cd."
# a CUDA runtime or driver call on the host (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...): it carries the correlation id of the device event it starts
_LAUNCH = re.compile(r"cu(da)?[A-Z]")


class Tracer:
    def __init__(self, torch, cuda: bool):
        from torch.profiler import ProfilerActivity, profile, record_function
        self._record = record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._win = None
        self.items = 0

    def open_window(self):
        self._win = self._record(WINDOW)
        self._win.__enter__()

    def item(self):
        return self._record(ITEM)

    def close_window(self, items: int):
        if self._win is None:
            return
        self._win.__exit__(None, None, None)
        self._win = None
        self.items = items
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict | None:
        return reduce(self.prof.events(), self.items)


def _on_card(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _is_device(e) -> bool:
    """A kernel, copy or set on the card; not the device-side shadow of a
    host range (``record_function``), which covers no work of its own."""
    return (_on_card(e) and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench."))


def _spans(host, dev, w0, w1) -> tuple[dict, dict]:
    """Device seconds and count of each program span (a host range named
    ``cd.*``) that opens inside the window. A span's device time is that of
    the kernels, copies and sets launched inside it, nested spans and host
    ops included: the device events whose correlation ids are those of the
    launches among the span's descendants, each counted once. Not
    ``device_time_total`` and not an op's ``kernels``: the profiler's buffer
    events inside an op that waits for the card carry kernels again, and
    host ops number their ids apart from the launches, so an op's id can
    be a foreign launch's."""
    dur = {}
    for e in dev:
        dur[e.id] = dur.get(e.id, 0.0) + e.time_range.end - e.time_range.start
    calls, launches = Counter(), {}
    for e in host:
        if not (e.name.startswith(SPAN) and w0 <= e.time_range.start <= w1):
            continue
        calls[e.name] += 1
        ids, stack = launches.setdefault(e.name, set()), [e]
        while stack:
            x = stack.pop()
            stack.extend(x.cpu_children)
            if _LAUNCH.match(x.name):
                ids.add(x.id)
    seconds = {name: sum(dur.get(i, 0.0) for i in ids) / 1e6 for name, ids in launches.items()}
    return seconds, dict(calls)


def _merge(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _busy_within(merged, starts, a, b) -> float:
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    t = 0.0
    while i < len(merged) and merged[i][0] < b:
        t += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return t


def reduce(events, items: int) -> dict | None:
    """Times in seconds; None where the window range is missing."""
    cpu, dev = [], []
    for e in events:
        if _is_device(e):
            dev.append(e)
        elif not _on_card(e):
            cpu.append(e)
    wins = [e for e in cpu if e.name == WINDOW]
    if not wins:
        return None
    w0, w1 = wins[0].time_range.start, wins[0].time_range.end
    inside = [(max(e.time_range.start, w0), min(e.time_range.end, w1), e.name) for e in dev
              if e.time_range.end > w0 and e.time_range.start < w1]
    merged = _merge((a, b) for a, b, _ in inside)
    starts = [a for a, _ in merged]
    by_name = Counter()
    for a, b, name in inside:
        by_name[name[:160]] += (b - a) / 1e6

    def under(prefix):
        return sum(e.device_time_total for e in cpu if e.name.startswith(prefix)
                   and w0 <= e.time_range.start <= w1) / 1e6

    calls = sorted((e.time_range.start, e.time_range.end) for e in cpu if e.name == ITEM)
    gaps, last = [], w0
    for a, b in merged:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if w1 > last:
        gaps.append((last, w1))
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu
                   if e.name not in (WINDOW, ITEM)), key=lambda t: t[0])
    host_starts = [t[0] for t in host]
    idle = Counter()
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:5000]:
        idle[_doing(host, host_starts, (a + b) / 2)] += (b - a) / 1e6
    busy = sum(b - a for a, b in merged) / 1e6
    spans_s, span_calls = _spans(cpu, dev, w0, w1)
    return {
        "window_s": (w1 - w0) / 1e6, "busy_s": busy, "items": items,
        "kernels_s": dict(by_name),
        "backward_s": under("autograd::engine::evaluate_function"),
        "spans_s": spans_s, "span_calls": span_calls,
        "call_wall_s": [(b - a) / 1e6 for a, b in calls],
        "call_busy_s": [_busy_within(merged, starts, a, b) / 1e6 for a, b in calls],
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": [[n, s] for n, s in idle.most_common(10)],
    }


def _doing(host, starts, t) -> str:
    """The innermost host op running at ``t``: of the ops that contain it,
    the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 5000, -1), -1):
        if host[j][1] >= t:
            return host[j][2][:120]
    return "host: between ops"
