"""Arithmetic shared by the per-layer readers, on a run's record: its
profiled window (``trace``), the frozen work counts (``work``) and the
card's published peaks (``peaks``). A reader that finds nothing to read
returns None, and the metric is left out of the run's line."""

from __future__ import annotations


def traced(r: dict) -> dict | None:
    tr = r.get("trace")
    return tr if tr and tr["items"] > 0 and tr["window_s"] > 0 else None


def idle_pct(r: dict):
    tr = traced(r)
    return None if tr is None or tr["busy_s"] <= 0 else 100.0 * (1 - tr["busy_s"] / tr["window_s"])


def mfu_pct(r: dict):
    """The traced window's needed FLOPs over the window and the card's
    published peak for the configuration's dtype."""
    tr, pk = traced(r), r.get("peaks")
    if tr is None or not pk:
        return None
    flops = r["work"]["flops_per_item"] * tr["items"]
    return 100.0 * flops / tr["window_s"] / pk[r["work"]["dtype"]]


def per_item_ms(r: dict, key: str):
    tr = traced(r)
    return None if tr is None or tr[key] <= 0 else 1e3 * tr[key] / tr["items"]


def span_ms(r: dict, name: str):
    """Device ms an item inside the program's span ``name`` (the trace's
    ``spans_s``); None where the span did not open or ran nothing on the
    device."""
    tr = traced(r)
    s = tr["spans_s"].get(name, 0.0) if tr else 0.0
    return None if s <= 0 else 1e3 * s / tr["items"]


def span_opens(r: dict, name: str):
    """Times an item the program's span ``name`` opened (the trace's
    ``span_calls``); None where it never opened."""
    tr = traced(r)
    n = tr["span_calls"].get(name, 0) if tr else 0
    return None if n <= 0 else n / tr["items"]
