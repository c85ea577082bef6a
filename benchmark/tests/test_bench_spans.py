"""The reduction (``benchlib/trace.py``) on a trace that holds the
program's own ranges (its ``utils/profiling.span``: ``cd.cascade``,
``cd.conv3x3``, ...): on synthetic profiler events, where every number is
known, each key reads as on the same trace without them, and the spans'
own keys (``spans_s``, ``span_calls``) read each device event once."""

import dataclasses
import itertools

import pytest

from benchlib import trace


@dataclasses.dataclass
class Range:
    start: float
    end: float


@dataclasses.dataclass
class Kernel:
    duration: float


_IDS = itertools.count(1)


@dataclasses.dataclass
class Event:
    """What the reduction reads of a ``torch.profiler`` event (µs): its
    correlation id (a launch shares its device event's), the kernels the
    profiler ties to it and its children, whose device time
    ``device_time_total`` sums as the profiler's does."""
    name: str
    time_range: Range
    device_type: str = "DeviceType.CPU"
    is_user_annotation: bool = False
    kernels: list = dataclasses.field(default_factory=list)
    cpu_children: list = dataclasses.field(default_factory=list)
    id: int = dataclasses.field(default_factory=lambda: next(_IDS))

    @property
    def device_time_total(self):
        return (sum(k.duration for k in self.kernels)
                + sum(c.device_time_total for c in self.cpu_children))


def host(name, a, b, dev=0.0, children=(), **kw):
    return Event(name, Range(a, b), kernels=[Kernel(dev)] if dev else [],
                 cpu_children=list(children), **kw)


def card(name, a, b, shadow=False):
    return Event(name, Range(a, b), "DeviceType.CUDA", is_user_annotation=shadow)


# the window [0, 1000] µs: three kernels on the card, an aten op, a call
BASE = [host("bench.window", 0, 1000), host("bench.item", 40, 900),
        host("aten::linalg_eigh", 320, 340, dev=200.0),
        host("autograd::engine::evaluate_function: X", 850, 880, dev=50.0),
        card("kernel_a", 100, 200), card("kernel_b", 300, 500), card("conv3x3_kernel", 600, 700),
        card("bench.window", 0, 1000)]
# the program's ranges: the cascade around two convs and work of its own,
# one range outside the window; a device-side shadow that the reduction
# leaves out
CONVS = [host("cd.conv3x3", 100, 150, dev=100.0), host("cd.conv3x3", 250, 260, dev=200.0)]
RANGES = [host("cd.cascade", 50, 800, dev=100.0, children=CONVS), *CONVS,
          host("cd.wct", 1100, 1200, dev=7.0),
          Event("cd.cascade", Range(100, 700), "DeviceType.CUDA", is_user_annotation=True)]


def test_existing_keys_are_unmoved_by_the_programs_ranges():
    """The idle gaps keep their seconds; only a gap the host spent in no op
    gets the name of the span that was open. ``spans_s`` and ``span_calls``
    are left out of the comparison: they read the program's ranges, so the
    ranges fill them by design (empty without them)."""
    plain, ranged = trace.reduce(BASE, items=2), trace.reduce(BASE + RANGES, items=2)
    assert set(ranged) == set(plain)
    assert plain["spans_s"] == {} and plain["span_calls"] == {}
    for key in set(plain) - {"idle_gaps", "spans_s", "span_calls"}:
        assert ranged[key] == plain[key], key
    before, after = dict(plain["idle_gaps"]), dict(ranged["idle_gaps"])
    assert sum(after.values()) == pytest.approx(sum(before.values()))
    renamed = {n for n in before if n not in after}
    assert renamed == {"host: between ops"} and {n for n in after if n not in before} == {
        "cd.cascade", "cd.conv3x3"}


def test_the_programs_ranges_add_no_device_time():
    """A range's card-side shadow covers no work of its own: the window's
    busy time and kernels stay those of the kernels alone."""
    got = trace.reduce(BASE + RANGES, items=2)
    assert got["busy_s"] == pytest.approx(400e-6)
    assert set(got["kernels_s"]) == {"kernel_a", "kernel_b", "conv3x3_kernel"}


def _window(*events):
    return [host("bench.window", 0, 1000), *events]


def launch(a, kernel, api="cudaLaunchKernel"):
    """The host's launch at ``a`` of a device event: the profiler gives
    both the same correlation id."""
    return host(api, a, a + 2, id=kernel.id)


def test_nested_spans_are_inclusive():
    """``cd.cascade`` holds ``cd.wct``, which holds ``cd.eigh``: each span's
    device time holds its nested spans' and host ops'."""
    k1, k2, k3, k4 = (card("k1", 100, 200), card("k2", 300, 320), card("k3", 400, 405),
                      card("Memset (Device)", 500, 503))
    mm = host("aten::mm", 250, 260, children=[launch(251, k2)])
    eigh = host("cd.eigh", 300, 320, children=[launch(301, k3)])
    wct = host("cd.wct", 200, 400, children=[mm, eigh, launch(330, k4, "cudaMemsetAsync")])
    cascade = host("cd.cascade", 100, 900, children=[launch(110, k1), wct])
    got = trace.reduce(_window(cascade, wct, mm, eigh, k1, k2, k3, k4), items=1)
    assert got["spans_s"] == pytest.approx({"cd.cascade": 128e-6, "cd.wct": 28e-6,
                                            "cd.eigh": 5e-6})
    assert got["span_calls"] == {"cd.cascade": 1, "cd.wct": 1, "cd.eigh": 1}


def test_span_readers_give_ms_and_opens_an_item():
    """``shares.span_ms`` and ``shares.span_opens``, the helpers a metric
    of a new span reads it through: per item, None where the span never
    opened, and ``span_ms`` None where it opened and ran nothing on the
    card (as on the CPU)."""
    from benchlib import shares
    k = card("k", 300, 306)
    events = _window(host("cd.wct", 200, 400, children=[launch(201, k)]),
                     host("cd.wct", 500, 600), host("cd.style", 700, 800), k)
    r = {"trace": trace.reduce(events, items=2)}
    assert shares.span_ms(r, "cd.wct") == pytest.approx(3e-3)
    assert shares.span_opens(r, "cd.wct") == 1.0
    assert shares.span_opens(r, "cd.style") == 0.5 and shares.span_ms(r, "cd.style") is None
    assert shares.span_ms(r, "cd.eigh") is None and shares.span_opens(r, "cd.eigh") is None


def test_an_op_that_waits_for_the_card_counts_its_kernels_once():
    """Buffer events inside an op that waits carry the op's id and its
    kernels again: ``device_time_total`` counts them twice over, the span
    once. An op whose id is a foreign launch's adds nothing."""
    k, copy, foreign = card("syevj", 400, 600), card("Memcpy DtoH", 610, 612), card("x", 5, 9)
    buffers = [host("Command Buffer Full", 310, 320, dev=200.0),
               host("Activity Buffer Request", 325, 330, dev=200.0)]
    op = host("aten::linalg_eigh", 300, 340, dev=200.0,
              children=[launch(301, k), launch(305, copy, "cudaMemcpyAsync"),
                        host("cudaStreamSynchronize", 306, 309), *buffers])
    for b in buffers:
        b.id = op.id
    odd = host("aten::empty", 342, 343, id=foreign.id)
    span = host("cd.eigh", 290, 350, children=[op, odd])
    assert span.device_time_total == 600.0
    got = trace.reduce(_window(span, op, odd, *buffers, k, copy, foreign), items=1)
    assert got["spans_s"] == pytest.approx({"cd.eigh": 202e-6})


def test_spans_sum_over_calls_and_same_name_nesting_counts_once():
    k1, k2, k3 = card("a", 120, 130), card("b", 140, 170), card("c", 400, 440)
    inner = host("cd.conv3x3", 120, 130, children=[launch(121, k1)])
    outer = host("cd.conv3x3", 100, 150, children=[inner, launch(140, k2)])
    again = host("cd.conv3x3", 400, 450, children=[launch(401, k3)])
    got = trace.reduce(_window(outer, inner, again, k1, k2, k3), items=1)
    assert got["spans_s"] == pytest.approx({"cd.conv3x3": 80e-6})
    assert got["span_calls"] == {"cd.conv3x3": 3}


def test_a_span_that_opens_outside_the_window_is_left_out():
    k1, k2, k3 = card("a", 90, 120), card("b", 1100, 1130), card("c", 1000, 1003)
    early = host("cd.upload", -50, 100, children=[launch(-40, k1)])
    late = host("cd.readback", 1100, 1200, children=[launch(1101, k2)])
    edge = host("cd.wct", 1000, 1050, children=[launch(1000, k3)])
    got = trace.reduce(_window(early, late, edge, k1, k2, k3), items=1)
    assert got["spans_s"] == pytest.approx({"cd.wct": 3e-6})
    assert got["span_calls"] == {"cd.wct": 1}


def test_a_ranges_card_side_shadow_is_never_a_span():
    """The shadow is no span, and adds no device time to one, even where it
    shares a launch's id."""
    k = card("kernel_a", 120, 130)
    go = launch(101, k)
    shadow = card("cd.cascade", 100, 700, shadow=True)
    shadow.id = go.id
    span = host("cd.wct", 100, 200, children=[go])
    got = trace.reduce(_window(shadow, span, k), items=1)
    assert got["spans_s"] == pytest.approx({"cd.wct": 10e-6})
    assert got["span_calls"] == {"cd.wct": 1}
    assert got["busy_s"] == pytest.approx(10e-6)


def test_bench_item_shadows_are_not_calls_and_the_window_is_the_hosts():
    """Each paced call is a host ``bench.item`` range; the card-side shadows
    of the calls and of the window, pieces of the card's busy stretches,
    count for nothing."""
    events = [card("bench.window", 100, 700, shadow=True), host("bench.window", 0, 1000),
              host("bench.item", 0, 400), host("bench.item", 500, 1000),
              card("bench.item", 100, 150, shadow=True), card("bench.item", 600, 700, shadow=True),
              card("kernel_a", 100, 300), card("kernel_b", 600, 700)]
    got = trace.reduce(events, items=2)
    assert got["window_s"] == pytest.approx(1000e-6)
    assert got["call_wall_s"] == pytest.approx([400e-6, 500e-6])
    assert got["call_busy_s"] == pytest.approx([200e-6, 100e-6])
