"""The accepted reduction (``benchlib/trace.py``) on a trace that holds the
program's own ranges (its ``utils/profiling.span``: ``cd.cascade``,
``cd.conv3x3``, ...): on synthetic profiler events, where every number is
known, each key reads as on the same trace without them."""

import dataclasses

import pytest

from benchlib import trace


@dataclasses.dataclass
class Range:
    start: float
    end: float


@dataclasses.dataclass
class Kernel:
    duration: float


@dataclasses.dataclass
class Event:
    """What the reduction reads of a ``torch.profiler`` event (µs): the
    kernels correlated to it and its children, whose device time
    ``device_time_total`` sums as the profiler's does."""
    name: str
    time_range: Range
    device_type: str = "DeviceType.CPU"
    is_user_annotation: bool = False
    kernels: list = dataclasses.field(default_factory=list)
    cpu_children: list = dataclasses.field(default_factory=list)

    @property
    def device_time_total(self):
        return (sum(k.duration for k in self.kernels)
                + sum(c.device_time_total for c in self.cpu_children))


def host(name, a, b, dev=0.0, children=()):
    return Event(name, Range(a, b), kernels=[Kernel(dev)] if dev else [],
                 cpu_children=list(children))


def card(name, a, b):
    return Event(name, Range(a, b), "DeviceType.CUDA")


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
    gets the name of the span that was open."""
    plain, ranged = trace.reduce(BASE, items=2), trace.reduce(BASE + RANGES, items=2)
    assert set(ranged) == set(plain)
    for key in set(plain) - {"idle_gaps"}:
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
