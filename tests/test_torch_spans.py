"""The port's spans and counters (``utils/profiling.py``) on the CPU.

Without a profiler a span is one shared null context and enters nothing;
under ``torch.profiler`` each layer's span is recorded with the nesting
PERF.md §3 gives: ``cd.upload``, ``cd.cascade`` and ``cd.readback`` at the
top of a host call, ``cd.style`` and ``cd.wct`` inside the cascade, ``cd.eigh`` inside
``cd.wct``, the 3x3 convs inside those or the cascade, and in a training step
``cd.train.forward`` and ``cd.train.optimizer``. ``counters`` sums the
kernels' launch counts and the host boundary's pinned-buffer counts as
they stand, and ``trace`` writes their change over a profiled block. Tiny shapes on the shipped 16x weights, one intra-op thread.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
from collaborative_distillation_tpu_torch.models.vgg import init_params
from collaborative_distillation_tpu_torch.ops import cuda as kc
from collaborative_distillation_tpu_torch.train.trainer import TrainConfig, Trainer
from collaborative_distillation_tpu_torch.utils import profiling, transfer
from collaborative_distillation_tpu_torch.utils.profiling import counters, span
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights")
# a slab engine takes its slab path from two margins (2 x 144 rows) up
SLAB_ROWS = 288
HW = {"plain": (48, 64), "slab": (320, 32)}
BOUNDARY = ("cd.upload", "cd.cascade", "cd.readback")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    return {"plain": WCTEngine(mode="16x", weights_root=WEIGHTS, device="cpu"),
            "slab": WCTEngine(mode="16x", weights_root=WEIGHTS, device="cpu",
                              slab_rows=SLAB_ROWS)}


def _pair(path, seed=0):
    g = np.random.default_rng(seed)
    h, w = HW[path]
    return (g.integers(0, 256, (h, w, 3), dtype=np.uint8),
            g.integers(0, 256, (32, 32, 3), dtype=np.uint8))


def _trainer():
    g = torch.Generator().manual_seed(0)
    student = init_params(encoder_spec("16x", 1, aux=True), g)
    frozen = {"be": init_params(encoder_spec("original", 1), g),
              "bd": init_params(decoder_spec("original", 1), g)}
    return Trainer(TrainConfig(mode="wct_se", stage=1, batch_size=2), student, frozen,
                   device="cpu")


def _batch():
    return torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))


def _recorded(fn):
    """``fn()`` under a CPU profiler: the ``cd.`` events in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = [e for e in prof.events() if e.name.startswith("cd.")]
    return sorted(events, key=lambda e: e.time_range.start)


def _span_parent(e):
    """The nearest enclosing ``cd.`` span's name, or None."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("cd."):
        p = p.cpu_parent
    return None if p is None else p.name


def _names(events):
    return [e.name for e in events]


def test_span_without_a_profiler_is_the_shared_null_context():
    a, b = span("cd.a"), span("cd.b")
    assert a is b is profiling._NULL
    assert isinstance(a, contextlib.nullcontext)
    with a:
        with b:
            pass


@pytest.mark.parametrize("what", ["stylize", "train_step"])
def test_without_a_profiler_no_range_is_entered(engines, monkeypatch, what):
    def refuse(name):
        raise AssertionError(f"a range {name!r} was entered with no profiler recording")
    monkeypatch.setattr(profiling, "_range", refuse)
    if what == "stylize":
        out = engines["plain"].stylize(*_pair("plain"), as_uint8=True)
        assert out.shape == (*HW["plain"], 3) and out.dtype == np.uint8
    else:
        losses, rec = _trainer().train_step(_batch())
        assert all(torch.isfinite(v) for v in losses.values())
        assert rec.shape == (2, 16, 16, 3)


def test_spans_nest_on_their_thread_as_function_scope_ranges():
    def run():
        with span("cd.outer"):
            with span("cd.inner"):
                torch.ones(4).sum()
    events = {e.name: e for e in _recorded(run)}
    assert _span_parent(events["cd.inner"]) == "cd.outer"
    assert _span_parent(events["cd.outer"]) is None
    assert "aten::sum" in [c.name for c in events["cd.inner"].cpu_children]
    # function scope: the ranges' kernels are correlated to them as to any
    # aten op, and the card shows no shadow range of them
    assert not any(e.is_user_annotation for e in events.values())


@pytest.mark.parametrize("path", ["plain", "slab"])
def test_host_call_records_the_boundary_and_cascade_spans(engines, path):
    events = _recorded(lambda: engines[path].stylize(*_pair(path), as_uint8=True))
    top = [e for e in events if _span_parent(e) is None]
    assert _names(top) == list(BOUNDARY)
    names = set(_names(events))
    assert {"cd.style", "cd.wct", "cd.conv3x3"} <= names
    for e in events:
        if e.name in ("cd.style", "cd.wct"):
            assert _span_parent(e) == "cd.cascade", e.name
        if e.name.startswith("cd.conv3x3"):
            assert _span_parent(e) in ("cd.cascade", "cd.style"), e.name
    # the content's WCT never runs inside the style's span, nor a span in itself
    assert all(_span_parent(e) != e.name for e in events)


def test_plain_path_opens_a_style_and_a_wct_span_a_stage(engines):
    events = _recorded(lambda: engines["plain"].stylize(*_pair("plain"), as_uint8=True))
    stages = len(engines["plain"].stages)
    assert _names(events).count("cd.style") == stages
    assert _names(events).count("cd.wct") == stages
    convs = [e for e in events if e.name == "cd.conv3x3"]
    assert {_span_parent(e) for e in convs} == {"cd.cascade", "cd.style"}


def test_slab_path_opens_wct_spans_for_sums_matrices_and_applies(engines):
    eng = engines["slab"]
    events = _recorded(lambda: eng.stylize(*_pair("slab"), as_uint8=True))
    windows = {k: len(list(eng.slab._slabs(HW["slab"][0], k))) for k in eng.stages}
    # per stage: a window's sums, the statistics, the coloring matrix, a
    # window's folded apply
    want = sum(2 * windows[k] + 2 for k in eng.stages)
    assert _names(events).count("cd.wct") == want
    assert _names(events).count("cd.style") == 1   # the fused path's one statistics call


@pytest.mark.parametrize("path", ["plain", "slab"])
def test_each_stage_decomposes_its_covariances_inside_a_wct_span(engines, path):
    """One ``cd.eigh`` a stage, the content's and the style's covariances
    together, inside the ``cd.wct`` of the coloring matrix."""
    events = _recorded(lambda: engines[path].stylize(*_pair(path), as_uint8=True))
    eighs = [e for e in events if e.name == "cd.eigh"]
    assert len(eighs) == len(engines[path].stages)
    assert all(_span_parent(e) == "cd.wct" for e in eighs)


@pytest.mark.parametrize("path", ["plain", "slab"])
def test_a_cached_style_opens_no_style_span(engines, path):
    content, style = _pair(path, seed=2)
    eng = engines[path]
    first = _recorded(lambda: eng.stylize(content, style, style_key=f"k-{path}"))
    second = _recorded(lambda: eng.stylize(content, style, style_key=f"k-{path}"))
    assert "cd.style" in _names(first)
    assert "cd.style" not in _names(second)
    assert "cd.cascade" in _names(second) and "cd.wct" in _names(second)


def test_device_resident_call_opens_the_cascade_alone(engines):
    c, s = (torch.from_numpy(a).float() / 255 for a in _pair("plain"))
    events = _recorded(lambda: engines["plain"].stylize_device(c, s))
    assert [e.name for e in events if _span_parent(e) is None] == ["cd.cascade"]


def test_photo_wct_records_its_wct_spans(engines):
    events = _recorded(lambda: engines["plain"].stylize(*_pair("plain"), pwct=True))
    assert _names(events).count("cd.wct") == len(engines["plain"].stages)
    assert all(_span_parent(e) == "cd.cascade" for e in events if e.name == "cd.wct")


def test_per_stage_slab_cascade_opens_style_spans():
    eng = WCTEngine(mode="16x", weights_root=WEIGHTS, device="cpu", slab_rows=SLAB_ROWS,
                    fused=False)
    events = _recorded(lambda: eng.stylize(*_pair("slab"), as_uint8=True))
    assert _names(events).count("cd.style") == len(eng.stages)
    assert all(_span_parent(e) == "cd.cascade" for e in events if e.name == "cd.style")


def test_train_step_records_forward_and_optimizer_spans():
    tr = _trainer()
    events = _recorded(lambda: tr.train_step(_batch()))
    top = [e for e in events if _span_parent(e) is None]
    assert _names(top) == ["cd.train.forward", "cd.train.optimizer", "cd.train.optimizer"]
    convs = [e for e in events if e.name == "cd.conv3x3"]
    assert convs and all(_span_parent(e) == "cd.train.forward" for e in convs)


def test_counters_sum_the_kernels_launch_counts(monkeypatch):
    want = sum(k.launches for k in kc.KERNELS + kc.BF16_KERNELS)
    assert counters()["launches"] == want
    monkeypatch.setattr(kc.conv3x3_reflect, "launches", kc.conv3x3_reflect.launches + 5)
    monkeypatch.setattr(kc.conv1x1_bias_bf16, "launches", kc.conv1x1_bias_bf16.launches + 2)
    assert counters()["launches"] == want + 7
    # the loader's kernels stand apart
    monkeypatch.setattr(kc.box_resize_u8, "launches", kc.box_resize_u8.launches + 3)
    assert counters()["launches"] == want + 7


def test_counters_sum_the_pinned_buffers_of_the_host_boundary(monkeypatch):
    before = counters()
    monkeypatch.setitem(transfer.PINNED, "buffers", transfer.PINNED["buffers"] + 7)
    monkeypatch.setitem(transfer.PINNED, "bytes", transfer.PINNED["bytes"] + 1110)
    after = counters()
    assert after["pinned_buffers"] - before["pinned_buffers"] == 7
    assert after["pinned_bytes"] - before["pinned_bytes"] == 1110
    assert set(after) == {"launches", "pinned_buffers", "pinned_bytes", "eigh_kernel",
                          "eigh_library"}


def test_pinned_empty_counts_each_buffer_and_its_bytes(monkeypatch):
    """The one allocator of pinned host memory counts what it makes (the
    CPU build cannot pin, so the allocation itself is made pageable)."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory, **k: empty(*a, **k))
    before = counters()
    a = transfer.pinned_empty((3, 5), torch.uint8)
    b = transfer.pinned_empty(7, torch.float32)
    assert (a.shape, b.shape) == ((3, 5), (7,))
    after = counters()
    assert after["pinned_buffers"] - before["pinned_buffers"] == 2
    assert after["pinned_bytes"] - before["pinned_bytes"] == 15 + 28


def test_spans_need_the_private_range_class_only_while_recording(monkeypatch):
    """Without torch's private function-scope range class the port still
    runs untraced; a traced run says what is missing."""
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    with span("cd.cascade"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="_RecordFunctionFast"):
            span("cd.cascade")


def test_cpu_transfers_make_no_pinned_buffers():
    before = counters()
    a = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    np.testing.assert_array_equal(transfer.fetch(transfer.push(a, "cpu")), a)
    assert counters() == before


def test_trace_writes_the_counters_change_over_the_block(tmp_path, monkeypatch):
    monkeypatch.setitem(transfer.PINNED, "buffers", transfer.PINNED["buffers"])
    monkeypatch.setitem(transfer.PINNED, "bytes", transfer.PINNED["bytes"])
    monkeypatch.setattr(kc.conv3x3_reflect, "launches", kc.conv3x3_reflect.launches)
    with profiling.trace(str(tmp_path / "prof")):
        with span("cd.cascade"):
            kc.conv3x3_reflect.launches += 4
            transfer.PINNED["buffers"] += 3
            transfer.PINNED["bytes"] += 96
    kc.conv3x3_reflect.launches += 9          # after the block: not counted
    with open(tmp_path / "prof" / "counters.json") as f:
        assert json.load(f) == {"launches": 4, "pinned_buffers": 3, "pinned_bytes": 96,
                                "eigh_kernel": 0, "eigh_library": 0}
    with open(tmp_path / "prof" / "trace.json") as f:
        assert any(e.get("name") == "cd.cascade" for e in json.load(f)["traceEvents"])


def test_trace_without_a_directory_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace(""):
        assert not torch.autograd._profiler_enabled()
    assert os.listdir(tmp_path) == []
