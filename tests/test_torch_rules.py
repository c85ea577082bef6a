"""Rules of the PyTorch port that hold without a GPU: it imports neither JAX
nor the reference package (nor PIL), CUDA wrappers refuse what is not a CUDA tensor,
the ctypes signatures match the C entry points, a tensor that requires grad
leaves every kernel with a ``grad_fn``, and chip_smoke.py fails (printing no
result) where there is no card or no repository.
"""

import ast
import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import sys
import types

import pytest
import torch

from collaborative_distillation_tpu_torch.ops import conv as tconv
from collaborative_distillation_tpu_torch.ops import cuda as kc
from collaborative_distillation_tpu_torch.ops.cuda import _build
from collaborative_distillation_tpu_torch.ops.cuda import conv as kconv
from collaborative_distillation_tpu_torch.ops.cuda import pool as kpool
from collaborative_distillation_tpu_torch.parallel import spatial as tsp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "collaborative_distillation_tpu_torch")


def _port_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(_port_files()), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    # nor PIL: the card's machine has none, and the codec is the port's own
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "collaborative_distillation_tpu", "PIL"), (path, name)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kc.conv3x3_reflect(x, torch.zeros(3, 3, 8, 4), torch.zeros(4), True)
    with pytest.raises(ValueError, match="CUDA"):
        kc.conv1x1_bias(x, torch.zeros(8, 4), torch.zeros(4), False)
    with pytest.raises(ValueError, match="CUDA"):
        kc.sum_gram(x.reshape(16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kc.max_pool_2x2(x)
    with pytest.raises(ValueError, match="CUDA"):
        kc.upsample_nearest_2x(x)
    with pytest.raises(ValueError, match="CUDA"):
        kc.halo_exchange_rows(x, x[:, -2:], None, 2)
    with pytest.raises(ValueError):
        kc.halo_exchange_rows(x, x[:, -1:], None, 2)  # one halo row where two are due
    with pytest.raises(ValueError):
        kc.conv3x3_reflect(x, torch.zeros(3, 3, 5, 4), None, True)  # Cin mismatch
    with pytest.raises(ValueError):
        kc.sum_gram(torch.zeros(4, 600))  # C > 512
    with pytest.raises(ValueError):
        kc.conv1x1_bias(x, torch.zeros(5, 4), None, False)  # Cin mismatch
    with pytest.raises(ValueError):
        kc.conv1x1_bias(torch.zeros(2, 200), torch.zeros(200, 4), None, False)  # Cin > 128
    g = x.clone().requires_grad_()   # a launch records no gradient: refused
    for call in (lambda: kc.conv1x1_bias(g, torch.zeros(8, 4), None, False),
                 lambda: kc.sum_gram(g.reshape(16, 8)), lambda: kc.upsample_nearest_2x(g),
                 lambda: kc.halo_exchange_rows(g, None, None, 2)):
        with pytest.raises(ValueError, match="requires grad"):
            call()
    assert all(k.launches == 0 for k in kc.KERNELS)
    assert all(callable(k.plain) for k in kc.KERNELS)


def test_dispatch_takes_plain_on_cpu_and_refuses_other_devices():
    x = torch.zeros(1, 4, 4, 8)
    assert not tconv.on_card(x)
    assert tconv.max_pool_2x2(x).shape == (1, 2, 2, 8)
    assert [e.shape for e in tsp._exchange_row_halos([x, x], 2)] == [(1, 8, 4, 8)] * 2
    pairs = tsp.halo_rows([x, x])
    assert [(t is None, b is None) for t, b in pairs] == [(True, False), (False, True)]
    assert [y.shape for y in tsp.conv3x3_halo([x, x], [torch.zeros(3, 3, 8, 2)] * 2,
                                              [None] * 2)] == [(1, 4, 4, 2)] * 2
    with pytest.raises(ValueError, match="device"):
        tconv.on_card(torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="device"):
        tsp._exchange_row_halos([torch.zeros(1, 4, 4, 8, device="meta")] * 2, 2)


def _host_view(ptr, shape):
    n = 1
    for d in shape:
        n *= d
    return torch.frombuffer((ctypes.c_float * n).from_address(ptr), dtype=torch.float32).view(shape)


def _host_rows(ptr, stride, shape):
    """One row an image, image i's ``i * stride`` floats after image 0's."""
    n, _, w, c = shape
    flat = _host_view(ptr, ((n - 1) * stride + w * c,))
    return flat.as_strided(shape, (stride, w * c, c, 1))


class _StubLibrary:
    """The kernels' C entry points computed by their plain versions, on the
    host memory behind the pointers the wrappers pass."""

    def cd_conv3x3_reflect(self, x, w, b, y, top, bot, top_stride, bot_stride, n, h, wd,
                           cin, cout, relu, template, grid, stream):
        rows = [None if p is None else _host_rows(p, s, (n, 1, wd, cin))
                for p, s in ((top, top_stride), (bot, bot_stride))]
        out = kc.conv3x3_reflect.plain(_host_view(x, (n, h, wd, cin)),
                                       _host_view(w, (3, 3, cin, cout)),
                                       _host_view(b, (cout,)), bool(relu),
                                       top=rows[0], bot=rows[1])
        _host_view(y, (n, h, wd, cout)).copy_(out)
        return 0

    def cd_max_pool_2x2(self, x, y, n, h, w, c, stream):
        _host_view(y, (n, h // 2, w // 2, c)).copy_(kc.max_pool_2x2.plain(
            _host_view(x, (n, h, w, c))))
        return 0

    def cd_upsample_nearest_2x(self, x, y, n, h, w, c, stream):
        _host_view(y, (n, 2 * h, 2 * w, c)).copy_(kc.upsample_nearest_2x.plain(
            _host_view(x, (n, h, w, c))))
        return 0


@pytest.fixture()
def stub_card(monkeypatch):
    """Every op takes its kernel's launch (``on_card``), and the launch goes
    through the wrappers' own ctypes path into a stub library."""
    monkeypatch.setattr(tconv, "on_card", lambda x: True)
    for mod in (kconv, kpool):   # host tensors pass; inputs that require grad do not
        monkeypatch.setattr(mod, "_check_cuda",
                            lambda name, *t, rows=(), dtype=None: kconv._refuse_grad(
                                name, *t, *rows))
    monkeypatch.setattr(kconv, "device_plan", lambda *a: kconv.launch_plan(*a[:5], 132))
    monkeypatch.setattr(_build, "library", lambda: _StubLibrary())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    for k in kc.KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    monkeypatch.setattr(kc.conv3x3_reflect, "halo_launches", 0)


def test_kernels_leave_tensors_that_require_grad_with_a_grad_fn(stub_card):
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 6, 5, 4, generator=g, requires_grad=True)
    w = (torch.rand(3, 3, 4, 8, generator=g) - 0.5).requires_grad_()
    b = (torch.rand(8, generator=g) - 0.5).requires_grad_()
    # the bare wrapper is a ctypes launch that records no gradient: it refuses
    with pytest.raises(ValueError, match="requires grad"):
        kc.conv3x3_reflect(x, w, b, True)
    with pytest.raises(ValueError, match="requires grad"):
        kc.max_pool_2x2(x)
    y = tconv.upsample_nearest_2x(tconv.max_pool_2x2(tconv.conv3x3(x, w, b, relu=True)))
    assert y.grad_fn is not None
    assert (kc.conv3x3_reflect.launches, kc.max_pool_2x2.launches,
            kc.upsample_nearest_2x.launches) == (1, 1, 1)
    grads = torch.autograd.grad(y.square().sum(), (x, w, b))
    # the plain path's own autograd (no ReLU or pool ties in these inputs)
    ref = kc.upsample_nearest_2x.plain(kc.max_pool_2x2.plain(
        kc.conv3x3_reflect.plain(x, w, b, True)))
    for got, want in zip(grads, torch.autograd.grad(ref.square().sum(), (x, w, b))):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # without grad the ops launch as they did, and nothing is recorded
    with torch.no_grad():
        z = tconv.max_pool_2x2(tconv.conv3x3(x, w, b, relu=True))
    assert z.grad_fn is None and kc.conv3x3_reflect.launches == 2


def test_halo_rows_reach_the_launch_as_pointers_and_batch_strides(stub_card):
    """The per-conv path's halo rows are views of the neighbour shards (a
    row inside another map, its batch stride that map's image): the wrapper
    passes their addresses and strides in elements, and the stub's launch
    (the plain version on the memory behind them) equals the plain version
    on the views themselves; each launch with a row counts as a halo launch."""
    g = torch.Generator().manual_seed(0)
    up, x, down = (torch.rand(2, h, 5, 3, generator=g) for h in (4, 3, 6))
    w, b = torch.rand(3, 3, 3, 4, generator=g) - 0.5, torch.rand(4, generator=g)
    for top, bot in ((up[:, -1:], down[:, :1]), (None, down[:, :1]), (up[:, -1:], None)):
        got = tconv.conv3x3(x, w, b, relu=False, top=top, bot=bot)
        torch.testing.assert_close(got, kconv.conv3x3_plain(x, w, b, False, top=top, bot=bot),
                                   rtol=0, atol=0)
    got = tconv.conv3x3(x, w, b, relu=True)
    assert (kc.conv3x3_reflect.launches, kc.conv3x3_reflect.halo_launches) == (4, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kc.conv3x3_reflect(x, w, b, True, top=up.transpose(2, 3).contiguous().transpose(2, 3)[:, :1])
    with pytest.raises(ValueError, match="row"):
        kc.conv3x3_reflect(x, w, b, True, top=up[:, -2:])
    with pytest.raises(ValueError, match="inference only"):
        tconv.conv3x3(x.clone().requires_grad_(), w, b, top=up[:, -1:])


def test_ctypes_signatures_match_c_entry_points():
    found = {}
    for src in _build._sources():
        text = open(src).read()
        for name, args in re.findall(r'extern "C" int (cd_\w+)\(([^)]*)\)', text):
            found[name] = len([a for a in args.split(",") if a.strip()])
    assert found == {k: len(v) for k, v in _build._SIGNATURES.items()}


def test_build_is_keyed_by_source_hash_inside_the_repo():
    d = _build.build_dir()
    assert d.startswith(os.path.join(REPO, "build", "torch_kernels") + os.sep)
    assert d == _build.build_dir()
    assert "arch=compute_90a,code=sm_90a" in _build._ARCH


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card(tmp_path):
    r = _run_smoke(REPO)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    r = _run_smoke(str(alone))
    assert r.returncode != 0 and '"ok"' not in r.stdout
