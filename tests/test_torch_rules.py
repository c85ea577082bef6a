"""Rules of the PyTorch port that hold without a GPU: it imports neither JAX
nor the reference package (nor PIL), CUDA wrappers refuse what is not a CUDA tensor,
the ctypes signatures match the C entry points, and chip_smoke.py fails
(printing no result) where there is no card or no repository.
"""

import ast
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from collaborative_distillation_tpu_torch.ops import conv as tconv
from collaborative_distillation_tpu_torch.ops import cuda as kc
from collaborative_distillation_tpu_torch.ops.cuda import _build
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
    assert all(k.launches == 0 for k in kc.KERNELS)
    assert all(callable(k.plain) for k in kc.KERNELS)


def test_dispatch_takes_plain_on_cpu_and_refuses_other_devices():
    x = torch.zeros(1, 4, 4, 8)
    assert not tconv.on_card(x)
    assert tconv.max_pool_2x2(x).shape == (1, 2, 2, 8)
    assert [e.shape for e in tsp._exchange_row_halos([x, x], 2)] == [(1, 8, 4, 8)] * 2
    assert [e.shape for e in tsp.halo_exchange_rows([x, x])] == [(1, 6, 4, 8)] * 2
    with pytest.raises(ValueError, match="device"):
        tconv.on_card(torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="device"):
        tsp._exchange_row_halos([torch.zeros(1, 4, 4, 8, device="meta")] * 2, 2)


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
