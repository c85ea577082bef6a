"""The harness on the CPU at tiny sizes, through ``run.run_cell`` (the entry
that skips the look for a card): every mix runs and comes out correct;
the control and each fault a cell can have come out not correct; a cell
made of new files only runs in a copy; the real command without a card
exits non-zero and prints nothing; no JAX module is ever loaded."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH_DIR, ROOT

import control
import run
from benchlib import manifest

SEED = 2 ** 31 + 11   # larger than 32 signed bits hold
CPU = torch.device("cpu")
# each cell at a size a CPU test can hold: the cd16x cells large enough that
# every stage's covariance is of full rank (the UHD cell keeps its slab
# path); the VGG-19 cell's 512 channels would need ~700^2 for that, so at
# 96^2 it is held to limits read at that size (TINY_LIMITS), where float32's
# eigh noise in the rank-deficient stage-5 covariance is kept and inverted
TINY = {
    "cd16x.uhd_slab": dict(content_hw=[384, 256], style_hw=[256, 256], slab_rows=288,
                           trace_items=2),
    "vgg19.plain_2k": dict(content_hw=[96, 96], style_hw=[96, 96], ring=2, trace_items=2),
    "cd16x.requests_2k": dict(content_hw=[256, 256], style_hw=[256, 256], ring=2,
                              trace_items=3),
    "cd16x.train_se5": dict(batch=2, crop=64, shorter_side=80, ring=4, trace_items=2),
}
# at 96^2, three seeds: the program 3.5e-3 to 8.5e-3 rms, 8.5e-3 to 1.7e-2
# block; the control 4.6e-2 to 6.3e-2 rms, 6.8e-2 to 7.7e-2 block
TINY_LIMITS = {"vgg19.plain_2k": {"rms": 0.02, "block_rms": 0.035}}
CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


def _run(cell, *, system="program", trace=False, seed=SEED):
    c = manifest.load_cell(cell, BENCH_DIR)
    c.workload["limits"].update(TINY_LIMITS.get(cell, {}))
    return run.run_cell(torch, c, seed=seed, seconds=0.05, trace=trace, device=CPU,
                        system=system, mix_overrides=TINY[cell])


def test_every_cell_has_a_tiny_size():
    assert set(CELLS) == set(TINY)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_each_mix_runs_and_is_correct(cell, trace):
    out = _run(cell, trace=trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(manifest.load_cell(cell, BENCH_DIR).workload["limits"])
    if not trace:
        e2e = manifest.load_cell(cell, BENCH_DIR).end_to_end
        assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert not run.forbidden_modules()


def test_same_seed_same_inputs():
    from benchlib import inputs
    cell = manifest.load_cell("cd16x.uhd_slab", BENCH_DIR)
    mix = {**cell.mix, **TINY["cd16x.uhd_slab"]}
    a = inputs.stylize_ring(torch, BENCH_DIR, mix, SEED, CPU)
    b = inputs.stylize_ring(torch, BENCH_DIR, mix, SEED, CPU)
    c = inputs.stylize_ring(torch, BENCH_DIR, mix, SEED + 1, CPU)
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert not torch.equal(a[0][0], c[0][0]) and not torch.equal(a[0][0], a[1][0])
    rows = inputs.train_ring(torch, BENCH_DIR, {**cell.mix, **TINY["cd16x.train_se5"],
                                                "shorter_side": 80}, SEED, CPU)
    flat = torch.cat(rows).flatten(1)
    assert len({tuple(r[:64].tolist()) for r in flat}) == flat.shape[0]   # rows all differ


@pytest.mark.parametrize("cell,fault", [
    ("cd16x.uhd_slab", "altered_answer"), ("vgg19.plain_2k", "altered_answer"),
    ("cd16x.requests_2k", "altered_answer"), ("cd16x.train_se5", "unchanged_state"),
    ("cd16x.train_se5", "half_batch")])
def test_each_fault_is_not_correct(cell, fault):
    """The run with the program broken underneath its timed path, one fault
    of control.FAULTS at a time."""
    with control.FAULTS[fault]():
        out = _run(cell)
    assert not out["correct"] and out["failed"] >= 1
    if fault == "unchanged_state":
        assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference in TF32 in the program's place fails the cell's limits."""
    out = _run(cell, system="control")
    assert not out["correct"]


def test_a_cell_of_new_files_only_runs_in_a_copy(tmp_path):
    """A configuration, a mix, a cell and a per-layer metric added as files,
    and entries added to BENCHMARK.json: no file of the harness edited."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp_path / "benchmark"
    cfg = json.load(open(bench / "configs" / "cd16x.json"))
    (bench / "configs" / "cd16x_copy.json").write_text(json.dumps({**cfg, "name": "cd16x_copy"}))
    (bench / "mixes" / "tiny_plain.json").write_text(json.dumps({
        "driver": "stylize_device", "content_hw": [48, 64], "style_hw": [32, 32], "ring": 2,
        "slab_rows": 0, "alpha": 0.6, "warm_items": 1, "trace_items": 2, "sample": 2}))
    why = "a throwaway cell of new files"
    (bench / "workloads" / "cd16x_copy.tiny_plain.json").write_text(json.dumps({
        "config": "cd16x_copy", "traffic": "tiny_plain", "chips": 1, "why": why,
        "limits": {"rms": 0.01}}))
    (bench / "metrics" / "items.tiny.py").write_text(
        "def read(r):\n    return float(r['trace']['items']) if r.get('trace') else None\n")
    m = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    m["configs"].append({"name": "cd16x_copy", "source": cfg["source"],
                         "file": "benchmark/configs/cd16x_copy.json", "reduced": [], "why": why})
    m["workloads"].append({"name": "cd16x_copy.tiny_plain", "config": "cd16x_copy",
                           "traffic": "tiny_plain", "chips": 1, "why": why})
    m["end_to_end"][1]["workloads"].append("cd16x_copy.tiny_plain")
    m["per_layer"].append({"name": "items.tiny", "unit": "items", "better": "higher",
                           "source": "device_trace", "layer": "Device (H100)",
                           "moves": "mpix_per_s", "workloads": ["cd16x_copy.tiny_plain"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    code = f"""
import json, sys, torch
sys.path[:0] = [{str(bench)!r}, {ROOT!r}]
import control
import run
from benchlib import manifest
cell = manifest.load_cell("cd16x_copy.tiny_plain", {str(bench)!r})
for trace in (False, True):
    print(json.dumps(run.run_cell(torch, cell, seed=5, seconds=0.05, trace=trace,
                                  device=torch.device("cpu"))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    plain, traced = [json.loads(l) for l in out.stdout.strip().splitlines()[-2:]]
    assert plain["correct"] and set(plain["metrics"]) == {"setup_s", "mpix_per_s", "peak_gib"}
    assert traced["correct"] and traced["metrics"]["items.tiny"]["value"] >= 1


def _command(cwd, extra_env=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(extra_env or {})}
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cd16x.uhd_slab",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=300)


def test_the_command_without_a_card_exits_nonzero_and_prints_nothing():
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_the_command_outside_a_checkout_exits_nonzero(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = _command(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_jax_module_in_the_process():
    for cell in CELLS:
        _run(cell)
    # compared by whole top-level names: the program's own name starts with the JAX package's
    assert "collaborative_distillation_tpu_torch" in sys.modules
    assert not run.forbidden_modules()
