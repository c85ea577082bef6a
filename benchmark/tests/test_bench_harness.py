"""The harness on the CPU at tiny sizes, through ``run.run_cell`` (the entry
that skips the look for a card): every mix runs and comes out correct;
the control and each fault a cell can have come out not correct; a cell
made of new files only runs in a copy; the real command without a card
exits non-zero and prints nothing; no JAX module is ever loaded. Each
cell's sizes, limits and runs that must fail are read from its own file,
``tests/cells/<cell>.json`` (``conftest.py``)."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH_DIR, ROOT, cell_case, held_to

import control
import run
from benchlib import manifest

SEED = 2 ** 31 + 11   # larger than 32 signed bits hold
CPU = torch.device("cpu")
CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


def _cases() -> dict:
    """The cells whose test file reads; the others fail one test alone
    (``test_every_cell_has_a_tiny_size``)."""
    out = {}
    for cell in CELLS:
        try:
            out[cell] = cell_case(cell)
        except (FileNotFoundError, ValueError):
            pass
    return out


CASES = _cases()
FAULTED = [(c, r) for c, case in CASES.items() for r in case["not_correct"] if r != "control"]


def _run(cell, *, system="program", trace=False, seed=SEED):
    c = manifest.load_cell(cell, BENCH_DIR)
    c.workload["limits"].update(CASES[cell].get("limits", {}).get("values", {}))
    return run.run_cell(torch, c, seed=seed, seconds=0.05, trace=trace, device=CPU,
                        system=system, mix_overrides=CASES[cell]["mix"])


def test_every_cell_has_a_tiny_size():
    for cell in CELLS:
        cell_case(cell)   # raises, naming the file to add or the run it refuses


def test_a_cell_without_its_test_file_is_named(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"nope\.tiny\.json"):
        cell_case("nope.tiny", str(tmp_path))


@pytest.mark.parametrize("runs,faults", [
    (["control", "no_such_fault"], ()), (["Control"], ()), ([], ()),
    (["altered_answer"], ("altered_answer",)),
    (["control", "unchanged_state"], ("unchanged_state", "half_batch"))])
def test_a_not_correct_run_that_is_no_fault_is_refused(tmp_path, runs, faults):
    """Refused: a run that is no fault, a list without the control, a list
    without a fault the cell's driver is held to."""
    (tmp_path / "x.tiny.json").write_text(json.dumps({"mix": {}, "not_correct": runs}))
    with pytest.raises(ValueError, match="not_correct"):
        cell_case("x.tiny", str(tmp_path), faults)


def test_each_driver_lists_the_faults_its_cells_are_held_to(monkeypatch):
    assert held_to("cd16x.train_se5") == ("unchanged_state", "half_batch")
    assert held_to("cd16x.uhd_slab") == held_to("cd16x.requests_2k") == ("altered_answer",)
    monkeypatch.setattr(manifest.Cell, "driver", lambda self: object())
    with pytest.raises(ValueError, match="HELD_TO"):
        held_to("cd16x.uhd_slab")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", list(CASES))
def test_each_mix_runs_and_is_correct(cell, trace):
    out = _run(cell, trace=trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(manifest.load_cell(cell, BENCH_DIR).workload["limits"])
    if not trace:
        e2e = manifest.load_cell(cell, BENCH_DIR).end_to_end
        assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert not run.forbidden_modules()


def test_a_mix_sets_the_host_threads_for_its_run_only(monkeypatch):
    seen = []

    class Driver:
        @staticmethod
        def run(ctx):
            seen.append(torch.get_num_threads())
            raise RuntimeError("set-up stops here")

    monkeypatch.setattr(manifest.Cell, "driver", lambda self: Driver)
    before = torch.get_num_threads()
    with pytest.raises(RuntimeError, match="set-up stops"):
        _run("cd16x.requests_2k")
    assert seen == [manifest.load_cell("cd16x.requests_2k", BENCH_DIR).mix["host_threads"]]
    assert torch.get_num_threads() == before


def test_same_seed_same_inputs():
    from benchlib import inputs
    cell = manifest.load_cell("cd16x.uhd_slab", BENCH_DIR)
    mix = {**cell.mix, **CASES["cd16x.uhd_slab"]["mix"]}
    a = inputs.stylize_ring(torch, BENCH_DIR, mix, SEED, CPU)
    b = inputs.stylize_ring(torch, BENCH_DIR, mix, SEED, CPU)
    c = inputs.stylize_ring(torch, BENCH_DIR, mix, SEED + 1, CPU)
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert not torch.equal(a[0][0], c[0][0]) and not torch.equal(a[0][0], a[1][0])
    rows = inputs.train_ring(torch, BENCH_DIR, {**cell.mix, **CASES["cd16x.train_se5"]["mix"],
                                                "shorter_side": 80}, SEED, CPU)
    flat = torch.cat(rows).flatten(1)
    assert len({tuple(r[:64].tolist()) for r in flat}) == flat.shape[0]   # rows all differ


@pytest.mark.parametrize("cell,fault", FAULTED)
def test_each_fault_is_not_correct(cell, fault):
    """The run with the program broken underneath its timed path, one fault
    of control.FAULTS at a time: each that the cell's file names."""
    with control.FAULTS[fault]():
        out = _run(cell)
    assert not out["correct"] and out["failed"] >= 1
    if fault == "unchanged_state":
        assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", list(CASES))
def test_the_control_is_not_correct(cell):
    """The reference a precision below the configuration's, in the program's
    place, fails the cell's limits (every cell's file names the control)."""
    out = _run(cell, system="control")
    assert not out["correct"]


def _tree(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


NEW_CONFIG = "cd16x_bf16_copy"
NEW_CELL = NEW_CONFIG + ".tiny_plain"
# the files of a cell added in a copy: a bfloat16 configuration cut in depth,
# a mix naming a driver of its own, the cell, its test data and per-layer
# metrics that read a span. Its limits were read at its size on the CPU, 12
# seeds: the program 5.0e-3 to 9.3e-3 rms, 7.2e-3 to 1.5e-2 block; the
# control (fp8) 6.3e-2 to 0.125 rms, 8.6e-2 to 0.217 block
NEW_FILES = {
    "mixes/tiny_plain.json": json.dumps({
        "driver": "tiny_wrap", "content_hw": [256, 256], "style_hw": [256, 256], "ring": 2,
        "slab_rows": 0, "alpha": 0.6, "warm_items": 1, "trace_items": 2, "sample": 2}),
    "drivers/tiny_wrap.py": (
        '"""A driver of its own: stylize_device, with work counts of its own."""\n'
        "from drivers import stylize_device\n\n"
        "HELD_TO = stylize_device.HELD_TO\n\n\n"
        "def run(ctx):\n"
        "    rec = stylize_device.run(ctx)\n"
        "    rec['work'] = {**rec['work'], 'flops_per_item': 2 * rec['work']['flops_per_item']}\n"
        "    return rec\n"),
    f"workloads/{NEW_CELL}.json": json.dumps({
        "config": NEW_CONFIG, "traffic": "tiny_plain", "chips": 1,
        "why": "a throwaway cell of new files", "limits": {"rms": 0.025, "block_rms": 0.04}}),
    f"tests/cells/{NEW_CELL}.json": json.dumps({
        "mix": {"trace_items": 2}, "not_correct": ["control", "altered_answer"]}),
    "metrics/wct_ms.tiny.py": (
        '"""Device ms an image in the cd.wct span."""\n'
        "from benchlib.shares import span_ms\n\n\n"
        "def read(r):\n"
        "    return span_ms(r, 'cd.wct')\n"),
    "metrics/wct_opens.tiny.py": (
        '"""Times an image the cd.wct span opened."""\n'
        "from benchlib.shares import span_opens\n\n\n"
        "def read(r):\n"
        "    return span_opens(r, 'cd.wct')\n"),
}


def test_a_cell_of_new_files_only_runs_in_a_copy(tmp_path):
    """A bfloat16 configuration cut in depth, a mix with a driver of its
    own, a cell, its test data and per-layer metrics that read a span, added
    as files, and entries added to BENCHMARK.json: the copy's own manifest
    and harness tests pass for the new cell (its control, in fp8, and its
    fault come out not correct), its traced run finds the span, and no file
    of the benchmark is edited."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    before = _tree(bench)
    cfg = json.load(open(bench / "configs" / "cd16x.json"))
    cfg = {**cfg, "name": NEW_CONFIG, "dtype": "bfloat16", "stages": [4, 3, 2, 1],
           "reduced": ["stages"]}
    (bench / "configs" / f"{NEW_CONFIG}.json").write_text(json.dumps(cfg))
    for rel, text in NEW_FILES.items():
        assert not (bench / rel).exists(), rel
        (bench / rel).write_text(text)
    why = "a throwaway cell of new files"
    m = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    m["configs"].append({"name": NEW_CONFIG, "source": cfg["source"],
                         "file": f"benchmark/configs/{NEW_CONFIG}.json", "reduced": ["stages"],
                         "why": why})
    m["workloads"].append({"name": NEW_CELL, "config": NEW_CONFIG, "traffic": "tiny_plain",
                           "chips": 1, "why": why})
    next(e for e in m["end_to_end"] if e["name"] == "mpix_per_s")["workloads"].append(NEW_CELL)
    for name, unit in (("wct_ms.tiny", "ms/image"), ("wct_opens.tiny", "1/image")):
        m["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                               "source": "program_span", "layer": "WCT", "moves": "mpix_per_s",
                               "workloads": [NEW_CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    env = {**os.environ, "PYTHONPATH": ROOT}   # the program, from this checkout
    tests = bench / "tests"
    for args in ([str(tests / "test_bench_manifest.py")],
                 [str(tests / "test_bench_harness.py"), "-k", f"{NEW_CONFIG} or every_cell"]):
        out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
                              *args], capture_output=True, text=True, cwd=tmp_path, env=env,
                             timeout=600)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    ran = [l for l in out.stdout.splitlines() if l.startswith("PASSED") and NEW_CELL in l]
    assert len(ran) == 4, out.stdout[-3000:]   # correct, traced and not; the control; the fault
    code = f"""
import json, sys, torch
sys.path[:0] = [{str(bench)!r}, {ROOT!r}]
import run
from benchlib import manifest
cell = manifest.load_cell({NEW_CELL!r}, {str(bench)!r})
for trace in (False, True):
    print(json.dumps(run.run_cell(torch, cell, seed=5, seconds=0.05, trace=trace,
                                  device=torch.device("cpu"))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    plain, traced = [json.loads(l) for l in out.stdout.strip().splitlines()[-2:]]
    assert plain["correct"] and set(plain["metrics"]) == {"setup_s", "mpix_per_s", "peak_gib"}
    # on the CPU the span opens and holds no device time: the opens read, the
    # device time (shares.span_ms) finds nothing and is left out of the line
    assert traced["correct"] and traced["metrics"]["wct_opens.tiny"]["value"] >= 1
    assert "wct_ms.tiny" not in traced["metrics"]
    after = _tree(bench)
    assert {k: after[k] for k in before} == before


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
    for cell in CASES:
        _run(cell)
    # compared by whole top-level names: the program's own name starts with the JAX package's
    assert "collaborative_distillation_tpu_torch" in sys.modules
    assert not run.forbidden_modules()
