"""BENCHMARK.json against the benchmark's contract, and each of its names
found from a file of its own."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
MANIFEST = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
PORT = "collaborative_distillation_tpu_torch"


def test_top_level_keys_and_command():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()), ids=lambda x: str(x)[:40])
def test_names_units_and_text(group, entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_are_unique_and_consistent():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
        layers.setdefault(m["layer"], m["layer"])
    assert chips_fit(MANIFEST["workloads"])
    for w in MANIFEST["workloads"]:
        assert w["config"] in {c["name"] for c in MANIFEST["configs"]}
        reported = [m for m in MANIFEST["end_to_end"]
                    if "workloads" not in m or w["name"] in m["workloads"]]
        assert any(m["name"] == "setup_s" for m in reported) and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in MANIFEST["per_layer"])


def chips_fit(workloads) -> bool:
    """Each cell on 1 or 4 chips, and at most a quarter of the cells, rounded
    down, on 4 (one always may)."""
    four = sum(w["chips"] == 4 for w in workloads)
    return (all(w["chips"] in (1, 4) for w in workloads)
            and four <= max(1, len(workloads) // 4))


@pytest.mark.parametrize("chips,fit", [
    ([1], True), ([4], True), ([1, 1, 1, 4], True), ([1] * 6 + [4, 4], True),
    ([1, 1, 4, 4], False), ([1] * 5 + [4, 4, 4], False), ([1, 2], False), ([8], False)])
def test_chips_rule(chips, fit):
    assert chips_fit([{"chips": n} for n in chips]) is fit


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_found_from_its_files(cell):
    from benchlib import manifest
    c = manifest.load_cell(cell, BENCH_DIR)
    assert c.workload["why"] == c.entry["why"]
    assert os.path.exists(os.path.join(BENCH_DIR, "drivers", c.mix["driver"] + ".py"))
    assert set(c.workload["limits"]) and all(v > 0 for v in c.workload["limits"].values())
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)


# keys of a configuration that are widths, which ``reduced`` may never name
WIDTHS = re.compile(r"(^|_)widths?$|_dim$|_rank$|_size$|^hidden|^intermediate|latent|proj|"
                    r"expan|heads?$|experts_per_tok")


@pytest.mark.parametrize("cfg", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    """The file holds the configuration as run: its source and its cuts as
    BENCHMARK.json names them (no width among them), a precision whose
    control is defined (``reference/precision.py``), its own file."""
    from reference import precision
    path = os.path.join(ROOT, cfg["file"])
    assert cfg["file"].startswith("benchmark/")
    data = json.load(open(path))
    assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16 and not [k for k in cfg["reduced"] if WIDTHS.search(k)]
    assert data["dtype"] in precision.DTYPES and isinstance(data["tf32"], bool)
    assert precision.control(data) in precision.ROUND
    assert len([c for c in MANIFEST["configs"] if c["file"] == cfg["file"]]) == 1


def test_file_names_use_name_characters():
    for dirpath, _, files in os.walk(BENCH_DIR):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            assert re.match(r"^[A-Za-z0-9_.-]+$", f), f


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH_DIR, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                assert mod.split(".")[0] not in (PORT, "collaborative_distillation_tpu", "jax")
    code = ("import sys; sys.path[:0] = [%r]; import reference.cascade, reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % BENCH_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=BENCH_DIR)
    loaded = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert not {PORT, "collaborative_distillation_tpu", "jax", "jaxlib"} & set(loaded)
