"""BENCHMARK.json and the files of one cell, found by name.

A cell ``<config>.<traffic>`` is ``workloads/<cell>.json``; its
configuration ``configs/<config>.json``; its traffic mix
``mixes/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``;
each per-layer metric ``metrics/<metric>.py``. Adding any of them is adding
a file."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A Python file loaded by its path (metric files have dots in their
    names, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict        # the cell's entry in BENCHMARK.json
    workload: dict     # workloads/<cell>.json
    config: dict       # configs/<config>.json
    mix: dict          # mixes/<traffic>.json
    end_to_end: list   # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list    # and its per-layer metrics
    bench_dir: str
    root: str

    def driver(self):
        return load_module(os.path.join(self.bench_dir, "drivers", self.mix["driver"] + ".py"),
                           "bench_driver_" + self.mix["driver"])

    def reader(self, metric: str):
        return load_module(os.path.join(self.bench_dir, "metrics", metric + ".py"),
                           "bench_metric_" + metric.replace(".", "_"))

    def other_config(self, name: str) -> dict:
        return load_json(os.path.join(self.bench_dir, "configs", name + ".json"))


def load_cell(name: str, bench_dir: str = BENCH_DIR) -> Cell:
    root = os.path.dirname(bench_dir)
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    workload = load_json(os.path.join(bench_dir, "workloads", name + ".json"))
    if (workload["config"], workload["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names {workload['config']}.{workload['traffic']}, "
                         f"BENCHMARK.json {entry['config']}.{entry['traffic']}")
    return Cell(
        name=name, entry=entry, workload=workload,
        config=load_json(os.path.join(bench_dir, "configs", entry["config"] + ".json")),
        mix=load_json(os.path.join(bench_dir, "mixes", entry["traffic"] + ".json")),
        end_to_end=[m for m in manifest["end_to_end"] if applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, name)],
        bench_dir=bench_dir, root=root)
