"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name (``benchlib/manifest.py``). The program
under test is ``collaborative_distillation_tpu_torch`` on one NVIDIA card;
without the cards the cell asks for the run exits 2 and prints no result.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled part of the window. Every run checks the
window's outputs against the plain reference (``reference/``) and prints
each number compared beside its limit: as the last lines of standard
error, and under ``checks``, the last key of the result, the JSON object
that is the last line of standard output."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# the benchmark's own modules, then the checkout's root, where the program is
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

from benchlib import checks, manifest, peaks  # noqa: E402

# top-level module names the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "collaborative_distillation_tpu")


@dataclasses.dataclass
class Ctx:
    torch: object
    cell: manifest.Cell
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    system: str = "program"      # or "control": the reference a precision below
    t_start: float = T_START
    marks: dict = dataclasses.field(default_factory=dict)

    def mark(self, name: str) -> None:
        """Seconds from process start to a point of set-up, for ``info``."""
        self.marks[name] = time.perf_counter() - self.t_start


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def setup_env(root: str) -> None:
    """Caches inside the checkout, at fixed paths; no JAX behind a library."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton_cache")
    os.environ["USE_FLAX"] = "0"


def run_cell(torch, cell, *, seed: int, seconds: float, trace: bool, device,
             system: str = "program", mix_overrides: dict | None = None) -> dict:
    """Drive one run and return its result object (without printing). The
    entry the tests use, on the CPU, at their own sizes. A mix's
    ``host_threads`` fixes torch's intra-op threads on the host for the run:
    a host-paced cell's parallel copies wait for their slowest thread, and
    the card's host shares its cores."""
    tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    ctx = Ctx(torch=torch, cell=cell, mix={**cell.mix, **(mix_overrides or {})}, seed=seed,
              seconds=seconds, trace=trace, device=device, system=system)
    ctx.mark("torch")
    threads = torch.get_num_threads()
    if ctx.mix.get("host_threads"):
        torch.set_num_threads(ctx.mix["host_threads"])
    try:
        rec = cell.driver().run(ctx)
    finally:
        torch.set_num_threads(threads)
    limits = cell.workload["limits"]
    judged = [checks.judge(s, limits) for s in rec["samples"]]
    failed = sum(not ok for ok, _ in judged)
    worst = {name: max(s[name] for s in rec["samples"]) for name in limits} \
        if rec["samples"] else {}
    _, rows = checks.judge(worst, limits)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": cell.entry["chips"], "memory_peak_bytes": rec["peak_bytes"]}
    metrics = {}
    if trace:
        tr = rec["trace"]
        if tr is not None:
            dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        r = {**rec, "peaks": peaks.peaks(kind)}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": rec["e2e"][m["name"]], "unit": m["unit"]}
    if device.type == "cuda":
        dev["power_limit_w"] = peaks.power_limit_w()
    out = {"correct": bool(rec["samples"]) and failed == 0, "attempted": rec["attempted"],
           "failed": failed, "metrics": metrics, "device": dev}
    if trace and rec["trace"] is not None:
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["info"] = {"setup_s": rec["e2e"]["setup_s"], "setup_marks_s": ctx.marks,
                   **rec.get("info", {})}
    out["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in rows}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    cell = manifest.load_cell(args.workload, BENCH_DIR)
    setup_env(cell.root)
    import torch
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    out = run_cell(torch, cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   device=torch.device("cuda:0"))
    bad = forbidden_modules()
    if bad:
        log(f"the process holds {', '.join(bad)} after the window: no result")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
