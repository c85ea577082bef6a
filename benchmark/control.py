"""The readings that set a cell's limits, on the card, in one process.

    python3 benchmark/control.py --workload <cell> [--workload ...] \\
        --seeds <n> ... --control-seeds <n> ... --seconds <s> [--out <file>]

For each cell: the program's compared numbers on every ``--seeds`` seed
(their largest is a limit's lower reading), then the control's on every
``--control-seeds`` seed: the plain reference computed in the precision
next below the configuration's (``reference/precision.py``: TF32 for
float32, fp8 for bfloat16), put in the program's place (its smallest is
the upper reading). ``--fault`` plants one of
:data:`FAULTS` in the program for the program's seeds instead (a fault's
readings are further upper readings). Each run is ``run.run_cell`` with a
short window at the cell's own sizes. One JSON line a run on standard
output (and appended to ``--out``)."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

import run  # noqa: E402
from benchlib import manifest  # noqa: E402


@contextlib.contextmanager
def _patched(cls, name, make):
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def _trainer():
    from collaborative_distillation_tpu_torch.train.trainer import Trainer
    return Trainer


def _engine():
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    return WCTEngine


def _unchanged(step):
    def f(self, batch):
        import torch
        leaves = [t for leaf in self.params.values() for t in leaf.values()]
        before = [t.detach().clone() for t in leaves]
        out = step(self, batch)
        with torch.no_grad():
            for t, b in zip(leaves, before):
                t.copy_(b)
        return out
    return f


def _half_batch(step):
    return lambda self, batch: step(self, batch[: len(batch) // 2])


def _altered_device(call):
    def f(self, *a, **k):
        out = call(self, *a, **k).clone()
        out[..., 8:24, 8:24, :] = 1.0 - out[..., 8:24, 8:24, :]
        return out
    return f


def _altered_host(call):
    def f(self, *a, **k):
        out = call(self, *a, **k).copy()
        out[8:24, 8:24] = 255 - out[8:24, 8:24]
        return out
    return f


@contextlib.contextmanager
def _altered_answer():
    with _patched(_engine(), "stylize_device", _altered_device), \
            _patched(_engine(), "stylize", _altered_host):
        yield


# the faults a cell can have, planted in the program underneath its timed
# path: a training step that leaves its state unchanged, or that takes the
# mean over half its batch; a stylized image altered where it is produced
FAULTS = {
    "unchanged_state": lambda: _patched(_trainer(), "train_step", _unchanged),
    "half_batch": lambda: _patched(_trainer(), "train_step", _half_batch),
    "altered_answer": _altered_answer,
}


def readings(torch, cell, seeds, system, *, seconds, device, mix_overrides=None):
    """One line a seed: the run's correct, checks, end-to-end metrics."""
    for seed in seeds:
        out = run.run_cell(torch, cell, seed=seed, seconds=seconds, trace=False,
                           device=device, system=system, mix_overrides=mix_overrides)
        yield {"workload": cell.name, "system": system, "seed": seed,
               "correct": out["correct"], "checks": out["checks"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "device": out["device"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--out")
    args = p.parse_args(argv)
    cells = [manifest.load_cell(w, BENCH_DIR) for w in args.workload]
    run.setup_env(cells[0].root)
    import torch
    if not torch.cuda.is_available():
        print("control.py reads the card's numbers and needs CUDA", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    for cell in cells:
        for system, seeds in (("program", args.seeds), ("control", args.control_seeds)):
            planted = FAULTS[args.fault]() if args.fault and system == "program" \
                else contextlib.nullcontext()
            with planted:
                lines = list(readings(torch, cell, seeds, system, seconds=args.seconds,
                                      device=dev))
            for line in lines:
                line["fault"] = args.fault if system == "program" else None
                text = json.dumps(line)
                print(text, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
