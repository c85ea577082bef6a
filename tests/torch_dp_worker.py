"""One process of tests/test_torch_train_dp.py's two-process run: joins the
group through ``initialize_multihost`` over gloo, builds a data-parallel
trainer on two CPU replicas, takes one step on its rows of the global
batch, and writes its losses, rec, root gradient and masters.

    python tests/torch_dp_worker.py HOST:PORT WORLD RANK INPUTS.npz OUT.npz MODE LR

Imports the port only (no JAX)."""

import sys

import numpy as np
import torch

from collaborative_distillation_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
from collaborative_distillation_tpu_torch.train.trainer import TrainConfig, Trainer


def _tree(z, prefix):
    out = {}
    for key in z.files:
        if key.startswith(prefix):
            *path, name, kind = key[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node.setdefault(name, {})[kind] = z[key]
    return out


def main(address, world, rank, inputs, out, mode, lr) -> int:
    torch.set_num_threads(1)
    with np.load(inputs) as z:
        batch, student, frozen = z["batch"], _tree(z, "student/"), _tree(z, "frozen/")
    initialize_multihost(address, int(world), int(rank), backend="gloo")
    try:
        trainer = Trainer(TrainConfig(mode=mode, stage=2, lr=float(lr)), student, frozen,
                          mesh=make_mesh(data=2, devices=["cpu"] * 2))
        rows = len(batch) // int(world)
        losses, rec = trainer.train_step(batch[int(rank) * rows:(int(rank) + 1) * rows])
        root = [t for leaf in trainer.params.values() for t in leaf.values()]
        same = all(torch.equal(t, r) for rep in trainer.replicas[1:]
                   for t, r in zip([t for leaf in rep.params().values() for t in leaf.values()],
                                   root))
        np.savez(out, rec=rec.numpy(), replicas_equal=same,
                 **{f"loss/{k}": v.numpy() for k, v in losses.items()},
                 **{f"{what}/{n}/{k}": (t.grad if what == "grad" else t).detach().numpy()
                    for what in ("grad", "params")
                    for n, leaf in trainer.params.items() for k, t in leaf.items()})
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
