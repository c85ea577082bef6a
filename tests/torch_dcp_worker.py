"""One process of tests/test_torch_checkpoint_dcp.py's two-process run: joins
the group through ``initialize_multihost`` over gloo, builds a data-parallel
wct_se trainer on two CPU replicas, takes one step on its rows of the batch,
saves the trainer's state collectively with ``save_checkpoint_dcp``, loads
it back into a fresh trainer with ``load_checkpoint_dcp``, and writes both
states.

    python tests/torch_dcp_worker.py HOST:PORT WORLD RANK INPUTS.npz CKPT_DIR OUT.npz

Imports the port only (no JAX)."""

import sys

import numpy as np
import torch

from collaborative_distillation_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
from collaborative_distillation_tpu_torch.train.trainer import TrainConfig, Trainer
from collaborative_distillation_tpu_torch.utils.checkpoint import (_flatten, load_checkpoint_dcp,
                                                                   save_checkpoint_dcp)
from torch_dp_worker import _tree


def main(address, world, rank, inputs, ckpt, out) -> int:
    torch.set_num_threads(1)
    with np.load(inputs) as z:
        batch, student, frozen = z["batch"], _tree(z, "student/"), _tree(z, "frozen/")
    world, rank = int(world), int(rank)
    initialize_multihost(address, world, rank, backend="gloo")
    try:
        def trainer():
            return Trainer(TrainConfig(mode="wct_se", stage=1, lr=1e-3), student, frozen,
                           mesh=make_mesh(data=2, devices=["cpu"] * 2))

        tr = trainer()
        rows = len(batch) // world
        tr.train_step(batch[rank * rows:(rank + 1) * rows])
        saved = tr.state(epoch=1, step=1)
        save_checkpoint_dcp(ckpt, saved)
        fresh = trainer()
        meta = fresh.load_state(load_checkpoint_dcp(ckpt, fresh.state()))
        np.savez(out, epoch=int(meta["epoch"]),
                 **{f"saved/{k}": v for k, v in _flatten(saved).items() if v.dtype.kind != "U"},
                 **{f"loaded/{k}": v for k, v in _flatten(fresh.state()).items()
                    if v.dtype.kind != "U"})
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
