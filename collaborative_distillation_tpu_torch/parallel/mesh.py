"""Device-mesh helpers: a (data, space) grid of ``torch.device``s.

Mesh axes used by the framework:

* ``data``  -- independent images (or, in training, batch shards);
* ``space`` -- spatial tiling of the image H axis for ultra-resolution
  inference: the rows of one image are cut over the devices of one mesh row,
  which exchange halo rows (:mod:`.spatial`).

One process drives every device of its mesh. A device may stand in the grid
more than once: ``devices=["cuda:0"] * 4`` puts four row shards on one card,
``["cpu"] * 4`` runs the sharded path on the CPU.

Several processes: call :func:`initialize_multihost` once in each, then
build each process's mesh over its own local devices; :func:`make_mesh`
records the group's size and this process's rank in the mesh. In training
the processes are the outer part of the ``data`` axis: each process is
handed its own rows of the global batch (``train/trainer.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

__all__ = ["Mesh", "initialize_multihost", "process_group", "order_devices_for_mesh",
           "make_mesh"]


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         backend: str | None = None) -> None:
    """Join a process group (one call per process, before the first step).

    A thin wrapper over ``torch.distributed.init_process_group``. The
    arguments win over the environment; without them it reads PyTorch's
    standard variables: ``MASTER_ADDR`` and ``MASTER_PORT`` (``env://``),
    ``WORLD_SIZE`` and ``RANK``. ``coordinator_address`` is ``host:port`` of
    process 0. ``backend`` defaults to NCCL where CUDA is available, else
    gloo; a CPU run on a machine with a card passes ``backend="gloo"``.
    """
    kwargs = {"backend": backend or ("nccl" if torch.cuda.is_available() else "gloo"),
              "init_method": (f"tcp://{coordinator_address}" if coordinator_address
                              else "env://")}
    for key, arg, env in (("world_size", num_processes, "WORLD_SIZE"),
                          ("rank", process_id, "RANK")):
        if arg is not None or os.environ.get(env):
            kwargs[key] = arg if arg is not None else int(os.environ[env])
    torch.distributed.init_process_group(**kwargs)


def process_group() -> tuple[int, int]:
    """(world size, rank) of the ``torch.distributed`` group, (1, 0) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclass(frozen=True)
class Mesh:
    """``devices[i][j]``: the device at ``data`` coordinate ``i`` and
    ``space`` coordinate ``j``; ``processes`` and ``rank``: the process
    group this process's ``data`` slots are the part ``rank`` of (1 and 0
    without a group)."""

    devices: tuple[tuple[torch.device, ...], ...]
    processes: int = 1
    rank: int = 0

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "space": len(self.devices[0])}


def _grid(devices, data: int, space: int):
    return tuple(tuple(devices[i * space:(i + 1) * space]) for i in range(data))


def order_devices_for_mesh(devices, data: int, space: int):
    """Arrange devices into a (data, space) grid, ``space`` the
    fastest-varying axis, so that the ``space`` neighbours, who exchange
    halos at every stage, are the devices next to each other in index order.

    Pure function over device-like objects (needs ``.type`` and ``.index``):
    sorted by these, whatever order they came in.
    """
    need = data * space
    if need > len(devices):
        raise ValueError(
            f"mesh {data}x{space} needs {need} devices, have {len(devices)}")
    ordered = sorted(devices, key=lambda d: (d.type, d.index or 0))[:need]
    return _grid(ordered, data, space)


def make_mesh(*, data: int = 1, space: int = 1, devices=None) -> Mesh:
    """Build a (data, space) mesh.

    An explicit ``devices`` list is an explicit layout: it is taken verbatim,
    in the caller's order, and may name a device more than once. Without it
    the mesh takes the visible CUDA devices in index order and raises when
    there are fewer than ``data * space``; it never picks the CPU, and never
    doubles up on a device, on its own. Surplus devices are left unused.
    The mesh records the ``torch.distributed`` group joined by then
    (:func:`process_group`).
    """
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        need = data * space
        if need > len(devices):
            raise ValueError(
                f"mesh {data}x{space} needs {need} devices, have {len(devices)}")
        grid = _grid(devices[:need], data, space)
    else:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        grid = order_devices_for_mesh(devices, data, space)
    return Mesh(grid, *process_group())
