"""Device-mesh helpers: a (data, space) grid of ``torch.device``s.

Mesh axes used by the framework:

* ``data``  -- independent images (or, in training, batch shards);
* ``space`` -- spatial tiling of the image H axis for ultra-resolution
  inference: the rows of one image are cut over the devices of one mesh row,
  which exchange halo rows (:mod:`.spatial`).

One process drives every device of the mesh. A device may stand in the grid
more than once: ``devices=["cuda:0"] * 4`` puts four row shards on one card,
``["cpu"] * 4`` runs the sharded path on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Mesh", "order_devices_for_mesh", "make_mesh"]


@dataclass(frozen=True)
class Mesh:
    """``devices[i][j]``: the device at ``data`` coordinate ``i`` and
    ``space`` coordinate ``j``."""

    devices: tuple[tuple[torch.device, ...], ...]

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
    """
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        need = data * space
        if need > len(devices):
            raise ValueError(
                f"mesh {data}x{space} needs {need} devices, have {len(devices)}")
        return Mesh(_grid(devices[:need], data, space))
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(order_devices_for_mesh(devices, data, space))
