"""The port's device mesh (``parallel/mesh.py``): the cases of
tests/test_mesh.py that apply to a single-process grid of ``torch.device``s,
each beside the reference's function of the same name.
"""

from dataclasses import dataclass

import numpy as np
import pytest

import jax

from collaborative_distillation_tpu.parallel import mesh as jmesh

import torch

from collaborative_distillation_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclass(frozen=True)
class FakeDev:
    """Carries what both packages sort by."""
    id: int
    process_index: int = 0
    type: str = "cuda"

    @property
    def index(self):
        return self.id


def test_order_is_row_major_and_deterministic_like_the_reference():
    devs = [FakeDev(id=i) for i in range(8)]
    for data, space in [(2, 4), (1, 4), (4, 2), (1, 1)]:
        want = jmesh.order_devices_for_mesh(devs, data=data, space=space)
        for given in (devs, devs[::-1]):
            got = tmesh.order_devices_for_mesh(given, data=data, space=space)
            assert np.array(got, dtype=object).shape == (data, space)
            assert [[d.id for d in row] for row in got] == \
                [[d.id for d in row] for row in want]


def test_too_few_devices_raises_the_reference_error():
    devs = [FakeDev(id=0)]
    for mod in (jmesh, tmesh):
        with pytest.raises(ValueError, match="needs 4 devices, have 1"):
            mod.order_devices_for_mesh(devs, data=2, space=2)
    with pytest.raises(ValueError, match="mesh 1x4 needs 4 devices, have 2"):
        tmesh.make_mesh(space=4, devices=["cpu", "cpu"])


def test_explicit_list_is_taken_verbatim_and_may_repeat_a_device():
    mesh = tmesh.make_mesh(data=2, space=4, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "space": 4}
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
    # the caller's order, not index order, and surplus devices unused; the
    # reference honours an explicit list the same way
    given = ["cuda:3", "cuda:1", "cuda:1", "cuda:0", "cuda:7"]
    mesh = tmesh.make_mesh(data=2, space=2, devices=given)
    assert [[str(d) for d in row] for row in mesh.devices] == \
        [["cuda:3", "cuda:1"], ["cuda:1", "cuda:0"]]
    jdevs = jax.devices()
    jm = jmesh.make_mesh(data=2, space=2, devices=[jdevs[3], jdevs[1], jdevs[2], jdevs[0]])
    assert [[d.id for d in row] for row in jm.devices] == [[3, 1], [2, 0]]


def test_default_mesh_never_picks_the_cpu():
    """Without a device list the mesh takes CUDA devices, one per cell; here
    there are none, so even a 1x1 mesh raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(ValueError, match="needs 1 devices, have 0"):
        tmesh.make_mesh()
    with pytest.raises(ValueError, match="needs 4 devices, have 0"):
        tmesh.make_mesh(space=4)
