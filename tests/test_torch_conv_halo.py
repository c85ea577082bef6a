"""The conv3x3 kernel's halo rows (``conv3x3_plain(..., top=, bot=)``, the
per-conv sharded path's conv) against the reference's
``parallel/spatial.py:conv3x3_halo`` under ``shard_map`` on the 4-device
CPU mesh, and against the rows of the unsharded conv.

The plain version runs here: on the card the kernel is held to it (the
``gpu`` tests, ``chip_smoke.py`` phase 2). Tolerance rtol = atol = 1e-5:
float32 sums of up to 9 * Cin products in XLA's and PyTorch's orders.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from collaborative_distillation_tpu.ops import conv as jconv
from collaborative_distillation_tpu.parallel import spatial as jsp
from collaborative_distillation_tpu.parallel.mesh import make_mesh as jax_make_mesh

import torch

from collaborative_distillation_tpu_torch.ops import conv as tconv
from collaborative_distillation_tpu_torch.ops.cuda import conv as kconv
from collaborative_distillation_tpu_torch.ops.cuda import peer
from collaborative_distillation_tpu_torch.parallel import spatial as tsp

TOL = dict(rtol=1e-5, atol=1e-5)
SPEC = P(None, "space", None, None)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(space=4, data=1)


def _inputs(rng, n, h, w, cin, cout):
    x = rng.random((n, h, w, cin), dtype=np.float32) - 0.5
    wt = ((rng.random((3, 3, cin, cout), dtype=np.float32) - 0.5)
          * np.float32(2 / (9 * cin) ** 0.5))
    b = rng.random(cout, dtype=np.float32) - 0.5
    return x, wt, b


def _split(x, rows):
    t = torch.from_numpy(x)
    return [p.contiguous() for p in t.split(list(rows), dim=1)]


def _sharded(x, wt, b, rows, relu):
    xs = _split(x, rows)
    k = len(xs)
    ys = tsp.conv3x3_halo(xs, [torch.from_numpy(wt)] * k, [torch.from_numpy(b)] * k,
                          relu=relu)
    return torch.cat(ys, dim=1).numpy()


# (N, W, Cin, Cout, relu, rows per shard): equal shards, as shard_map cuts them
EQUAL = [(1, 6, 5, 7, True, 4), (2, 5, 4, 3, False, 3), (1, 6, 3, 4, True, 1),
         (2, 9, 8, 8, True, 2), (2, 1, 6, 5, False, 2), (1, 7, 16, 3, True, 5)]


@pytest.mark.parametrize("case", EQUAL, ids=str)
def test_halo_conv_equals_reference_conv3x3_halo_under_shard_map(rng, jax_mesh, case):
    """Four equal shards: each shard's conv with its neighbours' rows (the
    shard's own reflection at the global edges, or for one-row shards the
    opposite neighbour's) equals the reference's per-shard function."""
    n, w, cin, cout, relu, h = case
    x, wt, b = _inputs(rng, n, 4 * h, w, cin, cout)
    got = _sharded(x, wt, b, [h] * 4, relu)
    want = shard_map(lambda xs: jsp.conv3x3_halo(xs, jnp.asarray(wt), jnp.asarray(b), "space",
                                                 relu=relu),
                     mesh=jax_mesh, in_specs=SPEC, out_specs=SPEC)(jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# (N, W, Cin, Cout, relu, shard rows): unequal heights (the engine's whole
# 16-row blocks, the remainder on the last shards), one-row shards, two shards
UNEQUAL = [(1, 6, 5, 7, True, (5, 3, 1, 7)), (2, 5, 4, 3, False, (1, 6)),
           (1, 9, 16, 16, True, (2, 2, 2, 4)), (2, 4, 3, 24, True, (1, 1, 1, 2)),
           (1, 3, 7, 5, False, (3, 3, 3, 5)), (2, 8, 8, 3, True, (6, 1, 1))]


@pytest.mark.parametrize("case", UNEQUAL, ids=str)
def test_halo_conv_rows_equal_the_unsharded_conv(rng, case):
    """Shards of unequal heights put together equal the whole map's conv,
    the reference's and the port's plain one."""
    n, w, cin, cout, relu, rows = case
    x, wt, b = _inputs(rng, n, sum(rows), w, cin, cout)
    got = _sharded(x, wt, b, rows, relu)
    whole = kconv.conv3x3_plain(torch.from_numpy(x), torch.from_numpy(wt),
                                torch.from_numpy(b), relu).numpy()
    np.testing.assert_allclose(got, whole, **TOL)
    want = jconv.conv3x3(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), relu=relu)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("side", ["top", "bot", "both", "none"])
@pytest.mark.parametrize("h", [1, 2, 5])
def test_halo_rows_stand_above_and_below_and_none_reflects(rng, side, h):
    """One shard with explicit rows: a given row is the map's row -1 (or H),
    columns reflected inside it as the reference's W-only pad of the
    concatenated map; a ``None`` side is the shard's own reflection row
    (row 1 or H-2; a one-row shard reflects onto itself); without rows the
    conv is the plain one, bit for bit."""
    n, w, cin, cout = 2, 5, 3, 4
    x, wt, b = _inputs(rng, n, h, w, cin, cout)
    up = rng.random((n, 1, w, cin), dtype=np.float32)
    down = rng.random((n, 1, w, cin), dtype=np.float32)
    top = torch.from_numpy(up) if side in ("top", "both") else None
    bot = torch.from_numpy(down) if side in ("bot", "both") else None
    got = kconv.conv3x3_plain(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
                              True, top=top, bot=bot).numpy()
    own_top, own_bot = (x[:, 1:2], x[:, -2:-1]) if h >= 2 else (x, x)
    ext = np.concatenate([up if top is not None else own_top, x,
                          down if bot is not None else own_bot], axis=1)
    ext = np.pad(ext, ((0, 0), (0, 0), (1, 1), (0, 0)), mode="reflect")
    want = jax.nn.relu(jconv.conv2d(jnp.asarray(ext), jnp.asarray(wt), jnp.asarray(b)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if side == "none":
        plain = kconv.conv3x3_plain(torch.from_numpy(x), torch.from_numpy(wt),
                                    torch.from_numpy(b), True)
        assert torch.equal(torch.from_numpy(got), plain)


def test_halo_rows_may_be_views_with_a_batch_stride(rng):
    """The path passes views: a neighbour's last row (batch stride H'W C)
    and first row; the same values copied give the same output."""
    up, x, down = (rng.random((2, h, 6, 4), dtype=np.float32) for h in (7, 3, 2))
    wt, b = (torch.from_numpy(a) for a in _inputs(rng, 1, 1, 6, 4, 8)[1:])
    tu, tx, td = (torch.from_numpy(a) for a in (up, x, down))
    views = (tu[:, -1:], td[:, :1])
    assert views[0].stride(0) == 7 * 6 * 4 and not views[0].is_contiguous()
    got = kconv.conv3x3_plain(tx, wt, b, False, top=views[0], bot=views[1])
    copies = kconv.conv3x3_plain(tx, wt, b, False, top=views[0].contiguous(),
                                 bot=views[1].contiguous())
    assert torch.equal(got, copies)


def test_halo_rows_are_checked_and_refused_under_autograd(rng):
    x = torch.from_numpy(_inputs(rng, 2, 4, 5, 3, 3)[0])
    wt, b = torch.zeros(3, 3, 3, 2), torch.zeros(2)
    for bad in (x[:, :2], x[:1, :1], x[:, :1, :4], x[:, :1].double()):
        with pytest.raises(ValueError):
            kconv.conv3x3_plain(x, wt, b, True, top=bad)
    with pytest.raises(ValueError, match="contiguous within each image"):
        kconv.conv3x3_plain(x, wt, b, True, bot=x.transpose(2, 3).contiguous()
                            .transpose(2, 3)[:, :1])
    with pytest.raises(ValueError, match="inference only"):
        tconv.conv3x3(x, wt.requires_grad_(), b, bot=x[:, :1])
    with torch.no_grad():   # not recording: the halo conv runs
        assert tconv.conv3x3(x, wt, b, bot=x[:, :1]).shape == (2, 4, 5, 2)


def test_exchange_pairs_are_views_of_the_neighbours():
    """No row is copied: every halo row shares its neighbour's storage."""
    xs = [torch.rand(1, h, 4, 3) for h in (3, 1, 2)]
    pairs = tsp.halo_rows(xs)
    assert pairs[0][0] is None and pairs[2][1] is None
    assert pairs[0][1].data_ptr() == xs[1].data_ptr()
    assert pairs[1][0].data_ptr() == xs[0][:, -1:].data_ptr()
    assert pairs[1][1].data_ptr() == xs[2].data_ptr()
    assert pairs[2][0].data_ptr() == xs[1].data_ptr()


class _Stream:
    def __init__(self, card, log):
        self.device, self.log = torch.device("cuda", card), log

    def wait_event(self, event):
        self.log.append(("wait", self.device.index, event.at))


def _layer_log(monkeypatch, step: bool) -> list:
    """What ``peer`` queues for one layer of three shards on cards 0-2, each
    reading its neighbours' boundary rows in place and launching between
    ``reachable`` and ``release``: ("record", card, at), ("wait", card, at of
    the event), ("launch", card)."""
    log = []
    streams = [_Stream(d, log) for d in range(3)]

    class Event:
        def record(self, stream):
            self.at = len(log)
            log.append(("record", stream.device.index, self.at))

    class Rows:
        def __init__(self, card):
            self.device = torch.device("cuda", card)

        def record_stream(self, stream):
            pass

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: streams[torch.device(d).index])
    monkeypatch.setattr(peer, "_peer_access", lambda dev, other: True)
    devices = [s.device for s in streams]

    def layer():
        for d, s in enumerate(streams):
            rows = [peer.reachable(None if e not in (0, 1, 2) else Rows(e), s.device, s)
                    for e in (d - 1, d + 1)]
            log.append(("launch", d))
            for r in rows:
                peer.release(r, s.device, s)

    if step:
        with peer.one_step(devices):
            layer()
    else:
        layer()
    return log


def test_one_step_takes_a_layers_reads_before_its_launches(monkeypatch):
    """Inside ``one_step`` a shard's launch waits for its neighbours' work
    queued before the layer, never for their launches of the layer, and each
    producer waits for its readers only once the whole layer is queued. Read
    one at a time, each read is ordered after everything on the neighbour's
    card, its launch of the layer included: the chain ``one_step`` breaks."""
    log = _layer_log(monkeypatch, step=True)
    launches = [i for i, e in enumerate(log) if e[0] == "launch"]
    records = {e[2]: e for e in log if e[0] == "record"}
    waits = [(i, e) for i, e in enumerate(log) if e[0] == "wait"]
    before = [(i, e) for i, e in waits if i < launches[-1]]
    after = [(i, e) for i, e in waits if i > launches[-1]]
    # the reads: four, each on an event recorded before the first launch
    assert len(before) == 4 and all(e[2] < launches[0] for _, e in before)
    assert {(e[1], records[e[2]][1]) for _, e in before} == {(0, 1), (1, 0), (1, 2), (2, 1)}
    # the releases: one for each read, the producer waiting for its reader
    assert len(after) == 4
    assert {(e[1], records[e[2]][1]) for _, e in after} == {(1, 0), (0, 1), (2, 1), (1, 2)}
    assert all(records[e[2]][2] > launches[-1] for _, e in after)
    chain = _layer_log(monkeypatch, step=False)
    first = chain.index(("launch", 0))
    card1 = [e for e in chain if e[0] == "wait" and e[1] == 1]
    assert any(chain[e[2]][1] == 0 and e[2] > first for e in card1)
