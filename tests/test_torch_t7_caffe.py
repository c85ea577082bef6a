"""The PyTorch port's legacy-format readers against the reference's, on the
CPU: ``utils/t7reader.py`` (Torch7 ``.t7``) and ``utils/caffeproto.py``
(Caffe ``.caffemodel``).

* ``.t7``: files from ``tests/t7_synth.py`` give bit-equal conv layers
  through both readers; the fuzz cases of ``tests/test_t7.py`` (truncations,
  byte flips with its seed, hostile tensor geometry, the stride-0 memory
  bomb, CUDA storages, pre-versioning headers, recursive tables) end the
  same way in both: the same exception type, or equal results.
* Caffe: ``write_caffemodel`` and ``_vgg_layers`` from
  ``tests/test_caffe.py`` give identical layers through both readers in
  every wire layout, and the hostile inputs of its tests raise alike.
"""

import struct

import numpy as np
import pytest

from collaborative_distillation_tpu.utils import caffeproto as jax_caffeproto
from collaborative_distillation_tpu.utils import t7reader as jax_t7

from collaborative_distillation_tpu_torch.utils import caffeproto, t7reader
from t7_synth import Writer, write_sequential_t7, write_teacher_t7
from test_caffe import _blob, _key, _layer, _len_field, _varint, _vgg_layers, write_caffemodel
from test_t7 import _seq_bytes

ERRORS = (EOFError, ValueError, KeyError, TypeError, AttributeError, UnicodeDecodeError,
          RecursionError)


def _same(a, b):
    """Deep equality of two readers' results: numpy leaves bit-equal."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if type(a).__name__ == "T7Object":
        return (type(b).__name__ == "T7Object" and a.torch_type == b.torch_type
                and _same(a.attrs, b.attrs))
    return a == b


def _outcome(fn, path):
    try:
        return "ok", fn(path)
    except ERRORS as e:
        return type(e).__name__, None


def _both(tmp_path, data, fn="read_t7_conv_layers", name="fuzz.t7"):
    p = tmp_path / name
    p.write_bytes(data)
    got = _outcome(getattr(t7reader, fn), str(p))
    want = _outcome(getattr(jax_t7, fn), str(p))
    assert got[0] == want[0], (got[0], want[0])
    if got[0] == "ok":
        if fn == "load_t7" and isinstance(want[1], dict) and want[1].get("self") is want[1]:
            assert got[1]["self"] is got[1]
        else:
            assert _same(got[1], want[1])
    return got[0]


def test_teacher_t7_layers_bit_equal(tmp_path, rng):
    """A teacher-shaped stage-2 encoder and decoder (convs at the reference
    files' flat indices) read to bit-equal layers; a flattened 2-D weight
    reshapes alike."""
    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    from collaborative_distillation_tpu_torch.utils.torch_convert import (
        T7_DECODER_LAYER_INDEX, T7_ENCODER_LAYER_INDEX)
    for kind, spec, index in (("e", encoder_spec("original", 2), T7_ENCODER_LAYER_INDEX[2]),
                              ("d", decoder_spec("original", 2), T7_DECODER_LAYER_INDEX[2])):
        params = {n: {"w": rng.standard_normal(ws), "b": rng.standard_normal(bs)}
                  for n, (ws, bs) in spec.param_shapes().items()}
        if kind == "e":
            params["conv0"] = {"w": rng.standard_normal((1, 1, 3, 3)),
                               "b": rng.standard_normal(3)}
        path = str(tmp_path / f"{kind}2.t7")
        write_teacher_t7(path, index, params)
        got, want = t7reader.read_t7_conv_layers(path), jax_t7.read_t7_conv_layers(path)
        assert sorted(got) == sorted(want) == sorted(index)
        assert _same(got, want)
    flat = str(tmp_path / "flat.t7")
    write_sequential_t7(flat, [("module", "nn.SpatialConvolution", {
        "weight": rng.standard_normal((4, 27)), "bias": rng.standard_normal(4),
        "kH": 3, "kW": 3, "nInputPlane": 3})])
    assert t7reader.read_t7_conv_layers(flat)[0][0].shape == (4, 3, 3, 3)
    assert _same(t7reader.read_t7_conv_layers(flat), jax_t7.read_t7_conv_layers(flat))
    assert _same(t7reader.load_t7(flat), jax_t7.load_t7(flat))


def test_t7_truncations_and_byteflips_end_alike(tmp_path, rng):
    """tests/test_t7.py's truncation and byte-flip fuzz, its seed, through both."""
    data = _seq_bytes(rng)
    outcomes = set()
    for cut in list(range(0, min(len(data), 200))) + list(range(200, len(data), 97)):
        outcomes.add(_both(tmp_path, data[:cut]))
    for _ in range(500):
        mutated = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            mutated[int(rng.integers(0, len(mutated)))] = int(rng.integers(0, 256))
        outcomes.add(_both(tmp_path, bytes(mutated)))
    assert "EOFError" in outcomes and "ok" in outcomes


def _tensor_bytes(sizes, strides, offset1, n_storage, cls="torch.DoubleTensor",
                  storage="torch.DoubleStorage", payload=None):
    wr = Writer()
    wr.buf += struct.pack("<i", 4) + struct.pack("<i", 1)
    wr.string("V 1")
    wr.string(cls)
    wr.buf += struct.pack("<i", len(sizes))
    for s in sizes:
        wr.buf += struct.pack("<q", s)
    for s in strides:
        wr.buf += struct.pack("<q", s)
    wr.buf += struct.pack("<q", offset1)
    wr.buf += struct.pack("<i", 4) + struct.pack("<i", 2)
    wr.string("V 1")
    wr.string(storage)
    wr.buf += struct.pack("<q", n_storage)
    wr.buf += payload if payload is not None else b"\x00" * (8 * n_storage)
    return bytes(wr.buf)


HOSTILE = {
    "stride escapes": _tensor_bytes([4, 4], [1000000, 1], 1, 16),
    "offset escapes": _tensor_bytes([4, 4], [4, 1], 1 << 40, 16),
    "2^40 elements": _tensor_bytes([1 << 20, 1 << 20], [0, 0], 1, 16),
    "negative size": _tensor_bytes([-4, 4], [4, 1], 1, 16),
    "backward stride escapes": _tensor_bytes([4, 4], [-8, 1], 1, 16),
    "ndim 2^31-1": (struct.pack("<i", 4) + struct.pack("<i", 1) + struct.pack("<i", 3) + b"V 1"
                    + struct.pack("<i", 19) + b"torch.DoubleTensor"
                    + struct.pack("<i", 0x7FFFFFFF)),
    "stride-0 bomb": _tensor_bytes([1 << 28], [0], 1, 1),
}


@pytest.mark.parametrize("case", sorted(HOSTILE))
def test_t7_hostile_geometry_raises_alike(tmp_path, case):
    outcome = _both(tmp_path, HOSTILE[case], fn="load_t7")
    assert outcome in ("ValueError", "EOFError"), outcome
    if case == "stride-0 bomb":
        p = tmp_path / "fuzz.t7"
        with pytest.raises(ValueError, match="byte cap"):
            t7reader.load_t7(str(p))


def test_t7_cuda_storage_pre_versioning_and_recursion(tmp_path, rng):
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    cuda = _tensor_bytes(list(w.shape), [s // 4 for s in w.strides], 1, w.size,
                         cls="torch.CudaTensor", storage="torch.CudaStorage",
                         payload=w.ravel().tobytes())
    assert _both(tmp_path, cuda, fn="load_t7") == "ok"
    np.testing.assert_array_equal(t7reader.load_t7(str(tmp_path / "fuzz.t7")), w)
    w2 = rng.standard_normal((2, 3))
    prev = bytearray(struct.pack("<i", 4) + struct.pack("<i", 1))
    prev += struct.pack("<i", 18) + b"torch.DoubleTensor" + struct.pack("<i", 2)
    prev += struct.pack("<2q", *w2.shape) + struct.pack("<2q", 3, 1) + struct.pack("<q", 1)
    prev += struct.pack("<i", 4) + struct.pack("<i", 2)
    prev += struct.pack("<i", 19) + b"torch.DoubleStorage" + struct.pack("<q", w2.size)
    prev += w2.ravel().tobytes()
    assert _both(tmp_path, bytes(prev), fn="load_t7") == "ok"
    cycle = (struct.pack("<3i", 3, 1, 1) + struct.pack("<ii", 2, 4) + b"self"
             + struct.pack("<ii", 3, 1))
    assert _both(tmp_path, cycle, fn="load_t7") == "ok"


@pytest.mark.parametrize("legacy", [True, False])
@pytest.mark.parametrize("packed", [True, False])
def test_caffemodel_layers_identical(tmp_path, rng, legacy, packed):
    layers = _vgg_layers(rng)
    p = str(tmp_path / "m.caffemodel")
    write_caffemodel(p, layers, legacy=legacy, packed=packed)
    got, want = caffeproto.read_caffemodel(p), jax_caffeproto.read_caffemodel(p)
    assert list(got) == list(want) == list(layers)
    assert _same(got, want)


def test_caffemodel_hostile_inputs_raise_alike(tmp_path, rng):
    """tests/test_caffe.py's truncations, its flipped dim, a double-data
    num=1 conv and a varint data field: the same outcome in both readers."""
    layers = _vgg_layers(rng, stages=("1_1",))
    p = tmp_path / "m.caffemodel"
    write_caffemodel(p, layers)
    data = p.read_bytes()
    cases = [data[:cut] for cut in range(0, len(data), max(1, len(data) // 64))]
    bad = bytearray(data)
    idx = bad.index(bytes([0x08]))
    bad[idx + 1] = 0x7F
    cases.append(bytes(bad))
    w, b = rng.standard_normal((1, 3, 3, 3)), rng.standard_normal(1)
    blob_w = b"".join(_key(f, 0) + _varint(d) for f, d in zip((1, 2, 3, 4), w.shape))
    blob_b = b"".join(_key(f, 0) + _varint(1) for f in (1, 2, 3, 4))
    cases.append(_len_field(1, b"NET") + _len_field(2, _layer("conv9_9", [
        blob_w + _len_field(8, w.ravel().astype("<f8").tobytes()),
        blob_b + _len_field(8, b.astype("<f8").tobytes())], legacy=True)))
    cases.append(_len_field(1, b"NET") + _len_field(2, _layer(
        "conv1_1", [_key(5, 0) + _varint(7)], legacy=True)))
    cases.append(_len_field(1, b"NET") + _len_field(2, _layer(
        "conv1_1", [_blob(w, legacy_dims=False, packed=False)], legacy=True)))
    seen = []
    for i, case in enumerate(cases):
        q = tmp_path / f"c{i}.caffemodel"
        q.write_bytes(case)
        got = _outcome(caffeproto.read_caffemodel, str(q))
        want = _outcome(jax_caffeproto.read_caffemodel, str(q))
        assert got[0] == want[0], (i, got[0], want[0])
        if got[0] == "ok":
            assert _same(got[1], want[1])
        seen.append(got[0])
    assert seen[-4] == "ValueError" or seen[-4] == "EOFError"
    assert seen[-3] == "ok" and seen[-2] == "ValueError" and seen[-1] == "ok"
