"""The port's pure-Python JPEG header parser (``data/jpeg_header.py``) against
libjpeg, through the reference package's codec binding (the same
``native/imgcodec.cpp``), and PIL's own marker reader: sizes, sampling
factors, the 4:2:0 planes test, baseline or progressive, restart intervals,
quantization tables, APPn and COM segments, odd sizes, and truncated or
corrupt headers. ``ijg_quant_tables`` against the DQT segments libjpeg
writes at a given quality.
"""

import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from collaborative_distillation_tpu.data import native_codec as jnc
from collaborative_distillation_tpu_torch.data import jpeg_header as jh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def content():
    if not jnc.available():
        pytest.skip(f"the reference codec did not build: {jnc.unavailable_reason()}")
    with np.load(os.path.join(REPO, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        return d["content"]


def _pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img)).save(buf, "JPEG", **kw)
    return buf.getvalue()


# name -> (crop of the content, PIL's save options); "libjpeg" cases are written
# by the reference binding instead
PIL_CASES = {
    "420": ((100, 80), {"quality": 90}),
    "422": ((100, 80), {"quality": 90, "subsampling": 1}),
    "444": ((100, 80), {"quality": 90, "subsampling": 0}),
    "grey": ((64, 48), {"quality": 90}),
    "progressive": ((96, 64), {"progressive": True}),
    "progressive444": ((96, 64), {"progressive": True, "subsampling": 0}),
    "restarts": ((64, 64), {"restart_marker_blocks": 4}),
    "comment": ((64, 64), {"comment": b"a comment segment"}),
    "icc": ((64, 64), {"icc_profile": b"\x00" * 300}),
    "exif": ((64, 64), {"exif": b"Exif\x00\x00" + b"\x00" * 20}),
    "odd": ((101, 77), {}),
    "one_pixel": ((1, 1), {}),
    "odd_wide": ((3, 250), {"quality": 75}),
}


def _case(content, name) -> bytes:
    (h, w), kw = PIL_CASES[name]
    img = content[:h, :w, 0] if name == "grey" else content[:h, :w]
    return _pil(img, **kw)


@pytest.mark.parametrize("name", sorted(PIL_CASES))
def test_header_agrees_with_libjpeg_and_pil(content, name):
    data = _case(content, name)
    hdr = jh.parse(data)
    im = Image.open(io.BytesIO(data))
    assert hdr is not None and jh.jpeg_dims(data) == jnc.jpeg_dims(data) == im.size
    # PIL's own marker reader: (id, h, v, tq) per component, natural-order tables
    assert [(c.id, c.h, c.v, c.tq) for c in hdr.components] == [tuple(x) for x in im.layer]
    assert {k: v.ravel().tolist() for k, v in hdr.quant_tables.items()} == {
        k: list(v) for k, v in im.quantization.items()}
    assert hdr.progressive == bool(im.info.get("progressive"))
    assert hdr.color_space == ("grey" if name == "grey" else "ycbcr") and hdr.jfif
    # libjpeg's own test of the 4:2:0 planes path
    assert hdr.planes_ok == (jnc.decode_jpeg_yuv420(data) is not None)
    if name == "restarts":
        assert hdr.restart_interval == 4
    else:
        assert hdr.restart_interval == 0


@pytest.mark.parametrize("hw", [(64, 64), (66, 130), (2, 2), (16, 18), (15, 17)])
def test_libjpeg_files_take_the_planes_path_where_libjpeg_does(content, hw):
    h, w = hw
    data = jnc.encode_jpeg(np.ascontiguousarray(content[:h, :w]), quality=90)
    hdr = jh.parse(data)
    assert (hdr.width, hdr.height) == (w, h) and hdr.sof == 0xC0
    assert hdr.sampling == ((2, 2), (1, 1), (1, 1)) and hdr.is_yuv420
    assert hdr.planes_ok == (h % 2 == 0 and w % 2 == 0) == (
        jnc.decode_jpeg_yuv420(data) is not None)


def test_the_fixture_files(content):
    with np.load(os.path.join(REPO, "collaborative_distillation_tpu_torch", "data",
                              "jpeg_fixture.npz")) as d:
        files = {k[:-5]: d[k].tobytes() for k in d.files if k.endswith("_jpeg")}
        files["content_q95"] = d["content_q95"].tobytes()
    for name, data in files.items():
        hdr = jh.parse(data)
        assert jh.jpeg_dims(data) == jnc.jpeg_dims(data)
        assert hdr.planes_ok == (jnc.decode_jpeg_yuv420(data) is not None), name
    assert jh.parse(files["prog"]).progressive and not jh.parse(files["in1"]).progressive
    assert jh.parse(files["c444"]).sampling == ((1, 1),) * 3
    assert jh.parse(files["grey"]).color_space == "grey"


def test_truncated_headers_are_refused_where_libjpeg_refuses_them(content):
    """Cut at every byte up to past the first scan's header: the parser
    refuses every cut libjpeg refuses. They differ only inside the SOS
    segment, where libjpeg reads its fake end-of-file marker as the scan's
    last fields and the parser refuses."""
    data = _case(content, "420")
    sos = data.index(b"\xff\xda")
    sos_end = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    for i in range(sos_end + 16):
        ours, theirs = jh.jpeg_dims(data[:i]), jnc.jpeg_dims(data[:i])
        if theirs is None or i < sos:
            assert ours == theirs, i
        elif ours != theirs:
            assert sos < i < sos_end and ours is None, i
    assert jh.jpeg_dims(data[:sos_end]) == jnc.jpeg_dims(data[:sos_end]) == (80, 100)


def _patched(data: bytes, at: int, new: bytes) -> bytes:
    return data[:at] + new + data[at + len(new):]


def test_corrupt_headers_are_refused_as_libjpeg_refuses_them(content):
    data = _case(content, "420")
    sof = data.index(b"\xff\xc0")
    sos = data.index(b"\xff\xda")
    dqt = data.index(b"\xff\xdb")
    sof_len = struct.unpack(">H", data[sof + 2:sof + 4])[0]
    cases = {
        "no SOI": data[2:],
        "not markers": b"\xff\xd8" + b"\x00" * 50,
        "zero height": _patched(data, sof + 5, b"\x00\x00"),
        "sampling 0": _patched(data, sof + 11, b"\x01"),
        "sampling 5": _patched(data, sof + 11, b"\x51"),
        "12-bit samples": _patched(data, sof + 4, b"\x0c"),
        "EOI before the frame": data[:sof] + b"\xff\xd9" + data[sof:],
        "a segment past the end": _patched(data, sof + 2, b"\xff\xff"),
        "a scan of a missing component": _patched(data, sos + 5, b"\x09"),
        "a 3-byte quantization table": _patched(data, dqt + 4, b"\x20"),
        "no frame": data[:sof] + data[sof + 2 + sof_len:],
        "empty": b"",
    }
    for name, bad in cases.items():
        assert jh.parse(bad) is None and jnc.jpeg_dims(bad) is None, name


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 95, 100])
def test_ijg_quant_tables_equal_libjpeg_dqt(content, quality):
    c = np.ascontiguousarray(content[:32, :48])
    lum, chrom = jh.ijg_quant_tables(quality)
    y, cbcr = jnc.rgb_to_yuv420(c)
    for data in (jnc.encode_jpeg(c, quality=quality),
                 jnc.encode_jpeg_yuv420(y, cbcr, quality=quality)):
        hdr = jh.parse(data)
        tables = [hdr.quant_tables[comp.tq] for comp in hdr.components]
        np.testing.assert_array_equal(tables[0], lum)
        np.testing.assert_array_equal(tables[1], chrom)
        np.testing.assert_array_equal(tables[2], chrom)
    assert lum.dtype == np.uint16 and lum.shape == (8, 8)


def test_ijg_quant_tables_clamp_the_quality():
    for a, b in ((0, 1), (-5, 1), (101, 100), (400, 100)):
        for x, y in zip(jh.ijg_quant_tables(a), jh.ijg_quant_tables(b)):
            np.testing.assert_array_equal(x, y)
    assert (jh.ijg_quant_tables(100)[0] == 1).all()
    assert jh.ijg_quant_tables(50)[0][0, 0] == 16 and jh.ijg_quant_tables(1)[0].max() == 255


def test_zigzag_is_a_permutation_along_the_antidiagonals():
    assert sorted(jh.ZIGZAG.tolist()) == list(range(64))
    diag = [(i // 8) + (i % 8) for i in jh.ZIGZAG]
    assert diag == sorted(diag)
