"""The port's image files on the CPU, without PIL in the port: its PNG codec
(``data/png.py``, the Average/Paeth helper ``data/csrc/png_unfilter.c``)
against PIL, its bicubic resize against ``PIL.Image.resize``, its JPEG entry
points against the reference package's codec binding (the same
``native/imgcodec.cpp``), the codec-unavailable branch, and the inference
datasets (``data/pipeline.py``) against the reference's on the same folders.

Tolerances: PNG decode, the port's PNG in PIL, and the resize are bit-equal
to PIL; JPEG decode and encode are bit-equal to the reference binding. The
reference datasets decode JPEG files with PIL, whose bundled libjpeg may
differ from the system one the codec links: there the arrays agree within
2/255 (measured 0 here: both use libjpeg's default islow DCT and fancy
upsampling), PNG files are bit-equal.
"""

import io
import os
import re
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from collaborative_distillation_tpu.data import native_codec as jnc
from collaborative_distillation_tpu.data import pipeline as jpipe
from collaborative_distillation_tpu.utils import image as jimage

from collaborative_distillation_tpu_torch.data import native_codec as tnc
from collaborative_distillation_tpu_torch.data import pipeline as tpipe
from collaborative_distillation_tpu_torch.data import png
from collaborative_distillation_tpu_torch.utils import image as timage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_TOL = 2 / 255


@pytest.fixture(scope="module")
def photo():
    with np.load(os.path.join(REPO, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        return d["content"], d["style"]


def _pil_png(img, **kw):
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _filters(data):
    """The filter type of every row of an 8-bit PNG."""
    h = struct.unpack(">I", data[20:24])[0]
    idat, pos = b"", 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)[:, 0].tolist())


# ---- PNG ------------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "P", "LA"])
def test_png_written_by_pil_decodes_bit_equal(photo, mode):
    c = photo[0][:64, :64]
    im = Image.fromarray(c).quantize(200) if mode == "P" else Image.fromarray(c).convert(mode)
    data = _pil_png(im)
    if mode == "RGB":   # PIL's adaptive filtering: Sub and Paeth rows among others
        assert {1, 4} <= _filters(data)
    np.testing.assert_array_equal(png.decode_png(data), np.asarray(im.convert("RGB")))


def _filter_rows(px, ft, bpp):
    """A reference PNG filter (PNG spec, section 9), one byte at a time."""
    h, stride = px.shape
    out = np.zeros((h, stride + 1), np.uint8)
    for r in range(h):
        out[r, 0] = ft
        for i in range(stride):
            a = int(px[r, i - bpp]) if i >= bpp else 0
            b = int(px[r - 1, i]) if r else 0
            c = int(px[r - 1, i - bpp]) if r and i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = [0, a, b, (a + b) // 2,
                    a if pa <= pb and pa <= pc else b if pb <= pc else c][ft]
            out[r, i + 1] = (int(px[r, i]) - pred) % 256
    return out


def _png_of(filtered, w, h):
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))
    return (png.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(filtered.tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4])
def test_every_filter_type_reverses_exactly(rng, ft):
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    data = _png_of(_filter_rows(img.reshape(9, 39), ft, 3), 13, 9)
    np.testing.assert_array_equal(png.decode_png(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    # mixed rows: this filter on even rows, Up on odd ones
    mixed = _filter_rows(img.reshape(9, 39), 2, 3)
    mixed[::2] = _filter_rows(img.reshape(9, 39), ft, 3)[::2]
    np.testing.assert_array_equal(png.decode_png(_png_of(mixed, 13, 9)), img)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (64, 48), (300, 17)])
def test_port_png_decodes_bit_equal_in_pil(rng, photo, shape):
    h, w = shape
    img = np.ascontiguousarray(photo[1][:h, :w]) if h <= 64 else rng.integers(
        0, 256, (h, w, 3), dtype=np.uint8)
    data = png.encode_png(img)
    assert _filters(data) == {2}
    got = Image.open(io.BytesIO(data))
    assert got.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(got), img)
    np.testing.assert_array_equal(png.decode_png(data), img)


def test_large_png_deflates_in_pieces_into_one_valid_stream(rng):
    img = rng.integers(0, 256, (1100, 1300, 3), dtype=np.uint8)   # 4.3 MB: three pieces
    flat = np.concatenate([np.full((1100, 1), 2, np.uint8),
                           img.reshape(1100, -1)], axis=1)
    assert flat.size > 2 * png._PIECE
    assert zlib.decompress(png._deflate(flat)) == flat.tobytes()
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png.encode_png(img)))), img)


@pytest.mark.parametrize("case,match", [
    ("16bit", "16-bit RGB PNG is not supported"),
    ("interlaced", "interlaced"),
    ("4bit", "4-bit palette PNG is not supported"),
    ("crc", "fails its CRC"),
    ("truncated", "truncated"),
    ("noiend", "IEND"),
    ("notpng", "not a PNG"),
    ("big", "over the 100-pixel limit"),
])
def test_png_refuses_what_it_cannot_read(photo, case, match):
    c = photo[0][:32, :32]
    if case in ("16bit", "interlaced"):
        # an RGB header claiming 16-bit samples or Adam7 interlacing
        ihdr = struct.pack(">IIBBBBB", 2, 2, 16 if case == "16bit" else 8, 2, 0, 0,
                           case == "interlaced")
        data = _png_of(np.zeros((2, 7), np.uint8), 2, 2)
        data = data[:16] + ihdr + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr)) + data[33:]
    elif case == "4bit":
        data = _pil_png(Image.fromarray(c).quantize(8), bits=4)
    elif case == "crc":
        data = bytearray(_pil_png(Image.fromarray(c)))
        data[40] ^= 1
        data = bytes(data)
    elif case == "truncated":
        data = _pil_png(Image.fromarray(c))[:60]
    elif case == "noiend":
        data = _pil_png(Image.fromarray(c))[:-12]
    elif case == "notpng":
        data = b"GIF89a" + bytes(20)
    else:
        data = png.encode_png(c)
    with pytest.raises(ValueError, match=match):
        png.decode_png(data, max_pixels=100 if case == "big" else None)


def test_average_and_paeth_need_the_helper_and_nothing_stands_in(photo, monkeypatch):
    c = photo[0][:48, :48]
    data = _pil_png(Image.fromarray(c))
    assert png._load() is not None and png._reason is None
    d = png.build_dir()
    assert d.startswith(os.path.join(REPO, "build", "torch_kernels", "png-"))
    assert os.path.exists(os.path.join(d, "libpngunfilter.so"))
    text = open(png._SRC).read()
    found = {n: len([a for a in args.split(",") if a.strip()])
             for n, args in re.findall(r"int (cd_\w+)\(([^)]*)\)", text)}
    assert found == {k: len(v[0]) for k, v in png._SIGNATURES.items()}
    monkeypatch.setattr(png, "_lib", None)
    monkeypatch.setattr(png, "_reason", "PNG filter helper unavailable: g++ could not run")
    with pytest.raises(RuntimeError, match="g\\+\\+ could not run"):
        png.decode_png(data)
    # Sub and Up rows need no helper
    np.testing.assert_array_equal(png.decode_png(png.encode_png(c)), c)


# ---- resize -----------------------------------------------------------------------------

@pytest.mark.parametrize("size", [(272, 272), (100, 37), (1000, 1024), (45, 139), (13, 3),
                                  (512, 300), (3, 3), (1, 1), (17, 91), (511, 512)])
def test_resize_is_bit_equal_to_pil(photo, size):
    w, h = size
    img = photo[0] if w > 50 else np.ascontiguousarray(photo[1][:301, :97])
    want = np.asarray(Image.fromarray(img).resize((w, h)))
    np.testing.assert_array_equal(timage.resize(img, w, h), want)


@pytest.mark.parametrize("size", [40, 300, 129])
def test_resize_shorter_side_matches_the_reference(photo, size):
    for img in (photo[0][:, :320], photo[1][:200]):
        want = np.asarray(jpipe.resize_shorter_side(Image.fromarray(img), size))
        np.testing.assert_array_equal(tpipe.resize_shorter_side(img, size), want)


# ---- JPEG through the codec -------------------------------------------------------------

def test_codec_signatures_match_the_c_entry_points():
    with open(os.path.join(REPO, "native", "imgcodec.cpp")) as f:
        text = f.read()
    found = {n: len([a for a in args.split(",") if a.strip()]) for n, args in
             re.findall(r"^(?:int|long|void\*?) (cd_\w+)\(([^)]*)\)", text, re.M)}
    assert {n: len(v[0]) for n, v in tnc._SIGNATURES.items()} == {n: found[n]
                                                                  for n in tnc._SIGNATURES}
    assert {"cd_jpeg_decode", "cd_jpeg_encode", "cd_resize_rgb"} <= set(tnc._SIGNATURES)


def test_jpeg_entry_points_match_the_reference_binding(photo):
    c = np.ascontiguousarray(photo[0][:200, :150])
    jpeg = tnc.encode_jpeg(c, quality=90)
    assert jpeg == jnc.encode_jpeg(c, quality=90)
    assert tnc.jpeg_dims(jpeg) == jnc.jpeg_dims(jpeg) == (150, 200)
    for denom in (1, 2, 4):
        np.testing.assert_array_equal(tnc.decode_jpeg(jpeg, denom), jnc.decode_jpeg(jpeg, denom))
    np.testing.assert_array_equal(tnc.decode_jpeg_shorter_side(jpeg, 60),
                                  jnc.decode_jpeg_shorter_side(jpeg, 60))
    pil = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"), np.float32)
    assert np.abs(tnc.decode_jpeg(jpeg) - pil).max() / 255 <= JPEG_TOL
    assert tnc.decode_jpeg(jpeg, max_pixels=100) is None
    assert tnc.decode_jpeg(b"\xff\xd8 not a jpeg") is None and tnc.jpeg_dims(b"xx") is None
    assert tnc.encode_jpeg(c.astype(np.float32)) is None
    with pytest.raises(ValueError, match="over the 100-pixel limit"):
        timage.decode_image(jpeg, max_pixels=100)
    with pytest.raises(ValueError, match="cannot decode JPEG cut.jpg: a bad header"):
        timage.decode_image(jpeg[:300], name="cut.jpg")


def test_without_the_codec_jpeg_raises_with_name_and_reason(photo, tmp_path, monkeypatch):
    c = np.ascontiguousarray(photo[0][:32, :48])
    jpeg = tnc.encode_jpeg(c)
    (tmp_path / "a.jpg").write_bytes(jpeg)
    monkeypatch.setattr(tnc, "_lib", None)
    monkeypatch.setattr(tnc, "_reason", "native codec unavailable: no jpeglib.h")
    for fn in (tnc.jpeg_dims, tnc.decode_jpeg, tnc.encode_jpeg):
        assert fn(jpeg if fn is not tnc.encode_jpeg else c) is None
    with pytest.raises(timage.CodecUnavailable, match="a.jpg: native codec unavailable"):
        timage.read_image(str(tmp_path / "a.jpg"))
    with pytest.raises(timage.CodecUnavailable, match="b.jpg: native codec unavailable"):
        timage.save_image(c, str(tmp_path / "b.jpg"))
    assert not (tmp_path / "b.jpg").exists()
    # a caller that chooses PNG there gets the same stem and the reason
    path, why = timage.jpeg_or_png(str(tmp_path / "b.jpg"))
    assert path == str(tmp_path / "b.png") and why == tnc.unavailable_reason()
    timage.save_image(c, path)
    np.testing.assert_array_equal(timage.read_image(path), c)
    assert timage.jpeg_or_png(str(tmp_path / "c.png")) == (str(tmp_path / "c.png"), None)


# ---- files and datasets against the reference ------------------------------------------

def test_save_and_load_match_the_reference(photo, tmp_path):
    c = photo[0][:40, :56].astype(np.float32) / 255.0 * 0.9 + 0.03
    for ext in (".png", ".jpg"):
        timage.save_image(c, str(tmp_path / f"t{ext}"))
        jimage.save_image(c, str(tmp_path / f"j{ext}"))
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"t{ext}")),
                                      np.asarray(Image.open(tmp_path / f"j{ext}")))
        for r in (0, 20, 70):
            np.testing.assert_allclose(
                timage.load_image_array(str(tmp_path / f"j{ext}"), resize_shorter=r),
                jimage.load_image_array(str(tmp_path / f"j{ext}"), resize_shorter=r),
                atol=0 if ext == ".png" else JPEG_TOL)
    batch = np.stack([c, c[::-1], c[:, ::-1]])
    timage.save_image_grid(batch, str(tmp_path / "tg.png"), nrow=2)
    jimage.save_image_grid(batch, str(tmp_path / "jg.png"), nrow=2)
    np.testing.assert_array_equal(timage.read_image(str(tmp_path / "tg.png")),
                                  np.asarray(Image.open(tmp_path / "jg.png")))
    with pytest.raises(ValueError, match=".bmp"):
        timage.save_image(c, str(tmp_path / "t.bmp"))


@pytest.fixture(scope="module")
def folders(photo, tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    c, s = photo
    for sub, names in (("content", {"in1.png": c[:90, :130], "in2_pick.jpg": c[200:330, 100:190],
                                    "notes.txt": None}),
                       ("style", {"s1_pick.png": s[:70, :50], "s2.jpg": s[300:400, :120]}),
                       ("texture", {"t1.png": s[100:140, 100:164]})):
        (root / sub).mkdir()
        for name, arr in names.items():
            if arr is None:
                (root / sub / name).write_text("not an image")
            else:
                Image.fromarray(np.ascontiguousarray(arr)).save(root / sub / name, quality=92)
    return root


@pytest.mark.parametrize("kw", [{}, {"content_size": 64, "style_size": 48},
                                {"picked_content_mark": "pick", "picked_style_mark": "pick"},
                                {"synthesis": True}])
def test_pair_grid_dataset_matches_the_reference(folders, kw):
    args = (str(folders / "content"), str(folders / "style"))
    t = tpipe.PairGridDataset(*args, texture_dir=str(folders / "texture"), **kw)
    j = jpipe.PairGridDataset(*args, texture_dir=str(folders / "texture"), **kw)
    assert t.pairs == j.pairs and len(t) == len(j) > 0
    for i in range(len(t)):
        (tc, ts, tn), (jc, js, jn) = t[i], j[i]
        assert tn == jn and tn.endswith(".jpg")
        for got, want, path in ((tc, jc, t.pairs[i][0]), (ts, js, t.pairs[i][1])):
            assert got.dtype == np.float32 and got.shape == want.shape
            exact = path.endswith(".png") or kw.get("synthesis")
            np.testing.assert_allclose(got, want, atol=0 if exact else JPEG_TOL)


def test_center_crop_dataset_matches_the_reference(folders):
    t = tpipe.CenterCropDataset(str(folders / "content"), shorter_side=80, crop=64)
    j = jpipe.CenterCropDataset(str(folders / "content"), shorter_side=80, crop=64)
    assert t.paths == j.paths and len(t) == 2
    for i in range(len(t)):
        assert t[i][1] == j[i][1] and t[i][0].shape == (64, 64, 3)
        np.testing.assert_allclose(t[i][0], j[i][0],
                                   atol=0 if t.paths[i].endswith(".png") else JPEG_TOL)
    assert tpipe.is_img("A.JPEG") and not tpipe.is_img("notes.txt")
