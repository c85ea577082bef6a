"""The training loader's JPEG decode, on the CPU (there is no card here).

The card decodes a training JPEG whole with nvJPEG and reproduces the
reference's shorter-side decode (libjpeg's scaled IDCT at 1/denom, then
``cd_resize_rgb``'s box resize) with two kernels, ``scale_reduce_u8`` and
``box_resize_u8`` (``ops/cuda/resize.py``). Here: the fixture the card's
checks read equals a fresh decode by the reference's binding; the box
resize's plain version is ``cd_resize_rgb`` bit for bit; the block mean's
plain version is the loop it describes; the plain chain on libjpeg's whole
decode is the reference exactly at denom 1 and within 45 dB at 2, 4 and 8;
the datasets on the CPU are the reference's; a CUDA device whose nvJPEG
cannot load raises with its reason and never reaches libjpeg; the card
dataset's glue (the thread's side stream, the crops drawn after the
decode) with the card's calls stood in by host ones; the wrappers' ctypes
launch on a stub library. The kernels themselves: ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` phase 8g.
"""

import contextlib
import ctypes
import os
import threading
import types

import numpy as np
import pytest
import torch
from PIL import Image

from collaborative_distillation_tpu.data import native_codec as jnc
from collaborative_distillation_tpu.data import pipeline as jpipe
from collaborative_distillation_tpu_torch.cli import train as cli
from collaborative_distillation_tpu_torch.data import jpeg
from collaborative_distillation_tpu_torch.data import native_codec as tnc
from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
from collaborative_distillation_tpu_torch.data import pipeline as tpipe
from collaborative_distillation_tpu_torch.data import jpeg_header
from collaborative_distillation_tpu_torch.ops import cuda as kc
from collaborative_distillation_tpu_torch.ops.cuda import _build
from collaborative_distillation_tpu_torch.ops.cuda import resize as kr
from collaborative_distillation_tpu_torch.utils.image import CodecUnavailable

DATA = os.path.dirname(tpipe.__file__)
FILES = ["d1", "d2", "d4", "d8", "c444", "prog", "up", "coco"]
DENOM = {"d1": 1, "d2": 2, "d4": 4, "d8": 8, "c444": 2, "prog": 4, "up": 1, "coco": 1}
# the plain chain on libjpeg's whole decode against libjpeg's scaled decode
# (read here: d2 57.03, d4 50.74, d8 54.15, c444 54.28, prog 54.54 dB, at
# most 5 levels; the scaled IDCT drops the block's high frequencies, the
# mean keeps them)
CHAIN_MIN_DB = 45.0
NO_NVJPEG = "nvJPEG unavailable: no libnvjpeg in this toolkit"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process (several run at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture():
    if not jnc.available():
        pytest.skip(f"the reference codec did not build: {jnc.unavailable_reason()}")
    with np.load(os.path.join(DATA, "jpeg_train_fixture.npz")) as d:
        return {k: d[k] for k in d.files}


def _cd_resize_rgb(src: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """The reference library's ``cd_resize_rgb``, through its ctypes binding."""
    src = np.ascontiguousarray(src)
    sh, sw = src.shape[:2]
    dst = np.empty((dh, dw, 3), np.uint8)
    assert jnc._load().cd_resize_rgb(src.ctypes.data_as(ctypes.c_void_p), sw, sh,
                                     dst.ctypes.data_as(ctypes.c_void_p), dw, dh) == 0
    return dst


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


# ---- the fixture ------------------------------------------------------------------------

def test_fixture_equals_a_fresh_reference_decode(fixture):
    for name in FILES:
        data, side = fixture[f"{name}_jpeg"].tobytes(), int(fixture[f"{name}_side"])
        np.testing.assert_array_equal(jnc.decode_jpeg_shorter_side(data, side),
                                      fixture[f"{name}_out"])
        hdr = jpeg_header.parse(data)
        assert jpeg.shorter_side_plan(hdr.height, hdr.width, side)[0] == DENOM[name]
        assert hdr.sampling[0] == ((1, 1) if name == "c444" else (2, 2))
        assert hdr.progressive == (name == "prog")


# ---- the plain versions -----------------------------------------------------------------

@pytest.mark.parametrize("size", [  # (sh, sw, dh, dw)
    (10, 13, 3, 5), (7, 9, 1, 1), (1, 1, 1, 1), (1, 1, 4, 4), (5, 5, 9, 11), (3, 8, 7, 2),
    (17, 31, 16, 1), (300, 400, 300, 429), (350, 500, 300, 429), (413, 313, 396, 300),
    (33, 47, 40, 57), (64, 64, 64, 64)], ids=str)
def test_box_resize_plain_is_cd_resize_rgb(size):
    """Downscales, upscales (every window widened to one pixel), 1-pixel
    outputs and the identity, bit for bit."""
    sh, sw, dh, dw = size
    src = np.random.default_rng(sh * 1000 + sw).integers(0, 256, (sh, sw, 3), dtype=np.uint8)
    if not jnc.available():
        pytest.skip(f"the reference codec did not build: {jnc.unavailable_reason()}")
    got = kr.box_resize_u8(torch.from_numpy(src), dw, dh)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (dh, dw, 3)
    np.testing.assert_array_equal(got.numpy(), _cd_resize_rgb(src, dw, dh))


def _block_mean_loop(x: np.ndarray, d: int) -> np.ndarray:
    h, w, _ = x.shape
    ho, wo = -(-h // d), -(-w // d)
    out = np.empty((ho, wo, 3), np.uint8)
    for oy in range(ho):
        for ox in range(wo):
            s = np.zeros(3, np.int64)
            for i in range(d):
                for j in range(d):
                    s += x[min(oy * d + i, h - 1), min(ox * d + j, w - 1)]
            out[oy, ox] = (s + d * d // 2) // (d * d)
    return out


@pytest.mark.parametrize("denom", [1, 2, 4, 8])
@pytest.mark.parametrize("hw", [(1, 1), (9, 13), (16, 8), (3, 17)], ids=str)
def test_scale_reduce_plain_is_the_rounded_block_mean(denom, hw):
    """ceil sizes, the last blocks edge-replicated, ``(sum + n/2) // n``."""
    x = np.random.default_rng(denom).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got = kr.scale_reduce_u8(torch.from_numpy(x), denom)
    np.testing.assert_array_equal(got.numpy(), _block_mean_loop(x, denom))


def test_scale_reduce_rounds_half_up():
    x = torch.tensor([[[0, 1, 2], [1, 2, 2]], [[0, 1, 2], [1, 2, 3]]], dtype=torch.uint8)
    # sums 2, 6, 9 over 4 pixels: 0.5 -> 1, 1.5 -> 2, 2.25 -> 2
    assert kr.scale_reduce_u8(x, 2).tolist() == [[[1, 2, 2]]]


@pytest.mark.parametrize("name", FILES)
def test_plain_chain_on_a_whole_decode_matches_the_reference(fixture, name):
    data, side = fixture[f"{name}_jpeg"].tobytes(), int(fixture[f"{name}_side"])
    whole = torch.from_numpy(jnc.decode_jpeg(data))
    got = jpeg.to_shorter_side(whole, side).numpy()
    want = fixture[f"{name}_out"]
    assert got.shape == want.shape
    if DENOM[name] == 1:
        np.testing.assert_array_equal(got, want)
    else:
        assert _psnr(got, want) >= CHAIN_MIN_DB


def test_the_cpu_seam_is_the_reference_and_plans_its_sizes(fixture):
    for name in FILES:
        data, side = fixture[f"{name}_jpeg"].tobytes(), int(fixture[f"{name}_side"])
        np.testing.assert_array_equal(jpeg.decode_jpeg_shorter_side(data, side, "cpu"),
                                      fixture[f"{name}_out"])
    # COCO's 640 x 480 and the card check's sizes at 300: denom, libjpeg's
    # ceil size, the longer side round()ed (not int()ed)
    assert jpeg.shorter_side_plan(480, 640, 300) == (1, (480, 640), (300, 400))
    assert jpeg.shorter_side_plan(700, 1000, 300) == (2, (350, 500), (300, 429))
    assert jpeg.shorter_side_plan(1300, 1700, 300) == (4, (325, 425), (300, 392))
    assert jpeg.shorter_side_plan(3300, 2500, 300) == (8, (413, 313), (396, 300))
    assert jpeg.shorter_side_plan(257, 383, 300) == (1, (257, 383), (300, 447))
    assert jpeg.shorter_side_plan(599, 800, 300) == (1, (599, 800), (300, 401))


# ---- the datasets -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jpeg_dir(fixture, tmp_path_factory):
    """The fixture's files as a training folder."""
    d = tmp_path_factory.mktemp("jpegs")
    for name in FILES:
        (d / f"{name}.jpg").write_bytes(fixture[f"{name}_jpeg"].tobytes())
    return str(d)


@pytest.mark.parametrize("aug", ["flip", "strong"])
def test_image_folder_on_the_cpu_equals_the_reference(jpeg_dir, aug):
    kw = dict(shorter_side=40, crop=32, seed=3, uint8=True, aug=aug)
    mine = tpipe.ImageFolderDataset(jpeg_dir, **kw, device="cpu")
    ref = jpipe.ImageFolderDataset(jpeg_dir, **kw)
    for idx in [0, 3, 7, 1, 5, 2, 6, 4, 3]:
        (a, pa), (b, pb) = mine[idx], ref[idx]
        assert pa == pb and a.shape == b.shape == (32, 32, 3)
        np.testing.assert_array_equal(a, b)
    pair = tpipe.ContentStylePairDataset(jpeg_dir, jpeg_dir, 40, 32, seed=5, device="cpu")
    ref_pair = jpipe.ContentStylePairDataset(jpeg_dir, jpeg_dir, 40, 32, seed=5)
    for idx in [1, 6, 0]:
        for a, b in zip(pair[idx], ref_pair[idx]):
            np.testing.assert_array_equal(a, b)


@pytest.fixture()
def no_nvjpeg(monkeypatch):
    """nvJPEG cannot load, and libjpeg may not be reached at all."""
    monkeypatch.setattr(nj, "_lib", None)
    monkeypatch.setattr(nj, "_reason", NO_NVJPEG)

    def refuse():
        raise AssertionError("a CUDA device reached libjpeg")
    monkeypatch.setattr(tnc, "_load", refuse)
    monkeypatch.setattr(jnc, "_load", refuse)


def test_a_card_without_nvjpeg_raises_its_reason(fixture, jpeg_dir, no_nvjpeg):
    data = fixture["coco_jpeg"].tobytes()
    for dev in ("cuda", "cuda:1", torch.device("cuda", 0)):
        with pytest.raises(CodecUnavailable, match="no libnvjpeg in this toolkit"):
            jpeg.decode_jpeg_shorter_side(data, 300, dev)
    for shorter_side in (40, 0):
        ds = tpipe.ImageFolderDataset(jpeg_dir, shorter_side, 32, device="cuda")
        with pytest.raises(CodecUnavailable, match="no libnvjpeg in this toolkit"):
            ds[0]
    pair = tpipe.ContentStylePairDataset(jpeg_dir, jpeg_dir, 40, 32, device="cuda")
    with pytest.raises(CodecUnavailable, match="no libnvjpeg in this toolkit"):
        pair[0]
    with pytest.raises(CodecUnavailable, match="no libnvjpeg in this toolkit"):
        list(tpipe.Loader(tpipe.ImageFolderDataset(jpeg_dir, 40, 32, device="cuda"), 2,
                          num_workers=2))


class _HostCard:
    """The card's calls stood in by host ones: nvJPEG's decode by libjpeg's
    whole decode into a CPU tensor (so the resize takes the plain
    versions), and torch.cuda's device, streams and stream context recorded
    per thread; each decode records the device and stream it ran under."""

    def __init__(self, monkeypatch):
        self.streams, self.devices, self.decodes = [], [], []
        self.current = threading.local()
        monkeypatch.setattr(nj, "available", lambda: True)
        monkeypatch.setattr(nj, "decode_jpeg", self._decode)
        monkeypatch.setattr(torch.cuda, "device", self._device)
        monkeypatch.setattr(torch.cuda, "Stream", self._new_stream)
        monkeypatch.setattr(torch.cuda, "stream", self._stream)

    def _decode(self, data, dev, **kw):
        self.decodes.append((dev, getattr(self.current, "device", None),
                             getattr(self.current, "stream", None)))
        return torch.from_numpy(jnc.decode_jpeg(data))

    @contextlib.contextmanager
    def _device(self, dev):
        self.devices.append(dev)
        self.current.device = dev
        yield
        self.current.device = None

    def _new_stream(self, dev):
        s = types.SimpleNamespace(device=dev, thread=threading.get_ident())
        self.streams.append(s)
        return s

    @contextlib.contextmanager
    def _stream(self, s):
        assert s.thread == threading.get_ident(), "a stream of another thread"
        self.current.stream = s
        yield
        self.current.stream = None


def test_card_dataset_crops_the_cards_decode_on_the_threads_own_stream(
        fixture, jpeg_dir, tmp_path, monkeypatch):
    """On a card the dataset decodes and resizes there, on a side stream of
    the calling thread (made once a thread) under the dataset's device, and
    draws its crops as the CPU dataset does: item for item, the CPU
    dataset's crops of the same decodes (here the plain chain's)."""
    card = _HostCard(monkeypatch)
    png = tmp_path / "decoded"
    png.mkdir()
    for name in FILES:   # the card's decodes, stored losslessly under the same order
        out = jpeg.to_shorter_side(torch.from_numpy(jnc.decode_jpeg(
            fixture[f"{name}_jpeg"].tobytes())), 40).numpy()
        Image.fromarray(out).save(png / f"{name}.png")
    for aug in ("flip", "strong"):
        ds = tpipe.ImageFolderDataset(jpeg_dir, 40, 32, seed=9, uint8=True, aug=aug,
                                      device="cuda:1")
        cpu = tpipe.ImageFolderDataset(str(png), 0, 32, seed=9, uint8=True, aug=aug)
        for idx in [2, 0, 7, 5, 1]:
            np.testing.assert_array_equal(ds[idx][0], cpu[idx][0])
    assert set(card.devices) == {torch.device("cuda", 1)}
    assert len(card.streams) == 2 and all(s.device == torch.device("cuda", 1)
                                          for s in card.streams)
    # every decode under the dataset's card, on its thread's side stream
    assert card.decodes and all(dev == under == torch.device("cuda", 1) and s in card.streams
                                for dev, under, s in card.decodes)
    # two loader threads: a stream each, each made once; the float items
    before = len(card.streams)
    ds = tpipe.ImageFolderDataset(jpeg_dir, 40, 32, device="cuda:1")
    batches = list(tpipe.Loader(ds, 4, num_workers=2, seed=1))
    assert len(batches) == 2 and batches[0][0].dtype == np.float32
    assert batches[0][0].shape == (4, 32, 32, 3)
    assert 1 <= len(card.streams) - before <= 2
    assert all(s is not None and s.thread != threading.get_ident()
               for _, _, s in card.decodes[-len(ds):])
    # shorter_side 0: the whole decode, fetched
    whole = tpipe.ImageFolderDataset(jpeg_dir, 0, 400, uint8=True, device="cuda:1")
    coco = next(p for p in whole.paths if p.endswith("coco.jpg"))
    assert whole._decode(coco).shape == (480, 640, 3)


def test_png_files_stay_on_the_host_for_a_card_dataset(tmp_path, monkeypatch):
    monkeypatch.setattr(nj, "_lib", None)
    monkeypatch.setattr(nj, "_reason", NO_NVJPEG)
    with np.load(os.path.join(DATA, "photo_pair_512.npz")) as d:
        Image.fromarray(np.ascontiguousarray(d["content"][:90, :120])).save(tmp_path / "a.png")
    kw = dict(shorter_side=84, crop=64, seed=2, uint8=True)
    a = tpipe.ImageFolderDataset(str(tmp_path), **kw, device="cuda")[0][0]
    b = jpipe.ImageFolderDataset(str(tmp_path), **kw)[0][0]
    np.testing.assert_array_equal(a, b)


def test_train_cli_hands_its_device_to_the_dataset(jpeg_dir, tmp_path, monkeypatch):
    """``cli.train`` builds the dataset on the trainer's device (here the
    CPU, whose libjpeg reads the folder's JPEGs)."""
    made = []

    class Recording(tpipe.ImageFolderDataset):
        def __init__(self, *a, **kw):
            made.append(kw["device"])
            super().__init__(*a, **kw)

    monkeypatch.setattr(cli, "ImageFolderDataset", Recording)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--mode", "wct_sd", "--stage", "1", "--lw_perc", "0", "--pretrained_init",
                     "--content_train", jpeg_dir, "-b", "2", "--shorter_side", "40",
                     "--max_steps", "1", "--device", "cpu", "-p", "jpg"]) == 0
    assert made == [torch.device("cpu")]


# ---- the wrappers -----------------------------------------------------------------------

def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros(4, 5, 3, dtype=torch.uint8)
    for fn, args in ((kc.scale_reduce_u8, (2,)), (kc.box_resize_u8, (3, 3))):
        with pytest.raises(ValueError, match="uint8"):
            fn(x.float(), *args)
        for bad in (torch.zeros(4, 5, 4, dtype=torch.uint8), torch.zeros(1, 4, 5, 3,
                                                                          dtype=torch.uint8),
                    torch.zeros(4, 5, dtype=torch.uint8)):
            with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
                fn(bad, *args)
        with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
            fn(torch.zeros(4, 5, 3, dtype=torch.uint8, device="meta"), *args)
        with pytest.raises(ValueError, match="positive"):
            fn(torch.zeros(0, 5, 3, dtype=torch.uint8), *args)
    for d in (0, 3.5, 9):
        with pytest.raises(ValueError, match="denom"):
            kc.scale_reduce_u8(x, d)
    with pytest.raises(ValueError, match="positive"):
        kc.box_resize_u8(x, 0, 3)
    assert kc.DATA_KERNELS == (kc.scale_reduce_u8, kc.box_resize_u8)
    assert kc.scale_reduce_u8.plain is kr.scale_reduce_plain
    assert kc.box_resize_u8.plain is kr.box_resize_plain


def _host_bytes(ptr, shape):
    n = int(np.prod(shape))
    return torch.frombuffer((ctypes.c_uint8 * n).from_address(ptr), dtype=torch.uint8).view(shape)


class _StubLibrary:
    """The C entry points computed by the plain versions on the host memory
    behind the pointers the wrappers pass."""

    def cd_scale_reduce_u8(self, x, y, h, w, d, stream):
        _host_bytes(y, (-(-h // d), -(-w // d), 3)).copy_(
            kr.scale_reduce_plain(_host_bytes(x, (h, w, 3)), d))
        return 0

    def cd_box_resize_u8(self, x, y, sh, sw, dh, dw, stream):
        _host_bytes(y, (dh, dw, 3)).copy_(kr.box_resize_plain(_host_bytes(x, (sh, sw, 3)),
                                                              dw, dh))
        return 0


def test_launches_pass_sizes_in_the_c_order_and_count(monkeypatch):
    """The wrappers' ctypes launch, with every host tensor taken for a card
    one and the library a stub: outputs equal the plain versions, each
    launch counts once (from several threads too), a failed launch raises."""
    check = kr._check   # validates as before, then takes every tensor for a card one
    monkeypatch.setattr(kr, "_check", lambda name, x: check(name, x) or True)
    monkeypatch.setattr(_build, "library", lambda: _StubLibrary())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    for k in kc.DATA_KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (13, 22, 3), dtype=np.uint8))
    assert torch.equal(kc.scale_reduce_u8(x, 4), kr.scale_reduce_plain(x, 4))
    assert torch.equal(kc.box_resize_u8(x, 7, 5), kr.box_resize_plain(x, 7, 5))
    assert torch.equal(kc.box_resize_u8(x, 30, 17), kr.box_resize_plain(x, 30, 17))
    threads = [threading.Thread(target=lambda: [kc.box_resize_u8(x, 3, 2) for _ in range(50)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert (kc.scale_reduce_u8.launches, kc.box_resize_u8.launches) == (1, 202)
    monkeypatch.setattr(_StubLibrary, "cd_box_resize_u8", lambda self, *a: 9)
    with pytest.raises(RuntimeError, match="box_resize_u8: CUDA error 9"):
        kc.box_resize_u8(x, 3, 2)
    assert kc.box_resize_u8.launches == 202

