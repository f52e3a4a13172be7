"""The port's native PNG decoder (``native/``) against the JAX package's and
PIL, on the CPU.  Every comparison is in bits.

* PNGs written here, one filter type on every row (None, Sub, Up, Average,
  Paeth) or all five in turn, for each 8-bit colour type (gray, RGB,
  palette with a tRNS table, gray+alpha, RGBA), IDAT split over several
  chunks: the port's
  ``decode_image`` equals PIL's ``convert("RGB")`` and ``convert("L")`` and
  the JAX package's libpng decoder.
* PNGs written by PIL (RGB, L, RGBA, LA, palette with and without tRNS, a
  0/255 mask): the same.
* A JPEG, and 16-bit, 1-bit, 4-bit palette and interlaced PNGs: the port's
  decoder raises ``ValueError`` and the loaders give PIL's bytes (a JPEG
  within 1 of the JAX package's libjpeg decode, which its own tests allow
  against PIL).
* Corrupt bytes raise ``ValueError``; a build that fails raises
  ``RuntimeError`` and no decode falls back to PIL.
* ``SSA_TPU_NATIVE_DECODE=0`` sends the loaders' decodes to PIL
  (``DECODES``), read at each decode.
* Eight threads decoding sixteen images give the serial bytes.
* ``load_rgb`` / ``load_gray`` and ``TrainLoader.epoch_batches_merged``
  equal the JAX package's, with the switch on and off.
"""

import concurrent.futures as cf
import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from semantic_segmentation_of_stylegan2_artifacts_tpu import native as jax_native
from semantic_segmentation_of_stylegan2_artifacts_tpu.data import dataset as jax_dataset
from semantic_segmentation_of_stylegan2_artifacts_tpu.data import pipeline as jax_pipeline
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch import native
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data import dataset, pipeline
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
)

SIZE = 32
# bytes a pixel of each 8-bit colour type
BPP = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
IDAT_CHUNK = 97  # bytes of the zlib stream an IDAT chunk: several chunks an image


@pytest.fixture(scope="module", autouse=True)
def _jax_native_first():
    """The JAX package reads its switch once, at its first decode: load it
    here, before any test below switches the port's decoder off."""
    assert jax_native.available()


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _filtered(rows: np.ndarray, bpp: int, filters) -> bytes:
    """PNG scanlines of ``rows`` (H, row bytes) with ``filters[y % len]``."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        f = filters[y % len(filters)]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _png(px: np.ndarray, color_type: int, filters=(0, 1, 2, 3, 4), palette=None,
         trns=None, raw=None, interlace=0, depth=8) -> bytes:
    """A PNG of ``px`` (H, W[, C]) written here: a tEXt chunk before the
    image data, the IDAT stream in ``IDAT_CHUNK``-byte chunks.  ``raw``
    replaces the scanlines (for interlaced, 16-bit or broken streams)."""
    h, w = px.shape[:2]
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace)),
           _chunk(b"tEXt", b"Comment\x00written by the test")]
    if palette is not None:
        out.append(_chunk(b"PLTE", palette.tobytes()))
    if trns is not None:
        out.append(_chunk(b"tRNS", trns))
    if raw is None:
        raw = _filtered(px.reshape(h, -1), BPP[color_type], filters)
    stream = zlib.compress(raw, 6)
    out += [_chunk(b"IDAT", stream[i:i + IDAT_CHUNK])
            for i in range(0, len(stream), IDAT_CHUNK)]
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def _pil(data: bytes, gray: bool) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("L" if gray else "RGB"))


def _assert_three_agree(data: bytes, gray: bool):
    got = native.decode_image(data=data, gray=gray)
    want = _pil(data, gray)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_native.decode_image(data=data, gray=gray))


def _written_here(color_type: int, seed: int, filters=(0, 1, 2, 3, 4)) -> bytes:
    rng = np.random.default_rng(seed)
    h, w = 13, 17
    if color_type == 3:
        palette = rng.integers(0, 256, (40, 3), dtype=np.uint8)
        return _png(rng.integers(0, 40, (h, w), dtype=np.uint8), 3, filters,
                    palette=palette, trns=bytes(range(0, 200, 20)))
    shape = (h, w) if BPP[color_type] == 1 else (h, w, BPP[color_type])
    # smooth rows and noise, so each predictor sees both
    base = np.linspace(0, 255, w).astype(np.uint8)
    px = rng.integers(0, 256, shape, dtype=np.uint8)
    px[::2] = base.reshape((1, w) + (1,) * (len(shape) - 2))
    return _png(px, color_type, filters)


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "luma"])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "all"])
@pytest.mark.parametrize("color_type", [0, 2, 3, 4, 6],
                         ids=["gray", "rgb", "palette", "gray_alpha", "rgba"])
def test_png_written_here_equals_pil_and_jax(color_type, filters, gray):
    _assert_three_agree(_written_here(color_type, 10 * color_type + len(filters), filters),
                        gray)


def test_luma_rounds_as_pil_at_every_tie():
    """Every RGB triple whose 601-2 sum lies within 1 of a rounding tie
    (768 of them), as RGB and as RGBA: PIL's fixed point, bit for bit."""
    r, g, b = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    near = np.abs((r * 19595 + g * 38470 + b * 7471) % 65536 - 0x8000) <= 1
    rgb = np.stack([r[near], g[near], b[near]], axis=-1).astype(np.uint8).reshape(24, 32, 3)
    rgba = np.concatenate([rgb, np.full((24, 32, 1), 128, np.uint8)], axis=-1)
    for px, color_type in ((rgb, 2), (rgba, 6)):
        _assert_three_agree(_png(px, color_type), True)


def _written_by_pil(kind: str, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    if kind == "RGB":
        img = Image.fromarray(rgb, "RGB")
    elif kind == "L":
        img = Image.fromarray(rgb[..., 0], "L")
    elif kind == "RGBA":
        img = Image.fromarray(rng.integers(0, 256, (21, 18, 4), dtype=np.uint8), "RGBA")
    elif kind == "LA":
        img = Image.fromarray(rgb[..., :2].copy(), "LA")
    elif kind in ("P", "P_trns"):
        img = Image.fromarray(rgb, "RGB").quantize(colors=64)  # 8-bit indices
        if kind == "P_trns":
            img.info["transparency"] = 3
    else:  # the pipeline's labels: 0/255 gray masks
        img = Image.fromarray((rng.random((64, 64)) > 0.8).astype(np.uint8) * 255, "L")
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "luma"])
@pytest.mark.parametrize("kind", ["RGB", "L", "RGBA", "LA", "P", "P_trns", "mask"])
def test_png_written_by_pil_equals_pil_and_jax(kind, gray):
    data = _written_by_pil(kind, len(kind))
    _assert_three_agree(data, gray)


def _adam7(px: np.ndarray, bpp: int) -> bytes:
    """Interlaced scanlines (filter None) of ``px``: the seven Adam7 passes."""
    out = []
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                           (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = px[y0::dy, x0::dx]
        if sub.size:
            out.append(_filtered(sub.reshape(sub.shape[0], -1), bpp, (0,)))
    return b"".join(out)


def _long_tail(kind: str) -> bytes:
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)
    if kind == "interlaced":
        return _png(rgb, 2, raw=_adam7(rgb, 3), interlace=1)
    if kind == "gray16":
        px = rng.integers(0, 65536, (24, 24), dtype=np.uint16)
        raw = b"".join(b"\x00" + row.astype(">u2").tobytes() for row in px)
        return _png(px, 0, raw=raw, depth=16)
    if kind == "bilevel":
        img = Image.fromarray(rgb[..., 0] > 127)
    else:  # 16 colours: PIL writes 4-bit indices
        img = Image.fromarray(rgb, "RGB").quantize(colors=16)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["interlaced", "gray16", "bilevel", "palette4"])
def test_long_tail_raises_and_the_loaders_give_pil_bytes(kind, tmp_path):
    data = _long_tail(kind)
    with pytest.raises(ValueError, match="not 8-bit non-interlaced"):
        native.decode_image(data=data)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(data)
    native.reset_decodes()
    np.testing.assert_array_equal(dataset.load_rgb(path), _pil(data, False))
    np.testing.assert_array_equal(dataset.load_gray(path), _pil(data, True))
    assert native.DECODES == {"native": 0, "pil": 2}


def test_jpeg_goes_to_pil(tmp_path):
    rng = np.random.default_rng(6)
    path = str(tmp_path / "x.jpg")
    Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), "RGB").save(path)
    with pytest.raises(ValueError, match="not a PNG"):
        native.decode_image(path)
    with open(path, "rb") as f:
        data = f.read()
    rgb, luma = dataset.load_rgb(path), dataset.load_gray(path)
    np.testing.assert_array_equal(rgb, _pil(data, False))
    np.testing.assert_array_equal(luma, _pil(data, True))
    # the JAX package decodes it with libjpeg: within 1 of PIL (its own test)
    jax_rgb = jax_native.decode_image(path)
    assert np.max(np.abs(rgb.astype(int) - jax_rgb.astype(int))) <= 1


def _corrupt(kind: str) -> bytes:
    good = _written_here(2, 0)
    if kind == "garbage":
        return b"not an image at all"
    if kind == "empty":
        return b""
    if kind == "truncated":
        return good[:len(good) // 2]
    if kind == "ihdr_crc":
        return good[:29] + bytes([good[29] ^ 1]) + good[30:]
    if kind == "chunk_type_digit":  # PIL takes it; this decoder leaves it to PIL
        text = _chunk(b"t3Xt", b"Comment\x00written by the test")
        return good[:33] + text + good[33 + len(text):]
    if kind == "no_idat":
        return good[:33] + _chunk(b"IEND", b"")
    px = np.random.default_rng(1).integers(0, 40, (5, 6), dtype=np.uint8)
    palette = np.zeros((8, 3), np.uint8)
    if kind == "index_past_palette":
        return _png(px, 3, palette=palette)
    if kind == "no_palette":
        return _png(px, 3)
    if kind == "bad_filter":
        return _png(px, 0, raw=b"".join(b"\x05" + row.tobytes() for row in px))
    if kind == "short_stream":
        return _png(px, 0, raw=_filtered(px[:-1], 1, (0,)))
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["garbage", "empty", "truncated", "ihdr_crc",
                                  "chunk_type_digit", "no_idat",
                                  "index_past_palette", "no_palette", "bad_filter",
                                  "short_stream"])
def test_corrupt_input_raises_value_error(kind):
    with pytest.raises(ValueError):
        native.decode_image(data=_corrupt(kind))


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_build_raises_and_never_falls_back(compiler, tmp_path, monkeypatch):
    cxx = str(tmp_path / "no-such-g++") if compiler == "missing" else "false"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(_written_here(2, 0))
    native.reset_decodes()
    with pytest.raises(RuntimeError, match=cxx):
        native.decode_image(path)
    with pytest.raises(RuntimeError, match=cxx):
        native.available()
    with pytest.raises(RuntimeError, match=cxx):
        dataset.load_rgb(path)
    assert native.DECODES == {"native": 0, "pil": 0}
    assert not list((tmp_path / "build").rglob("*.so"))


def test_build_lands_under_the_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    _assert_three_agree(_written_here(6, 3), False)
    (lib,) = list((tmp_path / "build").rglob("*.so"))
    assert lib.name == "libssadecode.so" and len(lib.parent.name) == 16
    assert not list((tmp_path / "build").rglob("*.tmp"))


def test_switch_sends_the_loaders_to_pil_at_each_decode(tmp_path, monkeypatch):
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(_written_here(2, 5))
    want = _pil(_written_here(2, 5), False)
    native.reset_decodes()
    monkeypatch.setenv(native.SWITCH, "0")
    assert native.available() is False
    with pytest.raises(RuntimeError, match=native.SWITCH):
        native.decode_image(path)
    np.testing.assert_array_equal(dataset.load_rgb(path), want)
    np.testing.assert_array_equal(dataset.load_gray(path), _pil(_written_here(2, 5), True))
    assert native.DECODES == {"native": 0, "pil": 2}
    monkeypatch.setenv(native.SWITCH, "1")
    assert native.available() is True
    np.testing.assert_array_equal(dataset.load_rgb(path), want)
    assert native.DECODES == {"native": 1, "pil": 2}


def test_threads_give_the_serial_bytes(tmp_path):
    rng = np.random.default_rng(8)
    paths = []
    for i in range(16):
        paths.append(str(tmp_path / f"t{i}.png"))
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), "RGB").save(
            paths[-1])
    serial = [native.decode_image(p) for p in paths]
    with cf.ThreadPoolExecutor(8) as pool:
        threaded = list(pool.map(native.decode_image, paths))
    for got, want in zip(threaded, serial):
        np.testing.assert_array_equal(got, want)
    native.reset_decodes()
    with cf.ThreadPoolExecutor(8) as pool:
        list(pool.map(dataset.load_rgb, paths * 4))
    assert native.DECODES == {"native": 64, "pil": 0}  # no count lost across threads


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    generate_synthetic_dataset(root, img_size=SIZE, seed=3, n_fake_train=8,
                               n_real_train=4)
    return root


@pytest.mark.parametrize("switch", ["1", "0"])
def test_load_functions_equal_jax(data, switch, monkeypatch):
    monkeypatch.setenv(native.SWITCH, switch)
    native.reset_decodes()
    n = 0
    for sub, gray in (("fake_images", False), ("real_images", False),
                      ("fake_labels", True), ("real_labels", True)):
        for name in sorted(os.listdir(os.path.join(data, sub))):
            path = os.path.join(data, sub, name)
            port = dataset.load_gray(path) if gray else dataset.load_rgb(path)
            want = jax_dataset.load_gray(path) if gray else jax_dataset.load_rgb(path)
            assert port.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(port, want)
            n += 1
    assert native.DECODES == ({"native": n, "pil": 0} if switch == "1"
                              else {"native": 0, "pil": n})


@pytest.mark.parametrize("switch", ["1", "0"])
def test_train_loader_batches_equal_jax(data, switch, monkeypatch):
    monkeypatch.setenv(native.SWITCH, switch)
    lists = os.path.join(data, "lists")

    def build(mod, ds_mod):
        return mod.TrainLoader(ds_mod.SegArtifactDataset(data, lists, "fake_train"),
                               ds_mod.SegArtifactDataset(data, lists, "real_train_all"),
                               img_size=SIZE, seed=4, num_workers=4, prefetch_depth=2)

    port, jax = build(pipeline, dataset), build(jax_pipeline, jax_dataset)
    native.reset_decodes()
    for epoch in (0, 1):
        got = list(port.epoch_batches_merged(epoch, 2))
        want = list(jax.epoch_batches_merged(epoch, 2))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["case_name"] == w["case_name"]
            for key in ("image", "label"):
                np.testing.assert_array_equal(g[key], w[key])
    used = "native" if switch == "1" else "pil"
    assert native.DECODES[used] > 0 and sum(native.DECODES.values()) == native.DECODES[used]
