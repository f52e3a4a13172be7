"""Native PNG decode for the host data pipeline, with the GIL released
(counterpart of the JAX package's ``native/``).

``decode.cpp`` compiles at first use, never at import, with ``g++`` into
``_build/native/<hash of the source>/libssadecode.so`` and loads with
``ctypes``, whose foreign calls release the GIL: the threaded loader's
workers (``data/pipeline.py``) then decode in parallel, where PIL's chunk
loop takes the GIL every block.  The JAX package links libpng and libjpeg;
the machine that hosts the card has neither's headers, so this decoder
parses the PNG chunks and undoes the row filters in ``decode.cpp`` and
inflates the IDAT stream with Python's ``zlib`` (its inflate also runs
without the GIL).  JPEGs, 16-bit and sub-byte samples and interlaced PNGs
raise ``ValueError``, as a corrupt file does: ``data/dataset.py`` hands such
a file to PIL.

Unlike the JAX package, a failed build or load raises ``RuntimeError`` with
the compiler's output; nothing falls back to PIL without a word.  The
user's switch is JAX's: ``SSA_TPU_NATIVE_DECODE=0`` sends every decode to
PIL.  It is read at each decode.  :data:`DECODES` counts the decodes each
way, as ``ops/_build.LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "decode.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
CXX = "g++"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LIB_NAME = "libssadecode.so"
SWITCH = "SSA_TPU_NATIVE_DECODE"

DECODES = {"native": 0, "pil": 0}

# decode.cpp's return codes
_ERRORS = {1: "not a PNG", 2: "malformed chunk", 3: "chunk CRC mismatch",
           4: "not 8-bit non-interlaced gray, gray+alpha, RGB, RGBA or palette",
           5: "missing or malformed palette", 6: "no IDAT", 7: "unknown row filter",
           8: "palette index past the PLTE", 9: "bad argument"}

_build_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _Png(ctypes.Structure):
    """decode.cpp's ``SsaPng``."""

    _fields_ = [("width", ctypes.c_int32), ("height", ctypes.c_int32),
                ("color_type", ctypes.c_int32), ("n_palette", ctypes.c_int32),
                ("idat_bytes", ctypes.c_int64), ("raw_bytes", ctypes.c_int64),
                ("palette", ctypes.c_uint8 * 768)]


def enabled() -> bool:
    """False when the user switched the native decoder off."""
    return os.environ.get(SWITCH, "1") != "0"


def reset_decodes() -> None:
    with _count_lock:
        for k in DECODES:
            DECODES[k] = 0


def _count(kind: str) -> None:
    with _count_lock:
        DECODES[kind] += 1


def _compile(lib_path: Path) -> None:
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    # a name of this process and thread: test workers race to build
    tmp = lib_path.with_name(f"{_LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)


def library() -> ctypes.CDLL:
    """Build ``decode.cpp`` if this source has no library yet; load it."""
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is None:
            h = hashlib.sha256(SRC.read_bytes())
            h.update(" ".join([CXX, *_FLAGS]).encode())
            lib_path = BUILD_DIR / h.hexdigest()[:16] / _LIB_NAME
            if not lib_path.exists():
                _compile(lib_path)
            try:
                lib = ctypes.CDLL(str(lib_path))
            except OSError as e:
                raise RuntimeError(f"cannot load {lib_path}: {e}") from e
            lib.ssa_png_header.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                           ctypes.POINTER(_Png), ctypes.c_void_p]
            lib.ssa_png_header.restype = ctypes.c_int
            lib.ssa_png_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                           ctypes.POINTER(_Png), ctypes.c_void_p,
                                           ctypes.c_int]
            lib.ssa_png_decode.restype = ctypes.c_int
            _lib = lib
    return _lib


def available() -> bool:
    """True when the loaders decode natively: the switch is on and the
    library builds and loads (a failed build raises)."""
    if not enabled():
        return False
    library()
    return True


def decode_image(path: Optional[str] = None, data: Optional[bytes] = None,
                 gray: bool = False) -> np.ndarray:
    """Decode a PNG file (or its bytes) to uint8 (H, W, 3), or (H, W) luma
    with ``gray``: PIL's ``convert("RGB")`` / ``convert("L")`` byte for
    byte.  ``ValueError`` for a file this decoder does not take (corrupt,
    JPEG, 16-bit, sub-byte, interlaced); ``RuntimeError`` when the switch is
    off or the library does not build."""
    if not enabled():
        raise RuntimeError(f"native decode is switched off ({SWITCH}=0)")
    lib = library()
    if data is None:
        with open(path, "rb") as fh:
            data = fh.read()
    data = bytes(data)
    png = _Png()
    idat = np.empty(len(data), np.uint8)
    rc = lib.ssa_png_header(data, len(data), ctypes.byref(png), idat.ctypes.data)
    if rc != 0:
        raise ValueError(f"unsupported or corrupt image ({_ERRORS.get(rc, rc)}): {path!r}")
    try:
        raw = zlib.decompress(memoryview(idat)[:png.idat_bytes], bufsize=png.raw_bytes)
    except zlib.error as e:
        raise ValueError(f"corrupt image data ({e}): {path!r}") from e
    if len(raw) != png.raw_bytes:
        raise ValueError(f"image data of {len(raw)} bytes for {png.raw_bytes}: {path!r}")
    shape = (png.height, png.width) if gray else (png.height, png.width, 3)
    out = np.empty(shape, np.uint8)
    rc = lib.ssa_png_decode(raw, len(raw), ctypes.byref(png), out.ctypes.data,
                            1 if gray else 3)
    if rc != 0:
        raise ValueError(f"corrupt image data ({_ERRORS.get(rc, rc)}): {path!r}")
    _count("native")
    return out


def decode_pil(path: str, gray: bool = False) -> np.ndarray:
    """PIL's decode: ``convert("L")`` with ``gray``, else ``convert("RGB")``."""
    from PIL import Image

    with Image.open(path) as img:
        out = np.asarray(img.convert("L" if gray else "RGB"), dtype=np.uint8)
    _count("pil")
    return out
