"""Zstandard frames and CRC-32C through ``zstd.cpp``, the port's own
decoder (RFC 8878): the orbax checkpoint reader's two layers of zstd, the
OCDBT nodes and the zarr chunks (``train/ocdbt.py``, ``train/zarr.py``).

No system libzstd and no ``zstandard`` module: the machine that hosts the
card has neither.  ``zstd.cpp`` is built at first use, never at import, like
``decode.cpp`` (``native.build``: ``g++`` into ``_build/native/<hash>/``),
and called through ``ctypes``, which releases the GIL.  A failed build
raises ``RuntimeError`` with the compiler's output; a malformed, truncated or
checksum-failing frame raises ``ValueError`` and returns no partial bytes.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from . import build

SRC = Path(__file__).resolve().parent / "zstd.cpp"
_LIB_NAME = "libssazstd.so"
MAGIC = b"\x28\xb5\x2f\xfd"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build ``zstd.cpp`` if this source has no library yet; load it."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = build(SRC, _LIB_NAME)
            lib.ssa_zstd_bound.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_char_p, ctypes.c_int64]
            lib.ssa_zstd_bound.restype = ctypes.c_int64
            lib.ssa_zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                                ctypes.c_void_p, ctypes.c_int64,
                                                ctypes.c_char_p, ctypes.c_int64]
            lib.ssa_zstd_decompress.restype = ctypes.c_int64
            lib.ssa_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]
            lib.ssa_crc32c.restype = ctypes.c_uint32
            _lib = lib
    return _lib


def _view(data) -> np.ndarray:
    return np.frombuffer(memoryview(data).cast("B"), np.uint8)


def bound(data) -> int:
    """An upper bound of the decoded size of the frames in ``data``, read
    from their headers (the content size where a frame states it)."""
    src = _view(data)
    err = ctypes.create_string_buffer(256)
    n = library().ssa_zstd_bound(src.ctypes.data, src.size, err, len(err))
    if n < 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    return int(n)


def decompress_into(data, out: np.ndarray) -> int:
    """Decode every frame of ``data`` into the C-contiguous array ``out``;
    returns the bytes written.  ``ValueError`` when the frames are malformed
    or decode to more than ``out`` holds."""
    src = _view(data)
    if not out.flags.c_contiguous:
        raise ValueError("zstd: the output array must be C-contiguous")
    err = ctypes.create_string_buffer(256)
    n = library().ssa_zstd_decompress(src.ctypes.data, src.size, out.ctypes.data,
                                      out.nbytes, err, len(err))
    if n < 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    return int(n)


def decompress(data, limit: Optional[int] = None) -> bytes:
    """The decoded bytes of every frame of ``data``; ``ValueError`` when the
    bound of the decoded size passes ``limit``."""
    cap = bound(data)
    if limit is not None and cap > limit:
        raise ValueError(f"zstd: frames decode to up to {cap} bytes, past {limit}")
    out = np.empty(cap, np.uint8)
    n = decompress_into(data, out)
    return out[:n].tobytes()


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing ``crc``."""
    src = _view(data)
    return int(library().ssa_crc32c(src.ctypes.data, src.size, crc))
