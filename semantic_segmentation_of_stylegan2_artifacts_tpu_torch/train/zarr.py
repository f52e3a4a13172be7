"""zarr v2 arrays on an OCDBT store (``train/ocdbt.py``), as orbax writes
them: the array ``name`` is the key ``name/.zarray`` (JSON metadata) and one
key a chunk, ``name/i.j.k`` (``name/0`` for a 0-d array).

The reader takes C order, the ``.`` separator, a zstd or no compressor and
no filters; it assembles the chunk grid, cuts the edge chunks (stored at
the full chunk shape) and reads a missing chunk as the fill value (null:
0).  A sharded ``jax.Array`` is written one chunk a
shard.  Anything else -- another compressor, a filter, ``F`` order, zarr v3
or separator -- raises ``ValueError`` naming the key.  The writer writes
one chunk an array, uncompressed.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import List, Tuple

import numpy as np
import torch

from ..native import zstd

# zarr dtype string -> torch dtype (bfloat16 is TensorStore's extension)
DTYPES = {"<f4": torch.float32, "<f8": torch.float64, "<f2": torch.float16,
          "bfloat16": torch.bfloat16, "<i8": torch.int64, "<i4": torch.int32,
          "<i2": torch.int16, "|i1": torch.int8, "|u1": torch.uint8, "|b1": torch.bool,
          "<u4": torch.uint32}
_NAMES = {v: k for k, v in DTYPES.items()}
_NUMPY = {torch.bfloat16: np.uint16, torch.uint32: np.uint32}


def _numpy_dtype(t: torch.dtype) -> np.dtype:
    return np.dtype(_NUMPY.get(t) or torch.empty((), dtype=t).numpy().dtype)


def metadata(shape, dtype: torch.dtype) -> dict:
    """The ``.zarray`` of a one-chunk, uncompressed array."""
    if dtype not in _NAMES:
        raise ValueError(f"no zarr dtype for {dtype}")
    return {"chunks": list(shape), "compressor": None, "dimension_separator": ".",
            "dtype": _NAMES[dtype], "fill_value": None, "filters": None, "order": "C",
            "shape": list(shape), "zarr_format": 2}


def encode(name: str, value: torch.Tensor) -> List[Tuple[str, object]]:
    """The store items of ``value`` as the array ``name``: its ``.zarray``
    (key order and separators as orbax's) and its one chunk."""
    value = value.detach().cpu().contiguous()
    meta = json.dumps(metadata(value.shape, value.dtype), separators=(",", ":"))
    chunk = "0" if value.dim() == 0 else ".".join("0" for _ in value.shape)
    arr = value.view(torch.int16).numpy() if value.dtype == torch.bfloat16 else value.numpy()
    return [(f"{name}/.zarray", meta.encode()), (f"{name}/{chunk}", arr)]


def read_array(store, name: str) -> torch.Tensor:
    """The array ``name`` of ``store`` as a CPU tensor."""
    key = f"{name}/.zarray"
    raw = store.get(key)
    if raw is None:
        raise KeyError(f"{key}: not in the store")
    meta = json.loads(raw.tobytes())
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{key}: zarr_format {meta.get('zarr_format')!r}, only 2 is read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{key}: order {meta['order']!r}, only C is read")
    if meta.get("filters"):
        raise ValueError(f"{key}: filters {meta['filters']!r} are not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{key}: compressor {comp.get('id')!r}, only zstd or none is read")
    if meta.get("dtype") not in DTYPES:
        raise ValueError(f"{key}: dtype {meta.get('dtype')!r} not supported")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"{key}: dimension separator {meta['dimension_separator']!r}, "
                         "only '.' is read")
    fill = meta.get("fill_value")
    if fill is not None and not isinstance(fill, (int, float)):
        raise ValueError(f"{key}: fill value {fill!r} not supported")
    dtype = DTYPES[meta["dtype"]]
    npdt = _numpy_dtype(dtype)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"{key}: chunks {list(chunks)} for shape {list(shape)}")
    fill = fill or 0
    out = (torch.full(shape, fill, dtype=dtype).view(torch.int16).numpy().view(npdt)
           if dtype == torch.bfloat16 else np.full(shape, fill, dtype=npdt))
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * npdt.itemsize
    for idx in itertools.product(*grid):
        ckey = f"{name}/" + (".".join(str(i) for i in idx) if idx else "0")
        data = store.get(ckey)
        if data is None:
            continue  # never written: the fill value
        if comp is not None:
            buf = np.empty(chunk_bytes, np.uint8)
            n = zstd.decompress_into(data, buf)
            data = buf[:n]
        if data.size != chunk_bytes:
            raise ValueError(f"{ckey}: {data.size} bytes, a chunk of {list(chunks)} "
                             f"{meta['dtype']} is {chunk_bytes}")
        chunk = data.view(npdt).reshape(chunks)
        dst = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t
