"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The sources compile at first use with ``nvcc`` for ``sm_90a`` (one
object per source, all compiled at once, linked into one shared library
with a plain C interface) into ``_build/<hash of the sources>/``, and
load with ``ctypes``.  Nothing here runs at import time: the CPU tests
import every module of the port on a machine with no ``nvcc``.

Each wrapper counts its launches in :data:`LAUNCHES`, one per call that
launches its kernel (a call that runs several CUDA launches, such as the
refine head's convs and reductions, counts once), so a run can show that
its main path went through the kernels.  Window attention counts its two
tiled families (windows of more than 64 tokens, on the tensor cores or the
CUDA cores) apart from the other three, so a path shows which of the two
window sizes it took.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_LIB_NAME = "libssa_kernels.so"

LAUNCHES = {
    "window_attention": 0,
    "window_attention_bwd": 0,
    "window_attention_tiled": 0,
    "window_attention_bwd_tiled": 0,
    "patch_merge": 0,
    "patch_merge_bwd": 0,
    "patch_expand": 0,
    "patch_expand_bwd": 0,
    "refine_head": 0,
    "refine_head_res": 0,
    "refine_head_bwd": 0,
    "gelu_d2s4": 0,
    "gelu_d2s4_bwd": 0,
}

# C entry points: (name, number of pointer args, number of int args); every
# function ends with (int dtype, void* stream) and returns cudaError_t.
_SIGNATURES = {
    "ssa_window_attention_fwd": (3, 11),
    "ssa_window_attention_bwd": (6, 11),
    "ssa_patch_merge_fwd": (5, 4),
    "ssa_patch_merge_fwd_mma": (6, 4),
    "ssa_patch_merge_bwd": (13, 5),
    "ssa_patch_merge_bwd_mma": (13, 5),
    "ssa_patch_expand_fwd": (5, 4),
    "ssa_patch_expand_fwd_mma": (6, 4),
    "ssa_patch_expand_bwd": (12, 5),
    "ssa_patch_expand_bwd_mma": (12, 5),
    "ssa_refine_head_fwd": (11, 3),
    "ssa_refine_head_bwd": (19, 4),
    "ssa_gelu_d2s4_fwd": (2, 4),
    "ssa_gelu_d2s4_bwd": (3, 4),
}

# C queries: (name, number of int args); each returns a long long.
_QUERIES = {
    "ssa_window_attention_bwd_scratch": 9,
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash(files) -> str:
    h = hashlib.sha256()
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_ARCH).encode())
    return h.hexdigest()[:16]


def _compile(sources, out_dir: Path, lib_path: Path) -> None:
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        procs = []
        for src in sources:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = tmp / _LIB_NAME
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out_dir / "build_log.txt").write_text("\n".join(logs))
        os.replace(tmp_lib, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build the kernels if this source tree has no library yet; load it."""
    sources = sorted(CSRC.glob("*.cu"))
    files = sources + sorted(CSRC.glob("*.cuh"))
    out_dir = BUILD_DIR / _source_hash(files)
    lib_path = out_dir / _LIB_NAME
    if not lib_path.exists():
        _compile(sources, out_dir, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (n_ptr, n_int) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for name, n_int in _QUERIES.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * n_int
        fn.restype = ctypes.c_longlong
    return lib


def build_log() -> str:
    """What ``ptxas -v`` said about each kernel (registers, spills)."""
    lib = library()
    return (Path(lib._name).parent / "build_log.txt").read_text()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (launch plans)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_cuda(t: torch.Tensor, name: str, shape=None, dtype=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given form."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"kernels take float32 or bfloat16, got {dtype}")
    return _DTYPE_CODE[dtype]


def query(fn: str, ints) -> int:
    """Call one C query (no launch): what the kernels' host code computes
    from these ints."""
    return int(getattr(library(), fn)(*[int(i) for i in ints]))


def launch(counter: str, fn: str, tensors, ints, dtype: torch.dtype) -> None:
    """Call one C entry point on the current stream; raise on a CUDA error.
    A ``None`` in ``tensors`` passes a null pointer (an optional output)."""
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = getattr(library(), fn)(
        *[None if t is None else t.data_ptr() for t in tensors],
        *[int(i) for i in ints], dtype_code(dtype), stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}")
    LAUNCHES[counter] += 1
