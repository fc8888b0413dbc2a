"""Build, load and count the hand-written CUDA kernels of the port.

Every source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together, then one link) into ONE shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), keyed by a hash of the sources, under ``build/leon_tpu_torch/``
beside the package. The build happens at first
use; nothing is compiled when a module is imported. The library is loaded
with ctypes: every pointer and the CUDA stream pass as ``c_void_p``.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing and returns ``cudaGetLastError()``; ``check``
raises on a nonzero code, so a refused launch never passes silently.

``launches`` counts, per kernel name, the wrapper calls that launched the
kernel: a run can show that its main path went through each kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "leon_tpu_torch")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

# kernel name -> wrapper calls that launched it (see module docstring)
launches: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_longlong
_U = ctypes.c_uint

# C signatures; every function returns int (cudaError_t)
_SIGS = {
    "lt_kmer_scan": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    "lt_runs_count": [_P, _P, _I64, _I, _P, _I64, _P, _P],
    "lt_runs_write": [_P, _P, _I64, _I, _P, _P, _P, _P, _I64, _P],
    "lt_bloom_build": [_P, _P, _I64, _I, _U, _I, _I, _P, _P, _P],
    "lt_walk_encode": [_P, _P, _I, _I, _I, _I, _I, _U, _P, _P, _I, _I,
                       _P, _P, _P, _P, _P, _P, _P],
    "lt_walk_pack": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                     _I64, _I64, _P, _P, _P, _I64, _P],
    "lt_walk_decode": [_P, _I, _I, _P, _P, _P, _I64, _I64, _I, _I, _I, _I,
                       _U, _P, _P, _P, _P],
    "lt_unitig_buckets": [_P, _I, _I, _I, _P, _P],
    "lt_unitig_links": [_P, _I, _I, _I, _P, _P, _P, _P, _P],
    "lt_unitig_rank": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "lt_unitig_break": [_I, _P, _P, _P, _P],
    "lt_unitig_emit": [_P, _I, _I, _P, _P, _P, _I, _I, _I64, _I, _P, _I64, _P, _P],
    "lt_solid_lookup": [_P, _I, _I, _I, _I, _P, _I, _P, _P, _P],
    "lt_unitig_buckets_words": [_P, _I, _I, _I, _I, _P, _P],
    "lt_unitig_links_words": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "lt_unitig_emit_words": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I64, _I, _P, _I64, _P,
                             _P],
    "lt_solid_lookup_words": [_P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P],
    "lt_gather_words": [_P, _I64, _P, _I64, _P, _P],
    "lt_dbg_probe": [_P, _I64, _I, _I, _I, _I, _U, _P, _P, _I, _U, _P, _P],
    "lt_dbg_walk": [_P, _I64, _I, _I, _I, _U, _P, _P, _I, _U, _P, _P, _P],
    "lt_dbg_traverse": [_P, _I64, _I, _I, _I, _I, _U, _P, _P, _I, _U, _P, _P, _P],
    "lt_kmer_scan_words": [_P, _P, _I, _I, _I, _I, _U, _P, _P, _P, _P],
    "lt_word_runs_count": [_P, _I, _P, _I64, _I, _P, _I64, _P, _P],
    "lt_word_runs_write": [_P, _I, _P, _I64, _I, _I, _P, _P, _P, _I, _P, _I64, _P],
    "lt_sort_ties": [_P, _P, _P, _I64, _I, _P, _I, _I, _P, _P, _P, _P, _I64, _P],
    "lt_plane_rows": [_P, _I, _I64, _I, _P, _P, _P],
    "lt_word_runs_rows_count": [_P, _I, _P, _I64, _I, _P, _I64, _P, _P],
    "lt_word_runs_rows_write": [_P, _I, _P, _I64, _I, _P, _P, _P, _P, _I64, _P],
    "lt_radix_hist": [_P, _P, _I, _P, _I64, _I, _I, _P, _P, _P],
    "lt_radix_pass": [_P, _P, _I, _P, _P, _I, _I64, _I, _I, _P, _P, _P, _P, _I64, _P],
    "lt_radix_bucket_scratch": [_I64, _P],
    "lt_radix_buckets": [_P, _P, _I64, _I, _I, _P, _P, _P, _I, _P, _I64, _P],
    "lt_radix_block": [_P, _P, _I, _P, _P, _I, _I64, _P, _P, _I, _P],
    "lt_merge_path": [_P, _I, _I, _I, _P],
    "lt_bloom_build_words": [_P, _P, _I64, _I, _U, _U, _I, _I, _P, _P, _P],
    "lt_walk_dense": [_P, _P, _I, _I, _I, _I, _U, _P, _P, _I, _P, _P, _P],
    "lt_kmer_scan_halves": [_P, _P, _P, _I, _I, _I, _I, _I, _U, _I, _P, _P],
    "lt_walk_encode_words": [_P, _P, _I, _I, _I, _I, _I, _U, _P, _P, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P],
    "lt_walk_decode_words": [_P, _I, _I, _P, _P, _P, _I64, _I64, _I, _I, _I, _I,
                             _U, _P, _P, _P, _P],
}


def sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build() -> str:
    """Compile csrc/*.cu into the keyed library; returns its path."""
    h = hashlib.sha256()
    for p in sources():
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libleon_tpu_torch_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs, procs = [], []
    for cu in (p for p in sources() if p.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(cu)}.o"
        objs.append(obj)
        procs.append((cu, subprocess.Popen(
            [nvcc, ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-c", "-o", obj, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    try:
        for cu, proc in procs:
            out, _ = proc.communicate(timeout=600)
            logs.append(f"== {os.path.basename(cu)}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(cu)} ({proc.returncode}):\n{out[-8000:]}")
    finally:
        for _cu, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    res = subprocess.run([nvcc, ARCH, "-shared", "-o", tmp, *objs],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-8000:]}")
    for obj in objs:
        os.unlink(obj)
    with open(os.path.join(BUILD_DIR, "ptxas.log"), "w") as f:
        f.write("\n".join(logs))
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = _build()
            cdll = ctypes.CDLL(so)
            for name, argtypes in _SIGS.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = cdll
    return _LIB


def stream(t) -> int:
    """Raw handle of PyTorch's current stream on t's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t from a C entry point."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def host_tables(tab: np.ndarray) -> np.ndarray:
    """(4, 4) u32 hash tables as a contiguous host buffer; the C entry
    points copy it (by its .ctypes.data address) into the kernel's by-value
    parameter, so the array only has to live until the call returns."""
    return np.ascontiguousarray(tab, dtype=np.uint32)


def device_scope(device):
    """A context in which `device` (a torch.device) is the current CUDA
    device: the C entry points launch there, so work on another card of a
    mesh runs in its scope. Nothing for the CPU."""
    import contextlib

    import torch

    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def on_cuda(t, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device raises.
    The wrappers take their plain version only for CPU tensors."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
