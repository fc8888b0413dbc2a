"""Native (C++) host kernels, built on demand with g++ and loaded via ctypes
(a copy of leon_tpu/native/__init__.py; leon_native.cpp is a copy of
leon_tpu/native/leon_native.cpp, because the frame coders' bytes depend on
it, with one change: leon_unitig_build returns -2 where a chain walk would
never end, which the reference's build never returns from).

The compiled .so is keyed by a hash of the source and built into
build/leon_tpu_torch/ beside the package, never beside the source. A
failed g++ build raises: without the library the frame coders would pick
other methods and the archive bytes would differ from the reference's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "leon_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "leon_tpu_torch")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _build() -> str:
    """Compile leon_native.cpp into the keyed library; returns its path."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"_leon_native_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    base = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    # OpenMP first (parallel unitig successor search), as the reference does;
    # the serial build writes the same bytes
    for cmd in (base[:1] + ["-fopenmp"] + base[1:], base):
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"g++ could not run: {e}") from e
        if res.returncode == 0:
            os.replace(tmp, so)
            return so
    raise RuntimeError(f"g++ failed to build leon_native.cpp ({res.returncode}):\n"
                       f"{res.stderr[-4000:]}")


def _load() -> ctypes.CDLL:
    so = _build()
    lib = ctypes.CDLL(so)
    lib.leon_rans_encode.restype = ctypes.c_int64
    lib.leon_rans_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_rans_decode.restype = ctypes.c_int64
    lib.leon_rans_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_o1_encode.restype = ctypes.c_int64
    lib.leon_o1_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_o1_decode.restype = ctypes.c_int64
    lib.leon_o1_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_q1_encode.restype = ctypes.c_int64
    lib.leon_q1_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_q1_decode.restype = ctypes.c_int64
    lib.leon_q1_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_ragged_move.restype = None
    lib.leon_ragged_move.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_ragged_fill.restype = None
    lib.leon_ragged_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_uint8,
    ]
    lib.leon_hdr_encode.restype = ctypes.c_int64
    lib.leon_hdr_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_merge_runs.restype = ctypes.c_int64
    lib.leon_merge_runs.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.leon_rows_sorted.restype = ctypes.c_int32
    lib.leon_rows_sorted.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.leon_spell_canon.restype = ctypes.c_int64
    lib.leon_spell_canon.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.leon_line_index.restype = ctypes.c_int64
    lib.leon_line_index.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_bloom_build.restype = ctypes.c_int32
    lib.leon_bloom_build.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.leon_linestruct_scan.restype = ctypes.c_int64
    lib.leon_linestruct_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.leon_unitig_chains.restype = ctypes.c_int32
    lib.leon_unitig_chains.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32,
    ]
    lib.leon_unitig_build.restype = ctypes.c_int64
    lib.leon_unitig_build.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.leon_hdr_decode.restype = ctypes.c_int64
    lib.leon_hdr_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built on first call; raises if it cannot
    be built."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _load()
    return _LIB
