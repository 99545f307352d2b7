"""ctypes loader + build-on-first-use for the port's native PPR push.

The library is compiled from ``ppr.cpp`` beside this file (gitignored
output) the first time it is needed, and again whenever the source is
newer.  It takes the JAX package's flags, ``-O3 -march=native``: the
FMA contraction they allow is part of the scores, and the same flags
give bit-identical tables.  A ``-march=native`` binary may not run on
another CPU, so the file name carries the host it was built on and a
new host builds its own.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_HOST = hashlib.sha1(f"{platform.node()}:{platform.machine()}".encode()
                     ).hexdigest()[:12]
_SO = os.path.join(_DIR, f"libshadow_native_torch.{_HOST}.so")
_SRC = os.path.join(_DIR, "ppr.cpp")
_lib = None


def _build():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler (g++ / c++) to build the native PPR push")
    tmp = f"{_SO}.{os.getpid()}.tmp"
    subprocess.run([cxx, "-O3", "-march=native", "-std=c++17", "-shared",
                    "-fPIC", "-o", tmp, _SRC, "-lpthread"],
                   check=True, capture_output=True)
    os.replace(tmp, _SO)


def get_lib():
    """Load (building first if missing or stale) the native library."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.isfile(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        _build()
    lib = ctypes.CDLL(_SO)
    lib.shadow_ppr_push.restype = ctypes.c_int
    lib.shadow_ppr_push.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
    ]
    lib.shadow_ragged_offsets.restype = ctypes.c_int
    lib.shadow_ragged_offsets.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return lib


def _auto_dense(n_nodes: int, n_threads: int) -> int:
    """Dense push state (9 bytes/node/thread, several times faster) when
    it fits in half of free RAM, else map state."""
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    try:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return 0
    return 1 if 9 * n_nodes * n_threads < free // 2 else 2


def ppr_push_native(indptr: np.ndarray, indices: np.ndarray,
                    targets: np.ndarray, k: int, alpha_int: float,
                    epsilon: float, n_threads: int = 0):
    """Multi-threaded forward-push PPR: per-target descending top-k
    lists (neighs_list, scores_list)."""
    lib = get_lib()
    indptr64 = np.ascontiguousarray(indptr, dtype=np.int64)
    indices32 = np.ascontiguousarray(indices, dtype=np.int32)
    targets64 = np.ascontiguousarray(targets, dtype=np.int64)
    nt = targets64.size
    out_n = np.empty((nt, k), dtype=np.int32)
    out_s = np.empty((nt, k), dtype=np.float32)
    ret = lib.shadow_ppr_push(
        indptr64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indptr64.size - 1,
        indices32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        indices32.size,
        targets64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nt,
        k, ctypes.c_float(alpha_int), ctypes.c_float(epsilon), n_threads,
        _auto_dense(indptr64.size - 1, n_threads),
        out_n.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if ret != 0:
        raise RuntimeError(f"shadow_ppr_push returned {ret}")
    neighs = [row[row >= 0] for row in out_n]
    scores = [s[:n.size] for n, s in zip(neighs, out_s)]
    return neighs, scores


def ragged_offsets(buf_u4: np.ndarray, cnt: int) -> np.ndarray:
    """Positions of the per-row length words in a ragged bin buffer
    (raises on truncated files)."""
    lib = get_lib()
    buf = np.ascontiguousarray(buf_u4, dtype=np.uint32)
    out = np.empty(cnt, dtype=np.int64)
    ret = lib.shadow_ragged_offsets(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(buf.size), ctypes.c_uint32(cnt),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if ret != 0:
        raise ValueError("truncated ragged bin buffer")
    return out
