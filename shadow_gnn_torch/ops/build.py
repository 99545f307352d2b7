"""Build and load the hand-written CUDA kernels.

Each source in ``shadow_gnn_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, in
``shadow_gnn_torch/_build/`` (gitignored), and loaded with ``ctypes``.
A library is rebuilt when it is missing or older than its source.
:func:`build` starts one ``nvcc`` per stale source, all together, and
waits for every one of them.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# library name -> source file in csrc/
KERNEL_SOURCES = {"packed_spmm": "packed_spmm.cu",
                  "gat_attention": "gat_attention.cu",
                  "gat_attention_clocks": "gat_attention.cu"}
# library name -> extra nvcc flags: the GAT kernels with their per-phase
# clocks compiled in (chip_smoke.py's phase_clocks_gat reads them)
KERNEL_FLAGS = {"gat_attention_clocks": ["-DGAT_PHASE_CLOCKS"]}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is "
                           "needed to build the port's kernels")
    path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(f"nvcc not found at {path}")
    return path


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = library_path(name)
    src = os.path.join(CSRC, KERNEL_SOURCES[name])
    return not os.path.isfile(so) or os.path.getmtime(so) < os.path.getmtime(src)


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every stale kernel library; returns nvcc's output (ptxas
    register and shared-memory report) per library built."""
    names = list(KERNEL_SOURCES if names is None else names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *KERNEL_FLAGS.get(name, []), "-o", tmp,
               os.path.join(CSRC, KERNEL_SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}:\n{logs[n]}" for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(library_path(name))
    return lib
