"""Packed-adjacency aggregation: out[b] = norm(unpack(bits[b])) @ x[b].

The subgraph cache stores each block's adjacency bit-packed
(``sampling/cache.py``).  :func:`packed_spmm` aggregates straight from
the bits, so the dense [B, N, N] block never exists in device memory:

* on CUDA tensors it launches the hand-written kernel
  ``csrc/packed_spmm.cu`` (or raises);
* on CPU tensors it computes :func:`packed_spmm_plain`, the plain
  PyTorch version (unpack -> dense normalise -> ``torch.bmm``), which the
  tests hold against the JAX package and ``chip_smoke.py`` holds the
  kernel against on the card.

Counterpart of ``shadow_gnn_tpu/ops/pallas_packed.py`` (forward only:
the transposed backward and the dropedge mask come with training).
"""
from __future__ import annotations

import ctypes

import torch

from shadow_gnn_torch.ops.normalize import adj_norm_rw, adj_norm_sym
from shadow_gnn_torch.sampling.cache import unpack_bits

NORMS = ("none", "rw", "sym", "gin")
_NORM_CODE = {"none": 0, "rw": 1, "sym": 2, "gin": 3}
ROWS_PER_BLOCK = 16     # subgraph rows per thread block
THREADS = 128           # threads per block, striding over the features
MAX_SMEM = 232_448      # dynamic shared memory one block may use on sm_90


def launch_dims(b: int, n: int):
    """(grid, threads, shared-memory bytes, tiles) of one kernel launch.

    One block per (subgraph, tile of rows).  Shared memory holds the N
    inverse-sqrt degrees (f32), per-row scale (f32) and neighbour count
    (i32), and the tile's neighbour lists (u16, N entries per row)."""
    r = ROWS_PER_BLOCK
    tiles = -(-n // r)
    smem = 4 * n + 8 * r + 2 * r * n
    return b * tiles, THREADS, smem, tiles


def packed_spmm_plain(bits: torch.Tensor, x: torch.Tensor,
                      norm: str = "none") -> torch.Tensor:
    """Plain PyTorch version: unpack -> dense normalise -> bmm."""
    if norm not in NORMS:
        raise ValueError(f"unknown norm {norm!r}")
    adj = unpack_bits(bits, x.shape[1])
    if norm == "rw":
        adj = adj_norm_rw(adj)
    elif norm == "sym":
        adj = adj_norm_sym(adj)
    return torch.bmm(adj, x)


def _kernel_lib():
    from shadow_gnn_torch.ops.build import load
    lib = load("packed_spmm")
    fn = lib.packed_spmm_forward
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return fn


def packed_spmm(bits: torch.Tensor, x: torch.Tensor, norm: str = "none",
                dropedge: float = 0.0, transpose: bool = False,
                bf16: bool = False) -> torch.Tensor:
    """out[b] = norm(unpack(bits[b])) @ x[b].

    bits [B, N, ceil(N/8)] uint8, x [B, N, F] f32 -> [B, N, F] f32.
    ``packed_spmm.calls`` counts every call; ``packed_spmm.launches``
    counts the CUDA kernel launches only.
    """
    if norm not in NORMS:
        raise ValueError(f"unknown norm {norm!r}")
    if dropedge > 0.0 or transpose or bf16:
        raise NotImplementedError(
            "packed_spmm: dropedge, the transposed (backward) product and "
            "bf16 belong to training and are not ported yet")
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("packed_spmm has no backward yet")
    packed_spmm.calls += 1
    if bits.device.type == "cpu" and x.device.type == "cpu":
        return packed_spmm_plain(bits, x, norm)
    if bits.device.type != "cuda" or bits.device != x.device:
        raise ValueError(f"bits on {bits.device} and x on {x.device}: both must "
                         "be on one CUDA device (or both on the CPU)")
    if bits.dtype != torch.uint8 or x.dtype != torch.float32:
        raise TypeError(f"want uint8 bits and float32 x, got {bits.dtype}, {x.dtype}")
    if not (bits.is_contiguous() and x.is_contiguous()):
        raise ValueError("bits and x must be contiguous")
    b, n, f = x.shape
    if bits.shape != (b, n, -(-n // 8)):
        raise ValueError(f"bits {tuple(bits.shape)} do not match x {tuple(x.shape)}")
    out = torch.empty_like(x)
    if b == 0 or n == 0 or f == 0:
        return out
    grid, threads, smem, tiles = launch_dims(b, n)
    if n > 65535 or smem > MAX_SMEM or grid >= 2**31:
        raise ValueError(f"packed_spmm: N={n}, B={b} beyond the kernel's limits")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_lib()(bits.data_ptr(), x.data_ptr(), out.data_ptr(), n,
                           bits.shape[-1], f, _NORM_CODE[norm], ROWS_PER_BLOCK,
                           tiles, grid, threads, smem, stream)
    if rc != 0:
        raise RuntimeError(f"packed_spmm kernel launch failed: CUDA error {rc}")
    packed_spmm.launches += 1
    return out


packed_spmm.calls = 0
packed_spmm.launches = 0
