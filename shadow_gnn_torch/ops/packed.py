"""Packed-adjacency aggregation: out[b] = norm(unpack(bits[b]) * keep) @ x[b].

The subgraph cache stores each block's adjacency bit-packed
(``sampling/cache.py``).  :func:`packed_spmm` aggregates straight from
the bits, so the dense [B, N, N] block never exists in device memory.
It is differentiable in ``x``: its backward is the transposed product
:func:`packed_spmm_t`, ``dx[b] = norm(unpack(bits[b]) * keep)^T @ g[b]``,
under the same dropedge mask, regenerated from ``seed``
(``ops/normalize.py`` defines the counter-hash mask ``keep``).

* on CUDA tensors each direction launches its hand-written kernel in
  ``csrc/packed_spmm.cu`` (or raises);
* on CPU tensors each computes :func:`packed_spmm_plain`, the plain
  PyTorch version (unpack -> mask -> dense normalise -> ``torch.bmm``),
  which the tests hold against the JAX package and ``chip_smoke.py``
  holds the kernels against on the card.

``bf16=True`` (the ``--matmul_precision bfloat16`` trade, B1c) rounds
each normalised entry of the block and each entry of ``x`` (or ``g``)
to bf16 and sums the products in f32, in both directions; the output
stays f32.

Counterpart of ``shadow_gnn_tpu/ops/pallas_packed.py`` (``packed_spmm``
with its custom VJP, both modes).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from shadow_gnn_torch.ops.normalize import (adj_drop, adj_gin_rescale,
                                            adj_norm_rw, adj_norm_sym,
                                            drop_threshold)
from shadow_gnn_torch.ops.precision import round_bf16
from shadow_gnn_torch.sampling.cache import unpack_bits

NORMS = ("none", "rw", "sym", "gin")
_NORM_CODE = {"none": 0, "rw": 1, "sym": 2, "gin": 3}
_DENSE_NORM = {"none": adj_drop, "rw": adj_norm_rw, "sym": adj_norm_sym,
               "gin": adj_gin_rescale}
THREADS = 128           # threads per CTA (csrc/packed_spmm.cu:kThreads)
TILE_ROWS = 32          # output lines per CTA before the cluster grows
MAX_CLUSTER = 8         # the portable cluster size
CHUNK = 128             # features of a chunk: one float4 per lane of a warp
SMS = 132               # streaming multiprocessors of an H100 SXM
MAX_SMEM = 232_448      # dynamic shared memory one block may use on sm_90
MAX_N = 65535           # the dropedge hash and the row counts hold 16-bit indices


class LaunchDims(NamedTuple):
    """One launch of either kernel: ``grid`` CTAs in clusters of
    ``cluster``, ``threads`` each, ``smem`` bytes of dynamic shared
    memory; each CTA owns ``tile`` output lines, built ``sub`` at a time;
    each subgraph's features are split over ``fsplit`` clusters of
    ``per`` chunks of ``CHUNK``; ``vec``: float4 loads (F % 4 == 0)."""
    grid: int
    cluster: int
    threads: int
    smem: int
    tile: int
    sub: int
    fsplit: int
    per: int
    vec: bool


def launch_dims(b: int, n: int, f: int, transpose: bool = False) -> LaunchDims:
    """The launch of one direction at [B, N, F]; raises ValueError beyond
    the kernels' limits.

    One cluster of ``cluster`` CTAs (a power of two, at most 8, about
    TILE_ROWS lines each) per (subgraph, feature split); more splits
    while B * cluster CTAs would fill fewer than two per SM.  Shared
    memory: the N packed row counts (u32) and N row scales (f32), a
    survivor bitmap of ``sub`` lines of ceil(N/32) words (``sub`` as
    large as MAX_SMEM allows, up to the tile) and a mask byte per byte
    column.  The transposed kernel needs its whole tile in the bitmap;
    the forward builds it ``sub`` lines at a time."""
    words = -(-n // 32)
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * TILE_ROWS < n:
        cluster *= 2
    tile = -(-n // cluster)
    nbytes = -(-n // 8)
    sub = min(tile, (MAX_SMEM - 8 * n - nbytes) // (4 * words))
    chunks = -(-f // CHUNK)
    fsplit = max(1, min(chunks, -(-2 * SMS // (b * cluster))))
    per = -(-chunks // fsplit)
    fsplit = -(-chunks // per)
    grid = b * fsplit * cluster
    if n > MAX_N or sub < 1 or (transpose and sub < tile) or grid >= 2**31:
        raise ValueError(f"packed_spmm{'_t' if transpose else ''}: B={b}, N={n}, "
                         f"F={f} beyond the kernel's limits")
    return LaunchDims(grid, cluster, THREADS, 8 * n + 4 * sub * words + nbytes, tile,
                      sub, fsplit, per, f % 4 == 0)


def packed_spmm_plain(bits: torch.Tensor, x: torch.Tensor, norm: str = "none",
                      dropedge: float = 0.0, seed: int = 0,
                      transpose: bool = False, bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch version: unpack -> mask -> dense normalise -> bmm
    (with the normalised block transposed when ``transpose``); ``bf16``
    rounds the normalised block and ``x`` to bf16 before the f32 bmm."""
    if norm not in NORMS:
        raise ValueError(f"unknown norm {norm!r}")
    adj = _DENSE_NORM[norm](unpack_bits(bits, x.shape[1]), seed, dropedge)
    if bf16:
        adj, x = round_bf16(adj), round_bf16(x)
    return torch.bmm(adj.transpose(1, 2) if transpose else adj, x)


def _kernel_fn(transpose: bool):
    from shadow_gnn_torch.ops.build import load
    lib = load("packed_spmm")
    fn = lib.packed_spmm_transposed if transpose else lib.packed_spmm_forward
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32]
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    return fn


def _aggregate(bits, x, norm, dropedge, seed, transpose, bf16):
    """One direction: the plain version on the CPU, else the kernel."""
    if bits.device.type == "cpu" and x.device.type == "cpu":
        return packed_spmm_plain(bits, x, norm, dropedge, seed, transpose, bf16)
    if bits.device.type != "cuda" or bits.device != x.device:
        raise ValueError(f"bits on {bits.device} and x on {x.device}: both must "
                         "be on one CUDA device (or both on the CPU)")
    if bits.dtype != torch.uint8 or x.dtype != torch.float32:
        raise TypeError(f"want uint8 bits and float32 x, got {bits.dtype}, {x.dtype}")
    x = x.contiguous()
    if not bits.is_contiguous():
        raise ValueError("bits must be contiguous")
    b, n, f = x.shape
    if bits.shape != (b, n, -(-n // 8)):
        raise ValueError(f"bits {tuple(bits.shape)} do not match x {tuple(x.shape)}")
    out = torch.empty_like(x)
    if b == 0 or n == 0 or f == 0:
        return out
    d = launch_dims(b, n, f, transpose)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_fn(transpose)(
            bits.data_ptr(), x.data_ptr(), out.data_ptr(), n, bits.shape[-1],
            f, _NORM_CODE[norm], int(dropedge > 0.0),
            ctypes.c_uint32(int(seed) & 0xFFFFFFFF),
            ctypes.c_uint32(drop_threshold(dropedge)), int(bf16),
            int(d.vec and x.data_ptr() % 16 == 0), d.cluster, d.tile, d.sub,
            d.fsplit, d.per, d.grid, d.threads, d.smem, stream)
    if rc != 0:
        raise RuntimeError(f"packed_spmm kernel launch failed: CUDA error {rc}")
    fn = packed_spmm_t if transpose else packed_spmm
    if bf16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1
    return out


class _PackedSpmm(torch.autograd.Function):
    """The forward product; its backward is the transposed product over
    the same bits, norm and dropedge seed (``_fwd``/``_bwd`` of the JAX
    package's custom VJP)."""

    @staticmethod
    def forward(ctx, bits, x, norm, dropedge, seed, bf16):
        ctx.save_for_backward(bits)
        ctx.args = (norm, dropedge, seed, bf16)
        return _aggregate(bits, x, norm, dropedge, seed, False, bf16)

    @staticmethod
    def backward(ctx, g):
        (bits,) = ctx.saved_tensors
        return None, packed_spmm_t(bits, g, *ctx.args), None, None, None, None


def _check_args(norm: str, dropedge: float):
    if norm not in NORMS:
        raise ValueError(f"unknown norm {norm!r}")
    if not 0.0 <= dropedge < 1.0:
        raise ValueError(f"dropedge {dropedge} outside [0, 1)")


def packed_spmm(bits: torch.Tensor, x: torch.Tensor, norm: str = "none",
                dropedge: float = 0.0, seed: int = 0,
                bf16: bool = False) -> torch.Tensor:
    """out[b] = norm(unpack(bits[b]) * keep(seed, b)) @ x[b].

    bits [B, N, ceil(N/8)] uint8, x [B, N, F] f32 -> [B, N, F] f32;
    ``seed`` picks the dropedge mask (ignored at dropedge 0); ``bf16``
    the bf16 mode (its backward too).  Differentiable in ``x``.
    ``packed_spmm.calls`` counts every call; ``packed_spmm.launches``
    and ``packed_spmm.launches_bf16`` count the forward kernel's
    launches in each mode.
    """
    _check_args(norm, dropedge)
    packed_spmm.calls += 1
    return _PackedSpmm.apply(bits, x, norm, float(dropedge), int(seed), bool(bf16))


def packed_spmm_t(bits: torch.Tensor, g: torch.Tensor, norm: str = "none",
                  dropedge: float = 0.0, seed: int = 0,
                  bf16: bool = False) -> torch.Tensor:
    """dx[b] = norm(unpack(bits[b]) * keep(seed, b))^T @ g[b]: the
    backward of :func:`packed_spmm`.  ``packed_spmm_t.launches`` and
    ``packed_spmm_t.launches_bf16`` count the transposed kernel's
    launches in each mode."""
    _check_args(norm, dropedge)
    return _aggregate(bits, g, norm, float(dropedge), int(seed), True, bool(bf16))


packed_spmm.calls = 0
packed_spmm.launches = packed_spmm.launches_bf16 = 0
packed_spmm_t.launches = packed_spmm_t.launches_bf16 = 0
