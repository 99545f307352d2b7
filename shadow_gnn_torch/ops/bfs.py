"""Batched multi-source BFS over dense subgraph blocks.

``dist[b, s, j]`` is the BFS distance from ``starts_local[b, s]`` to node
j of block b along out-edges (``adj[b, i, j] > 0``), -1 for unreachable
nodes and padding; the start node gets 0.  Induction's hop annotation
(S = 1) and the link task's DRNL labels (S = 2) read it
(``sampling/induction.py``).

* on CUDA tensors :func:`bfs_hops_multi` launches the hand-written kernel
  of ``csrc/bfs_hops.cu``, which loops over the levels on the device, so
  a CUDA graph holds the whole BFS as one launch (or raises);
* on CPU tensors it computes :func:`bfs_hops_plain`, the plain PyTorch
  version (a host loop until the frontier is empty), which the tests hold
  against the JAX package and ``chip_smoke.py`` holds the kernel against
  on the card.

Not the port of a TPU kernel: the counterpart of the JAX package's
device ``lax.while_loop`` (``shadow_gnn_tpu/sampling/induction.py:
bfs_hops_multi``).
"""
from __future__ import annotations

import ctypes

import torch

THREADS = 256           # threads per CTA (csrc/bfs_hops.cu:KTHREADS)
MAX_N = 16384           # u16 frontier lists in 8 N bytes of shared memory


def bfs_hops_plain(adj: torch.Tensor, starts_local: torch.Tensor,
                   node_mask: torch.Tensor) -> torch.Tensor:
    """Plain version: all sources advance in one host loop, a batched
    product a level, until no frontier is left (one host read a level).
    adj [B, N, N] f32, starts_local [B, S] int64, node_mask [B, N] bool
    -> [B, S, N] int64."""
    n = adj.shape[1]
    ar = torch.arange(n, device=adj.device)
    frontier = ar[None, None, :] == starts_local[..., None]
    dist = torch.where(frontier, 0, -1)
    lvl = 0
    while bool(frontier.any()):
        nxt = torch.bmm(frontier.float(), adj) > 0
        new = nxt & (dist < 0) & node_mask[:, None, :]
        dist = torch.where(new, lvl + 1, dist)
        frontier = new
        lvl += 1
    return dist


def _kernel_fn():
    from shadow_gnn_torch.ops.build import load
    fn = load("bfs_hops").bfs_hops_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn


def check_shapes(adj: torch.Tensor, starts_local: torch.Tensor,
                 node_mask: torch.Tensor):
    """Raise unless the operands are a [B, N, N] f32 block, [B, S] int64
    starts and a [B, N] bool mask with N within the kernel's limit."""
    if adj.dim() != 3 or adj.shape[1] != adj.shape[2]:
        raise ValueError(f"bfs_hops: adj {tuple(adj.shape)} is not [B, N, N]")
    b, n = adj.shape[:2]
    if n > MAX_N:
        raise ValueError(f"bfs_hops: N={n} above the kernel's limit MAX_N={MAX_N}")
    if starts_local.dim() != 2 or starts_local.shape[0] != b:
        raise ValueError(f"bfs_hops: starts {tuple(starts_local.shape)} is not "
                         f"[{b}, S]")
    if tuple(node_mask.shape) != (b, n):
        raise ValueError(f"bfs_hops: node_mask {tuple(node_mask.shape)} is not "
                         f"[{b}, {n}]")
    if (adj.dtype != torch.float32 or starts_local.dtype != torch.int64
            or node_mask.dtype != torch.bool):
        raise TypeError(f"bfs_hops: want f32 adj, int64 starts and a bool mask, got "
                        f"{adj.dtype}, {starts_local.dtype}, {node_mask.dtype}")


def bfs_hops_multi(adj: torch.Tensor, starts_local: torch.Tensor,
                   node_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] start nodes -> [B, S, N] int64 distances (-1 unreachable or
    padding): the kernel on CUDA tensors, the plain version on CPU ones.
    ``bfs_hops_multi.launches`` counts the kernel's launches."""
    devs = {adj.device, starts_local.device, node_mask.device}
    if devs == {torch.device("cpu")}:
        return bfs_hops_plain(adj, starts_local, node_mask)
    if len(devs) != 1 or adj.device.type != "cuda":
        raise ValueError(f"bfs_hops: operands on {sorted(map(str, devs))}: all must "
                         "be on one CUDA device (or all on the CPU)")
    check_shapes(adj, starts_local, node_mask)
    b, n = adj.shape[:2]
    s = starts_local.shape[1]
    out = torch.empty((b, s, n), dtype=torch.int64, device=adj.device)
    if b == 0 or s == 0 or n == 0:
        return out
    adj = adj.contiguous()
    starts = starts_local.contiguous()
    mask = node_mask.contiguous().view(torch.uint8)
    with torch.cuda.device(adj.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_fn()(adj.data_ptr(), mask.data_ptr(), starts.data_ptr(),
                          out.data_ptr(), b, n, s, stream)
    if rc != 0:
        raise RuntimeError(f"bfs_hops kernel launch failed: CUDA error {rc}")
    bfs_hops_multi.launches += 1
    return out


bfs_hops_multi.launches = 0
