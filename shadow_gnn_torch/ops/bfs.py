"""Batched multi-source BFS over dense subgraph blocks.

``dist[b, s, j]`` is the BFS distance from ``starts_local[b, s]`` to node
j of block b along out-edges (``adj[b, i, j] > 0``), -1 for unreachable
nodes and padding; the start node gets 0.  A level reaches the nodes
whose SUM over the frontier's rows is > 0 (the link task's blocks hold
-1 and -3 where a pair repeats its node).  Induction's hop annotation
(S = 1) and the link task's DRNL labels (S = 2) read it
(``sampling/induction.py``).  Its blocks hold small integers (0/1 edges,
self edges, the target-edge removal): the kernel sums them exactly in
int32 and equals the plain version bit for bit.

* on CUDA tensors :func:`bfs_hops_multi` launches the hand-written kernel
  of ``csrc/bfs_hops.cu`` (one thread-block cluster per subgraph and
  source from N = 256 up, else one CTA: :func:`launch_dims`), which
  loops over the levels on the device, so a CUDA graph holds the whole
  BFS as one launch (or raises);
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
from typing import NamedTuple

import torch

THREADS = 256           # threads per CTA (csrc/bfs_hops.cu:KTHREADS)
MAX_N = 16384           # u16 frontier lists and int16 distances
CLUSTERS = (8, 4, 2)    # the cluster sizes the kernel takes besides 1
CLUSTER_MIN_N = 256     # below it one CTA a source beats every cluster
MAX_SMEM = 232_448      # dynamic shared memory one block may use on sm_90


class BfsLaunch(NamedTuple):
    """One launch: ``grid`` CTAs (B * S clusters of ``cluster``),
    ``threads`` each; each CTA owns ``width`` columns and takes ``smem``
    bytes of dynamic shared memory."""
    grid: int
    cluster: int
    width: int
    smem: int
    threads: int


def smem_bytes(width: int) -> int:
    """A CTA's shared memory (``csrc/bfs_hops.cu:smem_bytes``): two int32
    accumulators of its ``width`` columns (in chunks of 128), 16 bytes
    for the last live level, and for each column a distance (int16) and
    a frontier slot (u16)."""
    return 8 * (-(-width // 128) * 128) + 16 + 4 * width


def cluster_dims(b: int, n: int, s: int, cluster: int) -> BfsLaunch:
    """The launch for B subgraphs of N nodes and S sources a subgraph in
    clusters of ``cluster`` CTAs: a CTA owns ceil(ceil(N / 4) / cluster)
    4-column groups."""
    width = 4 * -(-(-(-n // 4)) // cluster)
    return BfsLaunch(b * s * cluster, cluster, width, smem_bytes(width), THREADS)


def launch_dims(b: int, n: int, s: int, sms: int) -> BfsLaunch:
    """The launch on a card of ``sms`` SMs: one cluster per (subgraph,
    source), where N is CLUSTER_MIN_N or more of the largest size of
    ``CLUSTERS`` that keeps the B * S clusters within one CTA an SM, else
    one CTA.  On an H100 (``chip_smoke.py`` [bfs] logs both sides) one
    CTA won at N = 208 and clusters from N = 408 up, by more as N grows."""
    cluster = next((c for c in CLUSTERS if n >= CLUSTER_MIN_N and b * s * c <= sms), 1)
    return cluster_dims(b, n, s, cluster)


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    dims = launch_dims(b, n, s,
                       torch.cuda.get_device_properties(adj.device).multi_processor_count)
    adj = adj.contiguous()
    starts = starts_local.contiguous()
    mask = node_mask.contiguous().view(torch.uint8)
    with torch.cuda.device(adj.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_fn()(adj.data_ptr(), mask.data_ptr(), starts.data_ptr(),
                          out.data_ptr(), b, n, s, dims.cluster, dims.width, stream)
    if rc != 0:
        raise RuntimeError(f"bfs_hops kernel launch failed: CUDA error {rc}")
    bfs_hops_multi.launches += 1
    return out


bfs_hops_multi.launches = 0
