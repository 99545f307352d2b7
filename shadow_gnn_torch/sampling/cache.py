"""Device-resident subgraph cache for the deterministic PPR sampler.

The reference records each root's subgraph once and reuses it
(``minibatch.py:306-342``).  Here the cache lives on the device, with
the adjacency bit-packed:

  nodes  [T, N]            int32   sorted member ids
  adj    [T, N, ceil(N/8)] uint8   induced adjacency, bit-packed
  hop    [T, N]            int8    BFS hop annotation (-1 unreachable)
  ppr    [T, N]            f32     PPR annotation
  drnl   [T, N]            int16   DRNL annotation (link task)

Bit layout (tiled, as in the JAX package): bit s of byte b encodes
column ``s*BYTES + b``, so column j is bit ``j // BYTES`` of byte
``j % BYTES``.  The packed aggregation kernel reads this layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from shadow_gnn_torch.sampling.batch import SamplerConfig, SubgraphBatch
from shadow_gnn_torch.sampling.induction import (ROWS_GATHER_BUDGET,
                                                 rows_gather_bytes)


@dataclasses.dataclass
class SubgraphCache:
    nodes: torch.Tensor        # [T, N] int32
    adj_bits: torch.Tensor     # [T, N, BYTES] uint8
    targets: torch.Tensor      # [T, Tt] int32 (local)
    hop: torch.Tensor          # [T, N] int8
    ppr: torch.Tensor          # [T, N] f32
    drnl: torch.Tensor         # [T, N] int16


def estimate_bytes(num_roots: int, n_pad: int) -> int:
    return num_roots * n_pad * (4 + math.ceil(n_pad / 8) + 1 + 4 + 2)


def pack_bits(adj: torch.Tensor) -> torch.Tensor:
    """[..., N, N] {0,1} -> [..., N, ceil(N/8)] uint8 (tiled layout;
    the padding bits of the last byte column are 0)."""
    n = adj.shape[-1]
    nbytes = -(-n // 8)
    a = torch.nn.functional.pad(adj, (0, nbytes * 8 - n))
    a = a.reshape(a.shape[:-1] + (8, nbytes)).to(torch.int32)
    shifts = (1 << torch.arange(8, dtype=torch.int32, device=adj.device))[:, None]
    return (a * shifts).sum(-2).to(torch.uint8)


def unpack_bits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """[..., N, BYTES] uint8 -> [..., N, n] f32 (tiled layout)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)[:, None]
    b = (bits.unsqueeze(-2) >> shifts) & 1                # [..., N, 8, BYTES]
    return b.reshape(bits.shape[:-1] + (-1,))[..., :n].float()


def build_cache(sample_fn: Callable[[torch.Tensor, torch.Tensor], SubgraphBatch],
                roots_all: torch.Tensor, rows_all: torch.Tensor,
                cfg: SamplerConfig) -> SubgraphCache:
    """Run the sampler over every root once, packing the results.

    sample_fn(roots [C, T], rows [C, T]) -> SubgraphBatch;
    roots_all / rows_all: [num_roots, T] on the cache's device.
    Chunks of up to 256 roots, fewer when one chunk's induction scratch
    would exceed ``ROWS_GATHER_BUDGET`` (the JAX package's sizing,
    ``shadow_gnn_tpu/sampling/cache.py:86-97``).  Any overflow raises:
    a cached subgraph must be exact.
    """
    n = cfg.n_pad
    t = roots_all.shape[0]
    dev = roots_all.device
    chunk = 256
    per_root = 0
    if cfg.induction == "rows" and cfg.deg_cap > 0:
        per_root = rows_gather_bytes(1, n, cfg.deg_cap)
    elif cfg.induction in ("cand", "hub") and cfg.cand_cap > 0:
        per_root = 2 * cfg.cand_cap * n * 2
    if per_root > 0:
        chunk = min(chunk, max(8, ROWS_GATHER_BUDGET // per_root))
    nodes = torch.empty((t, n), dtype=torch.int32, device=dev)
    bits = torch.empty((t, n, math.ceil(n / 8)), dtype=torch.uint8, device=dev)
    targets = torch.empty((t, cfg.num_targets), dtype=torch.int32, device=dev)
    hop = torch.empty((t, n), dtype=torch.int8, device=dev)
    ppr = torch.empty((t, n), dtype=torch.float32, device=dev)
    drnl = torch.empty((t, n), dtype=torch.int16, device=dev)
    for s in range(0, t, chunk):
        e = min(s + chunk, t)
        b = sample_fn(roots_all[s:e], rows_all[s:e])
        # the build runs outside any step: one host read a chunk
        if int(b.overflow):
            raise RuntimeError(f"induction overflowed by {int(b.overflow)} in a "
                               "cached subgraph")
        nodes[s:e] = b.nodes
        bits[s:e] = pack_bits(b.adj)
        targets[s:e] = b.targets
        hop[s:e] = torch.clamp(b.hop, -1, 127)
        ppr[s:e] = b.ppr
        drnl[s:e] = torch.clamp(b.drnl, -2**15, 2**15 - 1)
    return SubgraphCache(nodes=nodes, adj_bits=bits, targets=targets,
                         hop=hop, ppr=ppr, drnl=drnl)


def gather_batch(cache: SubgraphCache, rows: torch.Tensor, n_pad: int,
                 num_nodes: int, unpack: bool = True) -> SubgraphBatch:
    """rows [B] (cache row per root) -> SubgraphBatch.

    unpack=False leaves ``adj`` None: the packed aggregation kernel reads
    ``adj_bits`` directly and the dense [B, N, N] block never exists."""
    nodes = cache.nodes[rows].long()
    bits = cache.adj_bits[rows]
    node_mask = nodes < num_nodes
    return SubgraphBatch(
        nodes=nodes,
        node_mask=node_mask,
        adj=unpack_bits(bits, n_pad) if unpack else None,
        targets=cache.targets[rows].long(),
        size=node_mask.sum(-1),
        hop=cache.hop[rows].long(),
        ppr=cache.ppr[rows],
        drnl=cache.drnl[rows].long(),
        adj_bits=bits,
    )
