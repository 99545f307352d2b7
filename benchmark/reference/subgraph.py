"""shaDow-GNN subgraphs of PPR scopes, as dense padded blocks.

A root's subgraph holds the root and every node of its PPR top-k table
row (threshold 0 keeps every positive score), sorted by id and padded
with the sentinel ``n`` (the node count) to ``n_pad``; its block is the
adjacency of the mode's graph induced on those nodes (row = the
out-neighbourhood), with self edges on the real nodes where the
configuration adds them; each node is annotated with its BFS hop from
the root inside the block (-1 unreachable).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def node_tables(roots: torch.Tensor, neighs: torch.Tensor, n: int,
                n_pad: int) -> torch.Tensor:
    """[B, n_pad] sorted member ids, padding ``n``: each root with its
    table row ``neighs`` [B, k] (-1 padding)."""
    ids = torch.cat([roots[:, None], torch.where(neighs >= 0, neighs, n)], 1)
    ids = torch.sort(ids, 1)[0]
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    ids = torch.sort(torch.where(dup, n, ids), 1)[0]
    if ids.shape[1] >= n_pad:
        if bool((ids[:, n_pad:] < n).any()):
            raise ValueError("a scope holds more nodes than n_pad")
        return ids[:, :n_pad]
    return torch.nn.functional.pad(ids, (0, n_pad - ids.shape[1]), value=n)


def induce(keys: torch.Tensor, nodes: torch.Tensor, n: int,
           self_edges: bool = False) -> torch.Tensor:
    """[B, N, N] f32 block of the graph induced on ``nodes`` [B, N]:
    entry (i, j) is 1 where the directed edge key ``nodes[i] * n +
    nodes[j]`` is among ``keys`` (the graph's sorted edge keys), a
    binary search per pair, so that a hub's degree costs nothing."""
    b, npad = nodes.shape
    real = nodes < n
    q = (nodes[:, :, None] * n + nodes[:, None, :]).reshape(-1)
    pos = torch.clamp(torch.searchsorted(keys, q), max=keys.numel() - 1)
    hit = (keys[pos] == q).view(b, npad, npad) & real[:, :, None] & real[:, None, :]
    adj = hit.float()
    if self_edges:
        eye = torch.eye(npad, device=nodes.device)
        adj = torch.maximum(adj, eye * (real[:, :, None] & real[:, None, :]))
    return adj


def bfs_hops(adj: torch.Tensor, start: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """[B, N] int64 BFS distance from local node ``start`` [B] along
    out-edges, -1 where unreachable or padding."""
    b, npad = real.shape
    frontier = torch.arange(npad, device=adj.device)[None] == start[:, None]
    dist = torch.where(frontier, 0, -1)
    level = 0
    while bool(frontier.any()):
        level += 1
        reach = torch.bmm(frontier.float()[:, None], adj)[:, 0] > 0
        frontier = reach & (dist < 0) & real
        dist = torch.where(frontier, level, dist)
    return dist


def build(graph: Dict[str, torch.Tensor], roots: torch.Tensor, neighs: torch.Tensor,
          n: int, n_pad: int, self_edges: bool = False) -> Dict[str, torch.Tensor]:
    """The subgraphs of ``roots`` [B] from their table rows: ``nodes``,
    ``real`` (the node mask), ``adj``, ``target`` (the root's place) and
    ``hop``."""
    nodes = node_tables(roots, neighs, n, n_pad)
    adj = induce(graph["keys"], nodes, n, self_edges)
    real = nodes < n
    target = torch.searchsorted(nodes, roots[:, None])[:, 0]
    return {"nodes": nodes, "real": real, "adj": adj, "target": target,
            "hop": bfs_hops(adj, target, real)}


def device_graph(indptr: np.ndarray, indices: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """The CSR graph's directed edges as sorted int64 keys ``u * n + v``."""
    n = indptr.size - 1
    ip = torch.as_tensor(np.asarray(indptr, np.int64), device=device)
    src = torch.repeat_interleave(torch.arange(n, device=device), ip[1:] - ip[:-1])
    dst = torch.as_tensor(np.asarray(indices, np.int64), device=device)
    return {"keys": torch.sort(src * n + dst)[0]}
