"""Node-induced subgraph extraction on device tensors.

Given the sorted, padded node table of each subgraph, build the dense
induced adjacency (reference ``_node_induced_subgraph``,
``ParallelSampler.cpp:350-453``), the local target indices, and the BFS
hop annotation.

Row induction: every member reads its CSR neighbour slice (at most
``deg_cap`` entries) and locates each neighbour in the subgraph's
sorted node table with ``torch.searchsorted``; hits are scattered into
the block.  That materialises ``[B, N, deg_cap]`` int64 (27 MB at
B=256, N=208, deg_cap=64) where the JAX package's broadcast compare
``[B, N, N, deg_cap]`` would be about 1 GB in eager PyTorch.  The result
is the same 0/1 block.
"""
from __future__ import annotations

import torch

from shadow_gnn_torch.data.graph import DeviceGraph
from shadow_gnn_torch.sampling.batch import SamplerConfig, SubgraphBatch

# device-memory budget for the row induction's [B, N, deg_cap] gather:
# membership_matrix_rows works through a batch in chunks that fit it
ROWS_GATHER_BUDGET = 2 * 1024**3
# the JAX package's budget and footprint formula, which its plan's
# memory filter reads (shadow_gnn_tpu/sampling/induction.py:36-44): the
# port chooses the same deg_cap, so it keeps its own copy of both
PLAN_GATHER_BUDGET = 2 * 1024**3


def rows_gather_bytes(batch: int, n_pad: int, deg_cap: int) -> int:
    """Device bytes of :func:`membership_matrix_rows`' neighbour gather:
    positions, ids and search results, int64 each."""
    return batch * n_pad * deg_cap * 8 * 3


def plan_gather_bytes(batch: int, n_pad: int, deg_cap: int,
                      row_block: int = 32) -> int:
    """The JAX package's ``rows_gather_bytes``: its block gather, one
    512-byte tile per gathered row of ``row_block`` neighbours."""
    r_blocks = (deg_cap - 1) // row_block + 2
    return batch * n_pad * r_blocks * 512


def bucket_cap(n: int) -> int:
    """Round a capacity up to a shared bucket (~12% geometric steps,
    multiples of 64)."""
    if n <= 64:
        return 64
    b = 64
    while b < n:
        b = -(-(b * 9 // 8) // 64) * 64
    return b


def plan_ppr_induction(scope_deg, root_deg, *, n_pad: int, num_targets: int,
                       batch_size: int, undirected: bool) -> dict:
    """Induction sizing for a deterministic (table-backed) scope.

    ``scope_deg`` is the [T, k] degree table of the scope members (0 at
    padding), ``root_deg`` the [T] root degrees.  Returns SamplerConfig
    field overrides.  ``deg_cap`` is chosen exactly as the JAX package
    chooses it: its candidates, its cost model and its memory filter
    (:func:`plan_gather_bytes`), so every hub-free rows plan is the same
    dict.  The port's own gather footprint does not choose:
    :func:`membership_matrix_rows` chunks the batch to fit it.  A plan
    that needs the hub table (undirected) or candidate enumeration
    (directed, scope degree above 4096) is not ported and raises.
    """
    scope_max = int(max(scope_deg.max() if scope_deg.size else 1,
                        root_deg.max() if root_deg.size else 1, 1))
    choices = sorted({d for d in (64, 128, 256, 512, 1024, 2048)
                      if d < scope_max} | {scope_max})
    gbatch = max(batch_size, 256)
    choices = [d for d in choices
               if plan_gather_bytes(gbatch, n_pad, d) <= PLAN_GATHER_BUDGET
               ] or [choices[0]]
    best = None
    for dc in choices:
        h_rows = (scope_deg > dc).sum(1) + (root_deg > dc)
        h_max = int(h_rows.max())
        cost = (n_pad * n_pad * dc / 2400
                + plan_gather_bytes(1, n_pad, dc) / 819
                + 2400 * (h_max * num_targets) ** 2)
        if best is None or cost < best[0]:
            best = (cost, dc, h_max)
    _, dc, h_max = best
    if h_max > 0 and (undirected or scope_max > 4096):
        raise NotImplementedError(
            f"scope degree {scope_max} needs hub or candidate induction "
            f"(deg_cap {dc}, {h_max} hub rows), which is not ported yet")
    # exact row width: covers every scope member's degree
    return dict(induction="rows", deg_cap=bucket_cap(scope_max), hub_slots=0)


def membership_matrix_rows(graph: DeviceGraph, nodes: torch.Tensor,
                           deg_cap: int) -> tuple:
    """adj[b,i,j] = 1 iff nodes[b,j] is in the CSR row of nodes[b,i].

    Members of degree above ``deg_cap`` contribute no row; they are
    counted in the returned overflow (zero when the caller sizes
    ``deg_cap`` at the scope's max degree).  The [B, N, deg_cap]
    neighbour gather runs over chunks of the batch that each fit
    ``ROWS_GATHER_BUDGET``.
    Returns (adj [B,N,N] f32, overflow int).
    """
    b, n = nodes.shape
    chunk = max(1, ROWS_GATHER_BUDGET // max(rows_gather_bytes(1, n, deg_cap), 1))
    if b <= chunk:
        return _membership_rows(graph, nodes, deg_cap)
    parts = [_membership_rows(graph, nodes[i:i + chunk], deg_cap)
             for i in range(0, b, chunk)]
    return (torch.cat([a for a, _ in parts]), sum(o for _, o in parts))


def _membership_rows(graph: DeviceGraph, nodes: torch.Tensor,
                     deg_cap: int) -> tuple:
    """:func:`membership_matrix_rows` over one chunk of the batch."""
    n_id = graph.num_nodes
    b, n = nodes.shape
    row_valid = nodes < n_id
    u = torch.clamp(nodes, max=n_id - 1)
    lo = torch.where(row_valid, graph.indptr[u], torch.zeros_like(u))
    deg = torch.where(row_valid, graph.indptr[u + 1] - lo, torch.zeros_like(u))
    small = deg <= deg_cap
    off = torch.arange(deg_cap, device=nodes.device)
    take = (off < deg[..., None]) & (small & row_valid)[..., None]   # [B,N,D]
    pos = torch.clamp(lo[..., None] + off, max=max(graph.num_edges - 1, 0))
    nbr = graph.indices[pos].reshape(b, -1)                          # [B,N*D]
    loc = torch.searchsorted(nodes, nbr)
    loc_c = torch.clamp(loc, max=n - 1)
    hit = take.reshape(b, -1) & (torch.gather(nodes, 1, loc_c) == nbr)
    row = torch.arange(n, device=nodes.device).repeat_interleave(deg_cap)
    flat = row[None, :] * n + loc_c                                  # [B,N*D]
    adj = torch.zeros(b, n * n, device=nodes.device)
    adj.scatter_add_(1, flat, hit.float())
    overflow = int((deg > deg_cap).sum())
    return (adj > 0).float().reshape(b, n, n), overflow


def bfs_hops(adj: torch.Tensor, start_local: torch.Tensor,
             node_mask: torch.Tensor) -> torch.Tensor:
    """Batched BFS distance from a start node over dense blocks, along
    out-edges.  Returns [B, N] int64 with -1 for unreachable/padding."""
    b, n, _ = adj.shape
    ar = torch.arange(n, device=adj.device)
    frontier = ar[None, :] == start_local[:, None]
    dist = torch.where(frontier, 0, -1)
    lvl = 0
    while bool(frontier.any()):
        nxt = torch.bmm(frontier.float().unsqueeze(1), adj).squeeze(1) > 0
        new = nxt & (dist < 0) & node_mask
        dist = torch.where(new, lvl + 1, dist)
        frontier = new
        lvl += 1
    return dist


def induce(graph: DeviceGraph, nodes: torch.Tensor, ppr_vals: torch.Tensor,
           roots: torch.Tensor, cfg: SamplerConfig) -> SubgraphBatch:
    """Full SubgraphBatch from sampled node sets.

    nodes     [B, N] sorted, padding = graph.num_nodes
    ppr_vals  [B, N] aligned PPR annotations
    roots     [B, T] global target ids (members of ``nodes``)
    """
    if cfg.induction != "rows" or cfg.deg_cap <= 0 or cfg.hub_slots > 0:
        raise NotImplementedError(
            f"induction {cfg.induction!r} (deg_cap {cfg.deg_cap}, hub_slots "
            f"{cfg.hub_slots}) is not ported yet: only exact row induction")
    n_id = graph.num_nodes
    node_mask = nodes < n_id
    size = node_mask.sum(-1)
    adj, overflow = membership_matrix_rows(graph, nodes, cfg.deg_cap)
    # local target indices: left search in the sorted node table
    targets = torch.searchsorted(nodes, roots)
    # remove target<->target edges (kept for T == 1)
    if cfg.num_targets > 1 and not cfg.include_target_conn:
        t_any = torch.zeros_like(node_mask, dtype=adj.dtype).scatter_(1, targets, 1.0)
        adj = adj * (1.0 - t_any[:, :, None] * t_any[:, None, :])
    if cfg.add_self_edge:
        eye = torch.eye(nodes.shape[1], device=adj.device)
        adj = torch.maximum(adj, eye[None] * node_mask[:, None, :] * node_mask[:, :, None])
    hop = torch.full_like(nodes, -1)
    drnl = torch.zeros_like(nodes)
    for a in cfg.aug_feats:
        if a != "hops":
            raise NotImplementedError(f"augment {a!r} is not ported yet")
        if cfg.num_targets != 1:
            raise ValueError("hops augment needs a single target")
        hop = bfs_hops(adj, targets[:, 0], node_mask)
    return SubgraphBatch(
        nodes=nodes,
        node_mask=node_mask,
        adj=adj,
        targets=targets,
        size=size,
        hop=hop,
        ppr=ppr_vals,
        drnl=drnl,
        overflow=overflow,
    )
