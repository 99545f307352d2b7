"""Node-induced subgraph extraction on device tensors.

Given the sorted, padded node table of each subgraph, build the dense
induced adjacency (reference ``_node_induced_subgraph``,
``ParallelSampler.cpp:350-453``), the local target indices, and the BFS
hop (one target) or DRNL (two targets, the link task) annotation.  Four
strategies, chosen by ``SamplerConfig.induction`` as in the JAX
package, each giving JAX's 0/1 block and ``overflow``:

* ``rows`` (``deg_cap`` > 0) — every member of degree at most
  ``deg_cap`` reads its CSR neighbour slice and locates each neighbour
  in the subgraph's sorted node table with ``torch.searchsorted``; hits
  are scattered into the block.  That materialises ``[B, N, deg_cap]``
  int64 (27 MB at B=256, N=208, deg_cap=64) where the JAX package's
  broadcast compare ``[B, N, N, deg_cap]`` would be about 1 GB in eager
  PyTorch.  With ``hub_slots`` > 0 (undirected graphs) the block is
  mirrored, so that an edge between a small member and a hub is found
  from the small side, and the hub table (:func:`_hub_pairs`) adds the
  hub x hub pairs;
* ``cand`` (``cand_cap`` > 0, directed graphs with hubs) — every
  out-edge of every member is a candidate, in (member, position) order;
  the first ``cand_cap`` of a subgraph are located in the node table;
* ``hub`` (``cand_cap`` > 0) — the candidate pass over the members of
  degree at most ``deg_cap``, mirrored, plus the hub table;
* ``search`` (otherwise) — a binary search of every (row, column) pair
  in the row's CSR slice, exact for any degree.

Hits are scattered into ``[B, N*N]``; the JAX package's one-hot einsums
only move the same 0/1 values.  Every strategy works through the batch
in chunks whose scratch fits ``ROWS_GATHER_BUDGET``.

Nothing here reads a device tensor on the host: the overflow is a 0-d
int64 device tensor, and on CUDA tensors the BFS of the hop and DRNL
annotations is one kernel launch (``ops/bfs.py``), so a CUDA graph can
hold a whole sample-and-induce step.
"""
from __future__ import annotations

from typing import Callable

import torch

from shadow_gnn_torch.data.graph import DeviceGraph
# [B, S] starts -> [B, S, N] distances: the kernel on CUDA tensors
from shadow_gnn_torch.ops.bfs import bfs_hops_multi
from shadow_gnn_torch.sampling.batch import SamplerConfig, SubgraphBatch, no_overflow
from shadow_gnn_torch.spans import span

# device-memory budget for one chunk of an induction's scratch (the
# [B, N, deg_cap] gather of rows, the [B, cand_cap] candidates, the
# [B, N, N] search): every strategy works through a batch in chunks
# that fit it
ROWS_GATHER_BUDGET = 2 * 1024**3
# the JAX package's budget and footprint formula, which its plan's
# memory filter reads (shadow_gnn_tpu/sampling/induction.py:36-44): the
# port chooses the same deg_cap, so it keeps its own copy of both
PLAN_GATHER_BUDGET = 2 * 1024**3


def rows_gather_bytes(batch: int, n_pad: int, deg_cap: int) -> int:
    """Device bytes of :func:`membership_matrix_rows`' neighbour gather:
    positions, ids and search results, int64 each."""
    return batch * n_pad * deg_cap * 8 * 3


def cand_bytes(batch: int, cand_cap: int) -> int:
    """Device bytes of the candidate strategies' [B, cand_cap] int64
    scratch (owner, position, id, location and the scatter index)."""
    return batch * cand_cap * 8 * 6


def search_bytes(batch: int, n_pad: int) -> int:
    """Device bytes of :func:`membership_matrix`'s [B, N, N] int64
    search state (low, high, end, probe)."""
    return batch * n_pad * n_pad * 8 * 4


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
                       batch_size: int, undirected: bool,
                       row_block: int = 32) -> dict:
    """Induction sizing for a deterministic (table-backed) scope.

    ``scope_deg`` is the [T, k] degree table of the scope members (0 at
    padding), ``root_deg`` the [T] root degrees, ``row_block`` the JAX
    package's block width for the mode's graph
    (``data.graph.plan_row_block``).  Returns SamplerConfig field
    overrides, the JAX package's dict: its candidates, its cost model
    and its memory filter (:func:`plan_gather_bytes`) choose ``deg_cap``;
    a scope with members above it gets hub slots (undirected) or, on a
    directed graph whose scope degree exceeds 4096, candidate induction
    sized at the largest scope's edge count.  The port's own gather
    footprint does not choose: the induction chunks the batch to fit it.
    """
    scope_max = int(max(scope_deg.max() if scope_deg.size else 1,
                        root_deg.max() if root_deg.size else 1, 1))
    choices = sorted({d for d in (64, 128, 256, 512, 1024, 2048)
                      if d < scope_max} | {scope_max})
    gbatch = max(batch_size, 256)
    choices = [d for d in choices
               if plan_gather_bytes(gbatch, n_pad, d, row_block)
               <= PLAN_GATHER_BUDGET] or [choices[0]]
    best = None
    for dc in choices:
        h_rows = (scope_deg > dc).sum(1) + (root_deg > dc)
        h_max = int(h_rows.max())
        cost = (n_pad * n_pad * dc / 2400
                + plan_gather_bytes(1, n_pad, dc, row_block) / 819
                + 2400 * (h_max * num_targets) ** 2)
        if best is None or cost < best[0]:
            best = (cost, dc, h_max)
    _, dc, h_max = best
    if h_max > 0 and not undirected and scope_max > 4096:
        cap = int((scope_deg.sum(1) + root_deg).max()) * num_targets
        return dict(induction="cand", cand_cap=bucket_cap(cap + 8))
    if h_max > 0 and undirected:
        return dict(induction="rows", deg_cap=bucket_cap(dc),
                    hub_slots=min(h_max * num_targets + 2, n_pad))
    # exact row width: covers every scope member's degree
    return dict(induction="rows", deg_cap=bucket_cap(scope_max), hub_slots=0)


def _by_chunks(fn: Callable, nodes: torch.Tensor, per_root: int) -> tuple:
    """``fn(nodes chunk) -> (adj, overflow)`` over chunks of the batch
    whose scratch (``per_root`` bytes a subgraph) fits
    ``ROWS_GATHER_BUDGET``; the blocks concatenated, the overflows (0-d
    int64 device tensors) summed on the device."""
    b = nodes.shape[0]
    chunk = max(1, ROWS_GATHER_BUDGET // max(per_root, 1))
    if b <= chunk:
        return fn(nodes)
    parts = [fn(nodes[i:i + chunk]) for i in range(0, b, chunk)]
    return torch.cat([a for a, _ in parts]), torch.stack([o for _, o in parts]).sum()


def _members(graph: DeviceGraph, nodes: torch.Tensor):
    """(row_valid, CSR start, degree) of every member; padding has
    degree 0."""
    row_valid = nodes < graph.num_nodes
    u = torch.clamp(nodes, max=graph.num_nodes - 1)
    lo = torch.where(row_valid, graph.indptr[u], torch.zeros_like(u))
    deg = torch.where(row_valid, graph.indptr[u + 1] - lo, torch.zeros_like(u))
    return row_valid, lo, deg


def _edge_at(graph: DeviceGraph, pos: torch.Tensor) -> torch.Tensor:
    return graph.indices[torch.clamp(pos, 0, max(graph.num_edges - 1, 0))]


def _csr_search(graph: DeviceGraph, lo: torch.Tensor, hi: torch.Tensor,
                q: torch.Tensor) -> torch.Tensor:
    """Whether ``q`` lies in ``indices[lo:hi]`` (broadcast), by the JAX
    package's fixed-step lower-bound search (``graph.search_steps``
    steps cover any row)."""
    lo, hi, q = torch.broadcast_tensors(lo, hi, q)
    hi_end = hi
    for _ in range(graph.search_steps):
        mid = (lo + hi) // 2
        ge = _edge_at(graph, mid) >= q
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    return (lo < hi_end) & (_edge_at(graph, lo) == q)


def _scatter_block(b: int, n: int, row: torch.Tensor, col: torch.Tensor,
                   hit: torch.Tensor) -> torch.Tensor:
    """[B, N, N] bool with True at (row, col) of every hit; row, col,
    hit [B, M]."""
    adj = torch.zeros(b, n * n, device=row.device)
    adj.scatter_add_(1, row * n + col, hit.float())
    return (adj > 0).reshape(b, n, n)


def _locate(nodes: torch.Tensor, nbr: torch.Tensor, take: torch.Tensor):
    """Local index of each neighbour id in the sorted node table, and
    whether it is a member (and taken)."""
    loc = torch.clamp(torch.searchsorted(nodes, nbr), max=nodes.shape[1] - 1)
    return loc, take & (torch.gather(nodes, 1, loc) == nbr)


def membership_matrix(graph: DeviceGraph, nodes: torch.Tensor) -> torch.Tensor:
    """The ``search`` strategy: adj[b,i,j] = 1 iff nodes[b,j] is in the
    CSR row of nodes[b,i], by a binary search of every pair; exact for
    any degree.  [B, N, N] f32."""
    def one(nd):
        row_valid, lo, deg = _members(graph, nd)
        found = _csr_search(graph, lo[:, :, None], (lo + deg)[:, :, None],
                            nd[:, None, :])
        adj = found & (nd < graph.num_nodes)[:, None, :] & row_valid[:, :, None]
        return adj.float(), no_overflow(nd.device)
    return _by_chunks(one, nodes, search_bytes(1, nodes.shape[1]))[0]


def _candidates(graph: DeviceGraph, nodes: torch.Tensor, lo: torch.Tensor,
                deg: torch.Tensor, cand_cap: int) -> tuple:
    """The first ``cand_cap`` out-edges of the members (degrees ``deg``),
    in (member, position) order, located in the node table.  Returns
    (block [B,N,N] bool, overflow = Σ_b max(total_b − cand_cap, 0), a 0-d
    int64 tensor)."""
    b, n = nodes.shape
    csum = torch.cumsum(deg, -1)                         # inclusive [B, N]
    total = csum[:, -1]
    overflow = torch.clamp(total - cand_cap, min=0).sum()
    e = torch.arange(cand_cap, device=nodes.device).repeat(b, 1)        # [B, E]
    owner = torch.clamp(torch.searchsorted(csum, e, right=True), max=n - 1)
    start = torch.where(owner > 0, torch.gather(csum, 1, torch.clamp(owner - 1, min=0)),
                        torch.zeros_like(owner))
    pos = torch.gather(lo, 1, owner) + e - start
    nbr = _edge_at(graph, pos)
    loc, hit = _locate(nodes, nbr, e < total[:, None])
    return _scatter_block(b, n, owner, loc, hit), overflow


def membership_matrix_cand(graph: DeviceGraph, nodes: torch.Tensor,
                           cand_cap: int) -> tuple:
    """The ``cand`` strategy (directed graphs with hubs): every out-edge
    of every member is a candidate, up to ``cand_cap`` a subgraph; the
    dropped ones are counted in the overflow.
    Returns (adj [B,N,N] f32, overflow 0-d int64 tensor)."""
    def one(nd):
        row_valid, lo, deg = _members(graph, nd)
        adj, overflow = _candidates(graph, nd, lo, deg, cand_cap)
        return (adj & row_valid[:, :, None]).float(), overflow
    return _by_chunks(one, nodes, cand_bytes(1, cand_cap))


def _hub_pairs(graph: DeviceGraph, nodes: torch.Tensor, lo: torch.Tensor,
               deg: torch.Tensor, deg_cap: int, hub_slots: int) -> tuple:
    """The hub table: the top ``hub_slots`` members by degree (ties by
    ascending index, a stable sort of -deg, the set JAX's two-key sort
    picks); each hub x hub pair is searched in the hub's CSR row.
    Members above ``deg_cap`` beyond the slots are the overflow.
    Returns (adj_hub [B,N,N] bool, overflow 0-d int64 tensor)."""
    b, n = nodes.shape
    order = torch.sort(-deg, dim=-1, stable=True)[1][:, :hub_slots]   # [B, H]
    hdeg = torch.gather(deg, 1, order)
    hlo = torch.gather(lo, 1, order)
    hnodes = torch.gather(nodes, 1, order)
    hub_valid = hdeg > deg_cap
    n_hubs = (deg > deg_cap).sum(-1)
    overflow = torch.clamp(n_hubs - hub_slots, min=0).sum()
    found = _csr_search(graph, hlo[:, :, None], (hlo + hdeg)[:, :, None],
                        hnodes[:, None, :])
    s = found & hub_valid[:, :, None] & hub_valid[:, None, :]          # [B, H, H]
    h = order.shape[1]
    row = order[:, :, None].expand(b, h, h).reshape(b, -1)
    col = order[:, None, :].expand(b, h, h).reshape(b, -1)
    return _scatter_block(b, n, row, col, s.reshape(b, -1)), overflow


def membership_matrix_hub(graph: DeviceGraph, nodes: torch.Tensor,
                          cand_cap: int, deg_cap: int, hub_slots: int) -> tuple:
    """The ``hub`` strategy (undirected graphs): the candidate pass over
    the members of degree at most ``deg_cap`` (an edge to a hub is found
    from the small side and mirrored), then the hub table.  Overflow:
    candidates beyond ``cand_cap`` plus hubs beyond the slots.
    Returns (adj [B,N,N] f32, overflow 0-d int64 tensor)."""
    def one(nd):
        row_valid, lo, deg = _members(graph, nd)
        small = torch.where(deg <= deg_cap, deg, torch.zeros_like(deg))
        adj, overflow = _candidates(graph, nd, lo, small, cand_cap)
        adj = adj | adj.transpose(1, 2)
        if hub_slots > 0:
            adj_h, over_h = _hub_pairs(graph, nd, lo, deg, deg_cap, hub_slots)
            adj, overflow = adj | adj_h, overflow + over_h
        return (adj & row_valid[:, :, None]).float(), overflow
    return _by_chunks(one, nodes, cand_bytes(1, cand_cap))


def membership_matrix_rows(graph: DeviceGraph, nodes: torch.Tensor,
                           deg_cap: int, hub_slots: int = 0) -> tuple:
    """The ``rows`` strategy: adj[b,i,j] = 1 iff nodes[b,j] is in the
    CSR row of nodes[b,i], for the members of degree at most
    ``deg_cap``.  Without hub slots the members above it contribute no
    row and are the overflow (zero when the caller sizes ``deg_cap`` at
    the scope's max degree).  With ``hub_slots`` > 0 (undirected graphs)
    the block is mirrored and the hub table adds the hub x hub pairs;
    the overflow is the hubs beyond the slots.  The [B, N, deg_cap]
    neighbour gather runs over chunks of the batch that each fit
    ``ROWS_GATHER_BUDGET``.
    Returns (adj [B,N,N] f32, overflow 0-d int64 tensor).
    """
    return _by_chunks(lambda nd: _membership_rows(graph, nd, deg_cap, hub_slots),
                      nodes, rows_gather_bytes(1, nodes.shape[1], deg_cap))


def _membership_rows(graph: DeviceGraph, nodes: torch.Tensor, deg_cap: int,
                     hub_slots: int) -> tuple:
    """:func:`membership_matrix_rows` over one chunk of the batch."""
    b, n = nodes.shape
    row_valid, lo, deg = _members(graph, nodes)
    off = torch.arange(deg_cap, device=nodes.device)
    take = (off < deg[..., None]) & (deg <= deg_cap)[..., None]      # [B,N,D]
    nbr = _edge_at(graph, lo[..., None] + off).reshape(b, -1)        # [B,N*D]
    loc, hit = _locate(nodes, nbr, take.reshape(b, -1))
    row = torch.arange(n, device=nodes.device)[:, None].expand(n, deg_cap)
    adj = _scatter_block(b, n, row.reshape(1, -1).expand(b, -1), loc, hit)
    if hub_slots > 0:
        adj = adj | adj.transpose(1, 2)
        adj_h, overflow = _hub_pairs(graph, nodes, lo, deg, deg_cap, hub_slots)
        adj = adj | adj_h
    else:
        overflow = (deg > deg_cap).sum()
    return (adj & row_valid[:, :, None]).float(), overflow


def bfs_hops(adj: torch.Tensor, start_local: torch.Tensor,
             node_mask: torch.Tensor) -> torch.Tensor:
    """Batched BFS distance from a start node over dense blocks, along
    out-edges.  Returns [B, N] int64 with -1 for unreachable/padding.
    :func:`bfs_hops_multi` (``ops/bfs.py``) at S = 1: the BFS kernel on
    CUDA tensors, the plain host loop on CPU ones."""
    return bfs_hops_multi(adj, start_local[:, None], node_mask)[:, 0]


def drnl_labels(adj: torch.Tensor, targets: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
    """Double-radius node labels of 2-target (link) subgraphs: 255 when
    either target is unreachable, else 1 + min(dx, dy) + (d/2)((d/2) +
    (d%2) - 1) with d = dx + dy (Graph.cpp:66-73)."""
    d2 = bfs_hops_multi(adj, targets[:, :2], node_mask)
    dx = torch.where(d2[:, 0] < 0, 255, d2[:, 0])
    dy = torch.where(d2[:, 1] < 0, 255, d2[:, 1])
    d = dx + dy
    half = d // 2
    val = 1 + torch.minimum(dx, dy) + half * (half + d % 2 - 1)
    return torch.where((dx >= 255) | (dy >= 255), 255, val)


def induce(graph: DeviceGraph, nodes: torch.Tensor, ppr_vals: torch.Tensor,
           roots: torch.Tensor, cfg: SamplerConfig) -> SubgraphBatch:
    """Full SubgraphBatch from sampled node sets, by the strategy of
    ``cfg`` (module docstring).

    nodes     [B, N] sorted, padding = graph.num_nodes
    ppr_vals  [B, N] aligned PPR annotations
    roots     [B, T] global target ids (members of ``nodes``)
    """
    with span("sgnn.stage.membership"):
        if cfg.induction == "rows" and cfg.deg_cap > 0:
            adj, overflow = membership_matrix_rows(graph, nodes, cfg.deg_cap,
                                                   cfg.hub_slots)
        elif cfg.induction == "hub" and cfg.cand_cap > 0:
            adj, overflow = membership_matrix_hub(graph, nodes, cfg.cand_cap,
                                                  cfg.deg_cap, cfg.hub_slots)
        elif cfg.induction == "cand" and cfg.cand_cap > 0:
            adj, overflow = membership_matrix_cand(graph, nodes, cfg.cand_cap)
        else:
            adj, overflow = membership_matrix(graph, nodes), no_overflow(nodes.device)
    return annotate(adj, overflow, nodes, ppr_vals, roots, cfg, graph.num_nodes)


def annotate(adj: torch.Tensor, overflow: torch.Tensor, nodes: torch.Tensor,
             ppr_vals: torch.Tensor, roots: torch.Tensor, cfg: SamplerConfig,
             num_nodes: int) -> SubgraphBatch:
    """The SubgraphBatch of an induced block ``adj`` [B, N, N] f32 whose
    padding rows are zero: the local target indices, the target-target
    edges removed (link task), the self edges and the hop or DRNL
    annotation.  Shared with the edge-partitioned induction
    (``parallel/edgepart.py``)."""
    with span("sgnn.stage.annotate"):
        node_mask = nodes < num_nodes
        size = node_mask.sum(-1)
        # local target indices: left search in the sorted node table
        targets = torch.searchsorted(nodes, roots)
        # remove target<->target edges (kept for T == 1); the indicator is
        # the sum of the targets' one-hots, as JAX's (2 where a negative
        # edge repeats its node)
        if cfg.num_targets > 1 and not cfg.include_target_conn:
            t_any = torch.zeros_like(node_mask, dtype=adj.dtype).scatter_add_(
                1, targets, torch.ones(targets.shape, dtype=adj.dtype,
                                       device=adj.device))
            adj = adj * (1.0 - t_any[:, :, None] * t_any[:, None, :])
        if cfg.add_self_edge:
            eye = torch.eye(nodes.shape[1], device=adj.device)
            adj = torch.maximum(adj, eye[None] * node_mask[:, None, :] * node_mask[:, :, None])
        hop = torch.full_like(nodes, -1)
        drnl = torch.zeros_like(nodes)
        if "hops" in cfg.aug_feats:
            if cfg.num_targets != 1:
                raise ValueError("hops augment needs a single target")
            with span("sgnn.stage.bfs"):
                hop = bfs_hops(adj, targets[:, 0], node_mask)
        if "drnls" in cfg.aug_feats:
            if cfg.num_targets != 2:
                raise ValueError("drnls augment needs two targets")
            with span("sgnn.stage.bfs"):
                drnl = drnl_labels(adj, targets, node_mask)
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
