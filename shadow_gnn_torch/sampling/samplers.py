"""Subgraph samplers on device tensors.

Each sampler dedups its scope into a sorted, padded node table that
:func:`induce` turns into a dense subgraph block:

sampler  reference                     here
-------  ----------------------------  ---------------------------------
ppr      ParallelSampler.cpp:565-595   top-k table row gather, threshold
khop     cpp:510-556                   per-level budgeted random picks
nodeIID  cpp:498-508                   the targets only

The khop picks come from an explicit ``torch.Generator`` on the graph's
device, or are passed in (``picks``), so that a test can hand the port
the JAX package's own draws.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from shadow_gnn_torch.data.graph import DeviceGraph
from shadow_gnn_torch.sampling.batch import SamplerConfig, SubgraphBatch, sort_dedup
from shadow_gnn_torch.sampling.induction import induce


class PPRTables(NamedTuple):
    """Per-target top-k PPR tables, row-aligned with the mode's target set.

    neighs [T, k] int64 (pad -1) — neighbour ids by descending score
    scores [T, k] f32   (pad 0)
    """

    neighs: torch.Tensor
    scores: torch.Tensor


def _stable_sort_by(key: torch.Tensor, *vals: torch.Tensor):
    """Stable ascending sort of ``key`` along the last axis, carrying
    ``vals`` with it."""
    key_s, order = torch.sort(key, dim=-1, stable=True)
    return (key_s,) + tuple(torch.gather(v, -1, order) for v in vals)


def _dedup_with_scores(ids: torch.Tensor, scores: torch.Tensor, sentinel: int,
                       n_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort ids ascending, dedup keeping the max score per id, pad to n_pad.

    The (id asc, score desc) order is two stable sorts: score descending
    first, then id.  Entries equal in both keys are identical, so any
    order among them gives the same result as the JAX lexicographic sort.
    """
    _, ids1, sc1 = _stable_sort_by(-scores, ids, scores)
    ids2, sc2 = _stable_sort_by(ids1, sc1)
    prev = torch.cat([torch.full_like(ids2[..., :1], -1), ids2[..., :-1]], -1)
    dup = ids2 == prev
    ids3 = torch.where(dup, torch.full_like(ids2, sentinel), ids2)
    sc3 = torch.where(dup, torch.zeros_like(sc2), sc2)
    m = ids.shape[-1]
    if m > n_pad:
        # score-aware truncation: keep the highest-score entries (targets
        # carry score < 0 = always keep; sentinels rank last)
        pri = torch.where(ids3 == sentinel, torch.full_like(sc3, -float("inf")),
                          torch.where(sc3 < 0, torch.full_like(sc3, float("inf")),
                                      sc3))
        _, ids3, sc3 = _stable_sort_by(-pri, ids3, sc3)
        ids3, sc3 = ids3[..., :n_pad], sc3[..., :n_pad]
    ids4, sc4 = _stable_sort_by(ids3, sc3)
    if m < n_pad:
        pad = n_pad - m
        ids4 = torch.nn.functional.pad(ids4, (0, pad), value=sentinel)
        sc4 = torch.nn.functional.pad(sc4, (0, pad))
    return ids4, sc4


def _ppr_keep_mask(scores: torch.Tensor, avail: torch.Tensor, threshold: float,
                   k_rule: int) -> torch.Tensor:
    """Threshold cut of cpp:583-586: keep entry i < min(avail, k_rule)
    while scores[i]/max_ppr >= threshold, where max_ppr = scores[1] (or
    0 when fewer than 2 entries, which keeps nothing beyond the
    target)."""
    k = scores.shape[-1]
    idx = torch.arange(k, device=scores.device)
    cap = torch.clamp(avail, max=k_rule)
    in_range = idx[None, :] < cap[:, None]
    if k >= 2:
        max_ppr = torch.where(cap > 1, scores[:, 1], torch.zeros_like(scores[:, 1]))
    else:
        max_ppr = torch.zeros(scores.shape[:-1], dtype=scores.dtype,
                              device=scores.device)
    pass_thresh = (max_ppr[:, None] > 0) & (scores >= threshold * max_ppr[:, None])
    return in_range & pass_thresh


def sample_nodes_ppr(cfg: SamplerConfig, graph: DeviceGraph,
                     roots: torch.Tensor, table_rows: torch.Tensor,
                     tables: PPRTables) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic top-k PPR scope.

    roots       [B, T] global target ids
    table_rows  [B, T] row index of each target in ``tables``
    """
    b, t = roots.shape
    flat = table_rows.reshape(-1)
    neighs, scores = tables.neighs[flat], tables.scores[flat]
    if neighs.shape[-1] > cfg.k:
        # a wider table (2k pool): only the first k positions can pass
        neighs, scores = neighs[..., :cfg.k], scores[..., :cfg.k]
    avail = (neighs >= 0).sum(-1)
    keep = _ppr_keep_mask(scores, avail, cfg.threshold, k_rule=cfg.k)
    sent = graph.num_nodes
    ids = torch.where(keep, neighs, torch.full_like(neighs, sent)).reshape(b, -1)
    sc = torch.where(keep, scores, torch.zeros_like(scores)).reshape(b, -1)
    # the target itself is always in scope
    ids = torch.cat([roots, ids], -1)
    sc = torch.cat([torch.full((b, t), -1.0, device=sc.device), sc], -1)
    return _dedup_with_scores(ids, sc, sent, cfg.n_pad)


def sample_nodes_khop(cfg: SamplerConfig, graph: DeviceGraph,
                      roots: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      picks: Optional[List[torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Budgeted k-hop expansion (cpp:510-556).

    Per level, each frontier node takes all its neighbours when its
    degree is at most ``budget``, else ``budget`` picks with replacement,
    ``r % deg`` of uniform integers r in [0, 2**30).  Each level is
    sorted and deduplicated before it expands (the C++ frontier is a
    set), so level l is ``[B, T * budget**l]`` wide.  The integers come
    from ``generator`` (on the graph's device), or from ``picks``: one
    ``[B, width, budget]`` integer tensor per level.  Returns the node
    table and zero annotations.
    """
    sent = graph.num_nodes
    b, t = roots.shape
    budget = cfg.budget
    if budget <= 0:
        raise ValueError("khop needs a positive budget")
    levels = [roots]
    cur = roots
    j = torch.arange(budget, device=roots.device)
    for lvl in range(cfg.depth):
        v = torch.clamp(cur, max=sent - 1)
        valid = cur < sent
        lo = graph.indptr[v][..., None]
        deg = graph.indptr[v + 1][..., None] - lo
        if picks is None:
            r = torch.randint(0, 1 << 30, cur.shape + (budget,),
                              generator=generator, device=roots.device)
        else:
            r = picks[lvl].to(roots.device, torch.int64)
        off = torch.where(deg <= budget, j, r % torch.clamp(deg, min=1))
        take = valid[..., None] & (off < deg)
        nbr = graph.indices[torch.clamp(lo + off, 0, max(graph.num_edges - 1, 0))]
        cur = sort_dedup(torch.where(take, nbr, sent).reshape(b, -1), sent)
        levels.append(cur)
    ids = torch.cat(levels, -1)
    return _dedup_with_scores(ids, torch.zeros(ids.shape, device=ids.device),
                              sent, cfg.n_pad)


def sample_nodes_iid(cfg: SamplerConfig, graph: DeviceGraph,
                     roots: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """nodeIID (cpp:498-508): the scope is the targets themselves."""
    return _dedup_with_scores(roots, torch.zeros(roots.shape, device=roots.device),
                              graph.num_nodes, cfg.n_pad)


def sample_subgraphs(cfg: SamplerConfig, graph: DeviceGraph,
                     roots: torch.Tensor, table_rows: Optional[torch.Tensor] = None,
                     tables: Optional[PPRTables] = None,
                     generator: Optional[torch.Generator] = None,
                     picks: Optional[List[torch.Tensor]] = None) -> SubgraphBatch:
    """Sample + induce one batch of subgraphs: ``ppr`` reads the tables
    at ``table_rows``, ``khop`` draws from ``generator`` (or takes
    ``picks``), ``nodeIID`` needs neither."""
    if cfg.method == "ppr":
        nodes, ppr_vals = sample_nodes_ppr(cfg, graph, roots, table_rows, tables)
    elif cfg.method == "khop":
        nodes, ppr_vals = sample_nodes_khop(cfg, graph, roots, generator, picks)
    elif cfg.method == "nodeIID":
        nodes, ppr_vals = sample_nodes_iid(cfg, graph, roots)
    else:
        raise NotImplementedError(f"sampler {cfg.method!r} is not ported yet")
    return induce(graph, nodes, ppr_vals, roots, cfg)
