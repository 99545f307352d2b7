"""Subgraph samplers on device tensors.

Each sampler dedups its scope into a sorted, padded node table that
:func:`induce` turns into a dense subgraph block:

sampler  reference                     here
-------  ----------------------------  ---------------------------------
ppr      ParallelSampler.cpp:565-595   top-k table row gather, threshold
ppr_st   cpp:603-650                   exponential race over a 2k pool
khop     cpp:510-556                   per-level budgeted random picks
nodeIID  cpp:498-508                   the targets only

The khop picks and the ppr_st uniforms come from an explicit
``torch.Generator`` on the graph's device, or are passed in (``picks``,
``u``), so that a test can hand the port the JAX package's own draws.
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


def sample_nodes_ppr_st(cfg: SamplerConfig, graph: DeviceGraph,
                        roots: torch.Tensor, table_rows: torch.Tensor,
                        tables: PPRTables,
                        generator: Optional[torch.Generator] = None,
                        u: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic PPR scope (cpp:603-650): ``n_keep`` table entries
    drawn with probability proportional to their score, by the
    exponential race (top of log(u)/s), plus the target, which is forced
    in.  ``n_keep = min(n_pass + 1, min(avail, k))``: the C++ counts the
    first entry that fails the threshold too.  The race runs over the
    whole (2k-wide) row; only its first k places can be kept.  ``u``
    [B*T, width] in [1e-12, 1) comes from ``generator`` or is passed in.
    """
    b, t = roots.shape
    flat = table_rows.reshape(-1)
    neighs, scores = tables.neighs[flat], tables.scores[flat]
    avail = (neighs >= 0).sum(-1)
    n_pass = _ppr_keep_mask(scores, avail, cfg.threshold, cfg.k).sum(-1)
    n_keep = torch.minimum(n_pass + 1, torch.clamp(avail, max=cfg.k))
    if u is None:
        u = torch.rand(scores.shape, generator=generator, device=scores.device)
        u = torch.clamp(u * (1.0 - 1e-12) + 1e-12, min=1e-12)
    else:
        u = u.to(scores.device, torch.float32)
    key = torch.where(scores > 0, torch.log(u) / torch.clamp(scores, min=1e-30),
                      torch.full_like(scores, -float("inf")))
    # race order, best first; ties are score-0 padding, beyond n_keep
    _, ids_r, sc_r = _stable_sort_by(-key, neighs, scores)
    ids_r, sc_r = ids_r[..., :cfg.k], sc_r[..., :cfg.k]
    sel = torch.arange(ids_r.shape[-1], device=ids_r.device)[None, :] < n_keep[:, None]
    sent = graph.num_nodes
    ids = torch.where(sel, ids_r, torch.full_like(ids_r, sent)).reshape(b, -1)
    sc = torch.where(sel, sc_r, torch.zeros_like(sc_r)).reshape(b, -1)
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
                     picks: Optional[List[torch.Tensor]] = None,
                     u: Optional[torch.Tensor] = None) -> SubgraphBatch:
    """Sample + induce one batch of subgraphs: ``ppr`` reads the tables
    at ``table_rows``, ``ppr_st`` races over them with uniforms from
    ``generator`` (or takes ``u``), ``khop`` draws from ``generator`` (or
    takes ``picks``), ``nodeIID`` needs neither."""
    if cfg.method == "ppr":
        nodes, ppr_vals = sample_nodes_ppr(cfg, graph, roots, table_rows, tables)
    elif cfg.method == "ppr_st":
        nodes, ppr_vals = sample_nodes_ppr_st(cfg, graph, roots, table_rows,
                                              tables, generator, u)
    elif cfg.method == "khop":
        nodes, ppr_vals = sample_nodes_khop(cfg, graph, roots, generator, picks)
    elif cfg.method == "nodeIID":
        nodes, ppr_vals = sample_nodes_iid(cfg, graph, roots)
    else:
        raise NotImplementedError(f"sampler {cfg.method!r} is not ported yet")
    return induce(graph, nodes, ppr_vals, roots, cfg)
