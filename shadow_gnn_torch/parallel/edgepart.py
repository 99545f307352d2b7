"""The edge-partitioned graph: CSR, features and PPR tables row-sharded.

The port of the JAX package's ``parallel/edgepart.py``
(``--partition edge``).  The full-graph CSR is split into contiguous
row (node) ranges, one a rank (:func:`shard_csr`), so that neither a
papers100M-class adjacency (1.6B edges) nor its feature table is
replicated.  Every structure access is a boundary exchange over the
process group (``parallel/collectives.py``), by JAX's pattern: the
queried ids are all-gathered, each rank answers for the rows it owns
(zero elsewhere) and a sum reduce-scatter returns each rank its own
answers:

* :func:`fetch_adj_rows` — the first ``fetch_cap`` neighbours and the
  degree of arbitrary nodes (one reduce-scatter for both);
* :func:`fetch_degrees` / :func:`fetch_at_offsets` — the khop sampler's
  two-phase form (degree, then ``r % deg`` offsets drawn locally);
* :func:`fetch_edge_queries` — (u -> v)? answered by u's owner by
  binary search: the hub x hub tier.

:func:`induce_edgepart` builds the subgraph blocks from the fetched
rows with the semantics of the single-card ``hub`` strategy
(undirected graphs; exact ``cand`` with ``fetch_cap >= max_deg`` and
``hub_slots = 0``).  :func:`make_edgepart_train_step` is the train (and
evaluation) step with the CSR, the feature table and the PPR tables all
row-sharded; table rows come through the same gather as feature rows.
The feature exchange's reduce-scatter is issued asynchronously before
the induction, which does not depend on it, and waited for after: JAX's
overlap intent, without further machinery.

:func:`ring_spmm` is the distributed Y = A X with A's edges bucketed by
(row owner, column owner) (:func:`bucket_edges`) and X's row chunks
passed around the ring with ``batch_isend_irecv``; each step's
exchange is started before that step's local aggregation.
:func:`make_ring_spmm` and :func:`distributed_outcome_correlation`
(Correct & Smooth's propagation) build on it.  These run inside a
process group of ``n_shards`` ranks and raise by name outside one.

JAX's ``shard_map`` step is :func:`make_edgepart_train_step`'s static
step, which a Trainer whose group is NCCL captures in a CUDA graph with
every exchange above (the asynchronous reduce-scatter joined on the
stream); nothing in it reads a device value on the host.  The epoch
scan and ``put_global`` have no counterpart: one process a device.

The ring's jitted programs are CUDA graphs too (``train/graphs.py:
StepGraphs``, one set an operator, registered for ``release_all``): a
product of :func:`make_ring_spmm` (the ring and the row gather) under
the key ``("ring", F)``, and the whole ``n_prop`` loop of
:func:`make_outcome_correlation` (JAX's ``shard_map`` scan) under
``("cs", n_prop, F, alpha, use_norm, clamp)``.  Their inputs are static
buffers written before each call; each key's first call is its eager
warm-up (it also makes c10d's send / receive communicators), the second
is captured, every later one replays.  Under capture a chunk's transfer
stays on NCCL's stream while ``index_add_`` runs on the capturing one: a
fork in the graph, JAX's ``ppermute`` overlap.  A gloo group and the CPU
run the same functions eagerly.  With ``n_shards=1`` outside a group the
collectives answer locally (``parallel/collectives.py``) and the ring is
one local product.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from shadow_gnn_torch.parallel import collectives as cc
from shadow_gnn_torch.parallel import multihost as mh
from shadow_gnn_torch.parallel.partition import (local_rows, make_step, shard_table,
                                                 sharded_feat_gather)
from shadow_gnn_torch.sampling.batch import SamplerConfig, SubgraphBatch, sort_dedup
from shadow_gnn_torch.sampling.induction import _locate, _scatter_block, annotate
from shadow_gnn_torch.sampling.samplers import (PPRTables, _dedup_with_scores,
                                                sample_nodes_iid, sample_nodes_ppr,
                                                sample_nodes_ppr_st)
from shadow_gnn_torch.train.graphs import StepGraphs


def require_group(n_shards: int, what: str):
    """Raise unless this process is a rank of a group of ``n_shards``."""
    if mh.world_size() != n_shards or (n_shards > 1 and mh.backend() is None):
        raise RuntimeError(
            f"{what} with n_shards={n_shards} runs inside a process group of "
            f"{n_shards} ranks (parallel/multihost.initialize); this process is "
            f"in a group of {mh.world_size()}")


# ---------------------------------------------------------------------------
# host-side partitioning
# ---------------------------------------------------------------------------

class ShardedCSR(NamedTuple):
    """Row-range partitioned CSR, stacked on a leading shard axis (numpy).

    indptr  [S, N_local + 1] int32  per-shard indptr, rebased to 0
    indices [S, E_max] int32        per-shard neighbour ids, zero-padded
    n_local                         rows per shard (num_nodes padded up)
    search_steps                    binary-search steps covering max_deg
    """

    indptr: np.ndarray
    indices: np.ndarray
    n_local: int
    search_steps: int


def shard_csr(indptr: np.ndarray, indices: np.ndarray, n_shards: int) -> ShardedCSR:
    """Split a CSR into ``n_shards`` contiguous row ranges.  Padding rows
    (to a multiple of n_shards) have degree 0; per-shard index buffers
    are padded to the largest shard's edge count."""
    n = indptr.size - 1
    nl = -(-n // n_shards)
    full = np.asarray(indptr)
    if nl * n_shards > n:
        full = np.concatenate(
            [full, np.full(nl * n_shards - n, full[-1], full.dtype)])
    lows = full[np.arange(n_shards) * nl]
    highs = full[(np.arange(n_shards) + 1) * nl]
    e_max = max(1, int((highs - lows).max()))
    ptr_sh = np.empty((n_shards, nl + 1), np.int32)
    idx_sh = np.zeros((n_shards, e_max), np.int32)
    for s in range(n_shards):
        ptr_sh[s] = (full[s * nl:(s + 1) * nl + 1] - lows[s]).astype(np.int32)
        idx_sh[s, : highs[s] - lows[s]] = indices[lows[s]:highs[s]]
    deg = np.diff(indptr)
    max_deg = int(deg.max()) if n else 1
    steps = max(1, int(np.ceil(np.log2(max_deg + 1))) + 1)
    return ShardedCSR(ptr_sh, idx_sh, nl, steps)


def local_csr(csr: ShardedCSR, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's (indptr, indices) of ``csr`` as int64 on ``device``."""
    r = mh.rank()
    return (torch.as_tensor(csr.indptr[r].astype(np.int64), device=device),
            torch.as_tensor(csr.indices[r].astype(np.int64), device=device))


# ---------------------------------------------------------------------------
# collective structure accesses
# ---------------------------------------------------------------------------

def _owned(nodes_all: torch.Tensor, n_local: int, num_nodes: int):
    """(local row ids clipped, ownership mask) for this rank's range."""
    local = nodes_all - mh.rank() * n_local
    own = (local >= 0) & (local < n_local) & (nodes_all < num_nodes)
    return torch.clamp(local, 0, n_local - 1), own


def _at(idx: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return idx[torch.clamp(pos, 0, idx.shape[0] - 1)]


def fetch_degrees(indptr_local: torch.Tensor, nodes: torch.Tensor, n_local: int,
                  num_nodes: int) -> torch.Tensor:
    """Degrees of arbitrary global node ids (sentinel / padding -> 0)."""
    lc, own = _owned(cc.all_gather(nodes), n_local, num_nodes)
    deg = torch.where(own, indptr_local[lc + 1] - indptr_local[lc], 0)
    return cc.reduce_scatter_sum(deg)


def fetch_adj_rows(csr_ptr: torch.Tensor, csr_idx: torch.Tensor, nodes: torch.Tensor,
                   deg_cap: int, n_local: int, num_nodes: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First ``deg_cap`` neighbours and the true degree of global node
    ids ``nodes`` [...].  Returns (nbrs [..., deg_cap] global ids,
    ascending, ``num_nodes`` beyond the row; deg [...]).  One rank owns
    each id, so a sum of (id + 1) answers (0 = none) rebuilds the rows;
    the degrees ride in the same reduce-scatter."""
    lc, own = _owned(cc.all_gather(nodes), n_local, num_nodes)
    lo = torch.where(own, csr_ptr[lc], 0)
    deg = torch.where(own, csr_ptr[lc + 1] - csr_ptr[lc], 0)
    j = torch.arange(deg_cap, device=nodes.device)
    take = j < torch.clamp(deg, max=deg_cap)[..., None]
    nb = torch.where(take, _at(csr_idx, lo[..., None] + j) + 1, 0)
    got = cc.reduce_scatter_sum(torch.cat([nb, deg[..., None]], -1))
    nbrs, deg_out = got[..., :deg_cap], got[..., deg_cap]
    return torch.where(nbrs > 0, nbrs - 1, num_nodes), deg_out


def fetch_at_offsets(csr_ptr: torch.Tensor, csr_idx: torch.Tensor, nodes: torch.Tensor,
                     offsets: torch.Tensor, n_local: int, num_nodes: int
                     ) -> torch.Tensor:
    """``indices[indptr[node] + offset]`` for nodes [...] and offsets
    [..., M]; offsets out of the row give ``num_nodes``."""
    lc, own = _owned(cc.all_gather(nodes), n_local, num_nodes)
    off_all = cc.all_gather(offsets)
    lo = torch.where(own, csr_ptr[lc], 0)
    deg = torch.where(own, csr_ptr[lc + 1] - csr_ptr[lc], 0)
    take = own[..., None] & (off_all >= 0) & (off_all < deg[..., None])
    nb = torch.where(take, _at(csr_idx, lo[..., None] + torch.clamp(off_all, min=0))
                     + 1, 0)
    out = cc.reduce_scatter_sum(nb)
    return torch.where(out > 0, out - 1, num_nodes)


def fetch_edge_queries(csr_ptr: torch.Tensor, csr_idx: torch.Tensor, uq: torch.Tensor,
                       vq: torch.Tensor, n_local: int, num_nodes: int,
                       search_steps: int) -> torch.Tensor:
    """Whether each directed edge (u -> v) exists (bool [...]): u's owner
    binary-searches v in its local row, ``search_steps`` steps."""
    lc, own = _owned(cc.all_gather(uq), n_local, num_nodes)
    v_all = cc.all_gather(vq)
    lo = torch.where(own, csr_ptr[lc], 0)
    hi = torch.where(own, csr_ptr[lc + 1], 0)
    hi_end = hi
    for _ in range(search_steps):
        mid = (lo + hi) // 2
        ge = _at(csr_idx, mid) >= v_all
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    found = own & (lo < hi_end) & (_at(csr_idx, lo) == v_all)
    return cc.reduce_scatter_sum(found.to(torch.int32)) > 0


# ---------------------------------------------------------------------------
# local induction from fetched rows
# ---------------------------------------------------------------------------

def rows_to_adj(nodes: torch.Tensor, nbrs: torch.Tensor, deg: torch.Tensor,
                cand_cap: int, deg_cap: int, num_nodes: int):
    """[B, N, N] bool blocks from fetched neighbour rows.

    nodes [B, N] sorted ids (``num_nodes`` = padding), nbrs [B, N, D]
    the fetched rows, deg [B, N] the true degrees.  Members above
    ``deg_cap`` are hubs: their truncated rows are ignored (their edges
    come from the small side once mirrored, and from the hub tier).  The
    other members' entries are the candidates, in (member, position)
    order; those beyond ``cand_cap`` a subgraph are dropped and counted.
    Returns (adj, is_hub [B, N], overflow: a 0-d int64 tensor)."""
    b, n = nodes.shape
    d = nbrs.shape[-1]
    row_valid = nodes < num_nodes
    is_hub = (deg > deg_cap) & row_valid
    dgc = torch.where(row_valid & ~is_hub, torch.clamp(deg, max=d), 0)
    csum = torch.cumsum(dgc, -1)
    overflow = torch.clamp(csum[:, -1] - cand_cap, min=0).sum()
    j = torch.arange(d, device=nodes.device)
    valid = (j < dgc[..., None]) & ((csum - dgc)[..., None] + j < cand_cap)
    loc, hit = _locate(nodes, nbrs.reshape(b, -1), valid.reshape(b, -1))
    row = torch.arange(n, device=nodes.device).repeat_interleave(d)
    adj = _scatter_block(b, n, row.expand(b, -1), loc, hit)
    return adj & row_valid[:, :, None], is_hub, overflow


def induce_edgepart(csr: Tuple[torch.Tensor, torch.Tensor], nodes: torch.Tensor,
                    ppr_vals: torch.Tensor, roots: torch.Tensor, cfg: SamplerConfig,
                    n_local: int, num_nodes: int, search_steps: int,
                    fetch_cap: int) -> SubgraphBatch:
    """Distributed node-induced subgraphs: the neighbour rows arrive by
    one collective fetch, the hub x hub pairs by one query collective;
    the compaction, the mirror, self edges, target-edge removal and the
    hop / DRNL annotations are local."""
    csr_ptr, csr_idx = csr
    b, n = nodes.shape
    nbrs, deg = fetch_adj_rows(csr_ptr, csr_idx, nodes, fetch_cap, n_local, num_nodes)
    cand_cap = cfg.cand_cap if cfg.cand_cap > 0 else n * fetch_cap
    adj, is_hub, overflow = rows_to_adj(nodes, nbrs, deg, cand_cap, fetch_cap,
                                        num_nodes)
    # undirected mirror: a small -> hub edge was found from the small side
    adj = adj | adj.transpose(1, 2)
    h = cfg.hub_slots
    if h > 0:
        deg_eff = torch.where(is_hub, deg, -1)
        order = torch.sort(-deg_eff, dim=-1, stable=True)[1][:, :h]
        h = order.shape[1]
        hub_valid = torch.gather(is_hub, 1, order)
        overflow = overflow + torch.clamp(is_hub.sum(-1) - h, min=0).sum()
        hnodes = torch.where(hub_valid, torch.gather(nodes, 1, order), num_nodes)
        exists = fetch_edge_queries(
            csr_ptr, csr_idx, hnodes[:, :, None].expand(b, h, h),
            hnodes[:, None, :].expand(b, h, h), n_local, num_nodes, search_steps)
        s = exists & hub_valid[:, :, None] & hub_valid[:, None, :]
        rows = order[:, :, None].expand(b, h, h).reshape(b, -1)
        cols = order[:, None, :].expand(b, h, h).reshape(b, -1)
        adj = adj | _scatter_block(b, n, rows, cols, s.reshape(b, -1))
    adj = (adj & (nodes < num_nodes)[:, :, None]).float()
    return annotate(adj, overflow, nodes, ppr_vals, roots, cfg, num_nodes)


def sample_nodes_khop_edgepart(cfg: SamplerConfig,
                               csr: Tuple[torch.Tensor, torch.Tensor],
                               roots: torch.Tensor, n_local: int, num_nodes: int,
                               generator: Optional[torch.Generator] = None,
                               picks: Optional[List[torch.Tensor]] = None):
    """Budgeted k-hop scope over the sharded CSR, distributed exactly as
    ``samplers.sample_nodes_khop``: the degrees by one collective, the
    ``r % deg`` offsets drawn locally (from ``generator``, or ``picks``
    [B, width, budget] a level), then the chosen slots by a second."""
    sent = num_nodes
    csr_ptr, csr_idx = csr
    b = roots.shape[0]
    budget = cfg.budget
    levels, cur = [roots], roots
    j = torch.arange(budget, device=roots.device)
    for lvl in range(cfg.depth):
        deg = fetch_degrees(csr_ptr, cur, n_local, sent)[..., None]
        if picks is None:
            r = torch.randint(0, 1 << 30, cur.shape + (budget,), generator=generator,
                              device=roots.device)
        else:
            r = picks[lvl].to(roots.device, torch.int64)
        off = torch.where(deg <= budget, j, r % torch.clamp(deg, min=1))
        off = torch.where(off < deg, off, -1)
        cur = sort_dedup(fetch_at_offsets(csr_ptr, csr_idx, cur, off, n_local,
                                          sent).reshape(b, -1), sent)
        levels.append(cur)
    ids = torch.cat(levels, -1)
    return _dedup_with_scores(ids, torch.zeros(ids.shape, device=ids.device), sent,
                              cfg.n_pad)


# ---------------------------------------------------------------------------
# distributed full-graph SpMM (ring)
# ---------------------------------------------------------------------------

def bucket_edges(src: np.ndarray, dst: np.ndarray, val: np.ndarray,
                 num_rows: int, n_shards: int):
    """Partition an edge list for the ring SpMM (host side).

    Edges go to the shard owning their src row; within a shard they are
    bucketed by the shard owning their dst column.  Bucket (i, q) is
    processed at ring step s = (q - i) mod S, when shard i holds x-chunk
    q.  Returns (srcb, dstb, valb [S, S, E_b], n_local) with src rebased
    to the shard, dst to the chunk, zero-valued padding."""
    nl = -(-num_rows // n_shards)
    own = src // nl
    buck = dst // nl
    gid = own * n_shards + buck
    order = np.argsort(gid, kind="stable")
    gid_s = gid[order]
    n_groups = n_shards * n_shards
    counts = np.bincount(gid_s, minlength=n_groups)
    e_b = max(1, int(counts.max()))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(gid_s.size) - starts[gid_s]
    flat_pos = gid_s * e_b + within
    srcb = np.zeros((n_groups * e_b,), np.int32)
    dstb = np.zeros((n_groups * e_b,), np.int32)
    valb = np.zeros((n_groups * e_b,), np.float32)
    srcb[flat_pos] = (src[order] - own[order] * nl).astype(np.int32)
    dstb[flat_pos] = (dst[order] - buck[order] * nl).astype(np.int32)
    valb[flat_pos] = val[order]
    shape = (n_shards, n_shards, e_b)
    return srcb.reshape(shape), dstb.reshape(shape), valb.reshape(shape), nl


def ring_spmm(x_local: torch.Tensor, srcb: torch.Tensor, dstb: torch.Tensor,
              valb: torch.Tensor) -> torch.Tensor:
    """Y = A X with A edge-partitioned and X row-sharded: x_local
    [n_local, F] this rank's rows; srcb / dstb (int64) / valb [S, E_b]
    this rank's buckets.  The X chunks travel round the ring; each
    step's send / receive starts before its local ``index_add_``, which
    does not depend on it."""
    s_dev, i = mh.world_size(), mh.rank()
    nl = x_local.shape[0]
    y = torch.zeros_like(x_local)
    chunk = x_local
    for s in range(s_dev):
        nxt = cc.ring_shift(chunk) if s < s_dev - 1 else None
        q = (i + s) % s_dev
        y.index_add_(0, srcb[q], valb[q][:, None] * chunk[torch.clamp(dstb[q], 0, nl - 1)])
        if nxt is not None:
            chunk = nxt.wait()
    return y


class _RingOperator:
    """This rank's buckets of A on ``device``, for :func:`ring_spmm`, and
    the CUDA graphs of the functions run over them (:meth:`run`): on a
    card outside a group or in an NCCL group, unless ``cuda_graphs`` is
    False (the eager twin); a gloo group stages through host memory and
    runs eagerly."""

    def __init__(self, src, dst, val, num_rows: int, device, cuda_graphs: bool = True):
        srcb, dstb, valb, self.nl = bucket_edges(src, dst, val, num_rows,
                                                 mh.world_size())
        r = mh.rank()
        self.num_rows, self.device = num_rows, torch.device(device)
        self.srcb = torch.as_tensor(srcb[r].astype(np.int64), device=device)
        self.dstb = torch.as_tensor(dstb[r].astype(np.int64), device=device)
        self.valb = torch.as_tensor(valb[r], device=device)
        self.graphs = StepGraphs(self.device, cuda_graphs and mh.backend() != "gloo")

    def local(self, x_full) -> torch.Tensor:
        """This rank's rows of a host or device [num_rows, F] array."""
        r, nl = mh.rank(), self.nl
        x = torch.as_tensor(np.asarray(x_full, np.float32) if isinstance(
            x_full, np.ndarray) else x_full)
        part = x[r * nl:(r + 1) * nl].to(self.device, torch.float32)
        if part.shape[0] < nl:
            part = torch.cat([part, part.new_zeros((nl - part.shape[0],)
                                                   + tuple(part.shape[1:]))])
        return part

    def __call__(self, x_local: torch.Tensor) -> torch.Tensor:
        return ring_spmm(x_local, self.srcb, self.dstb, self.valb)

    def gather(self, y_local: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, in order, cut to ``num_rows``."""
        return cc.all_gather_rows(y_local)[:self.num_rows]

    def run(self, key: tuple, fn, **inputs: torch.Tensor):
        """``fn(buf)`` over the static buffers ``buf`` of ``key``, into
        which ``inputs`` (this rank's rows) are written first, through
        the operator's graphs: its outputs are static on a graphed
        operator, to be read before the key's next call."""
        buf = self.graphs.inputs(key, **inputs)
        return self.graphs.run(key, (), lambda: fn(buf))


def _ring_device(device):
    """The ring's device: the caller's, else the rank's, else the card."""
    return device if device is not None else (mh.device() or "cuda")


def make_ring_spmm(src: np.ndarray, dst: np.ndarray, val: np.ndarray,
                   num_rows: int, n_devices: int, device=None,
                   cuda_graphs: bool = True):
    """``fn(x) -> y``, the distributed Y[src] += val * X[dst] over the
    ``n_devices`` ranks of the process group, or with ``n_devices`` 1
    over this process (``ops/spmm.py:spmm_edges`` semantics): x
    [num_rows, F] on the host or a device, the same on every rank; y
    [num_rows, F], a new tensor, on every rank, on ``device`` (default
    the rank's, else the card).  Each product after a width's first is
    a replay of its graph (:class:`_RingOperator`; ``fn.graphs``);
    ``cuda_graphs`` False runs every one eagerly."""
    require_group(n_devices, "the ring SpMM")
    op = _RingOperator(src, dst, val, num_rows, _ring_device(device), cuda_graphs)

    def product(x):
        x_local = op.local(x)
        return op.run(("ring", x_local.shape[1]), lambda buf: op.gather(op(buf["x"])),
                      x=x_local).clone()
    product.graphs = op.graphs
    return product


def make_outcome_correlation(indptr, indices, n_devices: int, device=None,
                             cuda_graphs: bool = True):
    """``fn(y0, n_prop=50, alpha=0.8, use_norm=False, clamp=(0, 1))``:
    Correct & Smooth's propagation (``postproc/cns.py``'s semantics: the
    DGL mean over in-edges with reverse and self edges) with the
    propagation matrix edge-partitioned and Y row-sharded over the
    ``n_devices`` ranks, [num_rows, F] on the ring's device (static on
    a graphed operator: read it before the key's next call; ``y0`` a
    host or device array).  Each call runs ``n_prop`` ring
    SpMMs with only elementwise work between them and gathers the rows
    at the end: JAX's ``shard_map`` scan, one CUDA graph a key after its
    first call (the scaling, ``alpha``, the clamp and the gather in it;
    ``y0`` and the degrees in static buffers).  Every rank passes the
    same ``y0`` and gets the whole result.  Built once, it serves every
    prediction matrix of a C&S run; its ``graphs`` are the operator's."""
    from shadow_gnn_torch.postproc.cns import _cs_edges

    require_group(n_devices, "the distributed Correct & Smooth")
    n = indptr.size - 1
    src, dst = _cs_edges(indptr, indices)
    in_deg = np.zeros(n, np.float32)
    np.add.at(in_deg, dst, 1.0)
    in_deg = np.clip(in_deg, 1.0, None)
    w = (1.0 / in_deg[dst]).astype(np.float32)
    # rows = dst (the aggregation target), gather src
    op = _RingOperator(dst.astype(np.int64), src.astype(np.int64), w, n,
                       _ring_device(device), cuda_graphs)
    deg = op.local(np.pad(in_deg, (0, op.nl * mh.world_size() - n),
                          constant_values=1.0)[:, None])

    def smooth(y0: np.ndarray, n_prop: int = 50, alpha: float = 0.8,
               use_norm: bool = False, clamp=(0.0, 1.0)) -> torch.Tensor:
        clamp = None if clamp is None else tuple(clamp)

        def scan(buf):
            y0_l = buf["y0"]
            y = y0_l
            for _ in range(n_prop):
                if use_norm:
                    y = y * torch.rsqrt(deg)
                y = op(y)
                if use_norm:
                    y = y * torch.sqrt(deg)
                y = alpha * y + (1 - alpha) * y0_l
                if clamp is not None:
                    y = torch.clamp(y, clamp[0], clamp[1])
            return op.gather(y)

        y0_l = op.local(y0)
        key = ("cs", n_prop, y0_l.shape[1], alpha, use_norm, clamp)
        return op.run(key, scan, y0=y0_l)
    smooth.graphs = op.graphs
    return smooth


def distributed_outcome_correlation(indptr, indices, y0: np.ndarray,
                                    n_prop: int = 50, alpha: float = 0.8,
                                    use_norm: bool = False,
                                    clamp=(0.0, 1.0), n_devices: int = 8,
                                    device=None) -> np.ndarray:
    """One call of :func:`make_outcome_correlation`'s function: the
    edge-partitioned C&S propagation of ``y0`` over the ``n_devices``
    ranks; every rank passes the same ``y0`` and gets the whole
    result."""
    return make_outcome_correlation(indptr, indices, n_devices, device)(
        y0, n_prop, alpha, use_norm, clamp).cpu().numpy()


# ---------------------------------------------------------------------------
# the train step (graph, features and tables all partitioned)
# ---------------------------------------------------------------------------

def make_edgepart_train_step(trainer, mode: int, train: bool = True):
    """``--partition edge``: the step of ``parallel/partition.py:make_step``
    with the mode's CSR, the feature table (in the trainer's
    ``feat_dtype``) and the PPR tables row-sharded over the ranks; the
    per-batch exchanges are the table rows, the adjacency rows, the
    hub-pair queries (when the plan has hub slots) and the feature rows.
    ``train=False``: the evaluation form.  A directed graph is refused
    (the mirror of :func:`induce_edgepart` needs every edge's reverse).
    The host-side set-up (``shard_csr``, the tables' ``local_rows``, the
    maximum degree) runs here, once.  Returns (step, the rank's CSR
    shard)."""
    trainer._ensure_tables(mode)
    if not trainer.undirected:
        raise ValueError("the edge-partitioned path requires an undirected graph "
                         "(like the 'hub' induction)")
    dev, world = trainer.device, mh.world_size()
    indptr, indices = trainer._host_adj[mode]
    num_nodes = trainer.num_nodes
    csr = shard_csr(np.asarray(indptr), np.asarray(indices), world)
    csr_loc = local_csr(csr, dev)
    max_deg = int(np.diff(indptr).max()) if num_nodes else 1
    dt = torch.bfloat16 if trainer.feat_dtype == "bfloat16" else torch.float32
    feat_local = shard_table(trainer.feat_np, dev, dt)
    cfgs = [br["cfg"][mode] for br in trainer.branches]
    # a branch's plan caps the fetched rows (rows / hub); else the max degree
    caps = [max(1, min(cfg.deg_cap if cfg.induction in ("hub", "rows")
                       and cfg.deg_cap > 0 else max_deg, max_deg)) for cfg in cfgs]
    # the PPR tables row-sharded; their rows come through the feature
    # rows' collective
    tabs = []
    for cfg, t in zip(cfgs, trainer.tables[mode]):
        if t is None or cfg.method not in ("ppr", "ppr_st"):
            tabs.append(None)
            continue
        tabs.append((t.neighs.shape[0],
                     torch.as_tensor(local_rows(t.neighs.cpu().numpy(), world,
                                                mh.rank()), device=dev),
                     torch.as_tensor(local_rows(t.scores.cpu().numpy(), world,
                                                mh.rank()), device=dev)))
    meta = SimpleNamespace(num_nodes=num_nodes)
    dtype = trainer.model_cfg.dtype

    def sample_all(roots, rows, gen):
        batches, feats = [], []
        for i, cfg in enumerate(cfgs):
            if cfg.method in ("ppr", "ppr_st"):
                n_rows, tn, ts = tabs[i]
                rq = torch.clamp(rows, max=n_rows - 1)
                b, t = rq.shape
                tab = PPRTables(sharded_feat_gather(tn, rq).reshape(b * t, -1),
                                sharded_feat_gather(ts, rq).reshape(b * t, -1))
                trow = torch.arange(b * t, device=rq.device).reshape(b, t)
                if cfg.method == "ppr":
                    nodes, sc = sample_nodes_ppr(cfg, meta, roots, trow, tab)
                else:
                    nodes, sc = sample_nodes_ppr_st(cfg, meta, roots, trow, tab, gen)
            elif cfg.method == "nodeIID":
                nodes, sc = sample_nodes_iid(cfg, meta, roots)
            elif cfg.method == "khop":
                nodes, sc = sample_nodes_khop_edgepart(cfg, csr_loc, roots,
                                                       csr.n_local, num_nodes, gen)
            else:
                raise ValueError(f"edge-partitioned path: unsupported sampler "
                                 f"{cfg.method}")
            # the feature exchange first: the induction does not read it
            pending = sharded_feat_gather(
                feat_local, torch.clamp(nodes, max=num_nodes - 1), async_op=True)
            batches.append(induce_edgepart(csr_loc, nodes, sc, roots, cfg,
                                           csr.n_local, num_nodes, csr.search_steps,
                                           caps[i]))
            feats.append(pending.wait().to(dtype))
        return batches, feats

    deps = (feat_local, *csr_loc, *(t for tab in tabs if tab for t in tab[1:]))
    return make_step(trainer, mode, train, sample_all, deps), csr_loc
