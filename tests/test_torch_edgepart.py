"""PyTorch port, the edge-partitioned graph (``shadow_gnn_torch/parallel/
edgepart.py``), the ring SpMM and its users against the JAX package.

JAX runs in this process on the 8-device CPU mesh of
``tests/conftest.py`` (4 of its devices, inside ``shard_map`` as
``tests/test_edgepart.py`` runs it); the port runs in 4 spawned gloo
ranks on the CPU whose functions import neither JAX nor this module's
JAX side.  One spawn runs every structural check and writes
``tmp_path/rank<r>.npz``; a second trains the ``--partition edge``
epoch.  Tolerances:
* exact (integers and bytes): ``shard_csr`` and ``bucket_edges`` (byte
  for byte), ``fetch_degrees`` / ``fetch_adj_rows`` /
  ``fetch_at_offsets`` / ``fetch_edge_queries``, ``induce_edgepart``
  on a plain and a hubby graph (blocks, hops, targets, sizes, overflow),
  the khop edgepart scope with JAX's own picks passed in;
* ``ring_spmm`` at rtol 1e-5 / atol 1e-5 (the two sum each row's
  contributions in other orders); the distributed smoothening (sym and
  ppr) and C&S propagation at rtol 2e-4 / atol 1e-5, as
  ``tests/test_edgepart.py`` holds JAX's against its single-device
  runs;
* the ``edge`` TRAIN epoch with ``tests/test_torch_parallel.py``'s
  tolerances (``check_epoch``).
"""
import os

import numpy as np
import pytest
import torch

from shadow_gnn_torch.parallel import edgepart as ep
from shadow_gnn_torch.parallel import launch
from shadow_gnn_torch.parallel import multihost as mh
from shadow_gnn_torch.sampling.batch import SamplerConfig

WORLD = 4
AXIS = "dp"
FETCH_CAP = 6                      # fetch_adj_rows' cap on the plain graph
KHOP = dict(method="khop", n_pad=64, depth=2, budget=3)
SMOOTH_ARGS = {"alpha": 0.9, "norm_adj": "sym", "itr_max": 5, "thres": 1e-9,
               "norm_feat": "none"}


def undirected_csr(n, avg_deg, rng, hub=None, hub_deg=0):
    """Random symmetric CSR with an optional planted hub (the helper of
    ``tests/test_edgepart.py``)."""
    m = n * avg_deg // 2
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    if hub is not None:
        extra = rng.choice(n, size=hub_deg, replace=False)
        src = np.concatenate([src, np.full(hub_deg, hub)])
        dst = np.concatenate([dst, extra])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    order = np.lexsort((v, u))
    u, v = u[order], v[order]
    dup = np.zeros(u.size, bool)
    dup[1:] = (u[1:] == u[:-1]) & (v[1:] == v[:-1])
    u, v = u[~dup], v[~dup]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr[1:], u, 1)
    return np.cumsum(indptr).astype(np.int64), v.astype(np.int32)


def node_sets(rng, n, b, npad):
    nodes = np.full((b, npad), n, np.int64)
    roots = np.zeros((b, 1), np.int64)
    for i in range(b):
        size = rng.integers(3, npad + 1)
        ids = np.sort(rng.choice(n, size=size, replace=False))
        nodes[i, :size] = ids
        roots[i, 0] = ids[rng.integers(0, size)]
    return nodes, roots


def inputs():
    """Every structural check's inputs, from fixed seeds (numpy only)."""
    rng = np.random.default_rng(0)
    g = undirected_csr(101, 6, rng)
    nodes = rng.integers(0, 101, (8, 5))
    nodes[1, 2] = 101                              # the sentinel
    offsets = rng.integers(-2, 9, (8, 5, 4))
    uq = rng.integers(0, 101, (8, 7))
    vq = np.where(rng.random((8, 7)) < 0.5, rng.integers(0, 101, (8, 7)),
                  g[1][np.minimum(g[0][uq], g[1].size - 1)])
    ind = {}
    for hubby in (False, True):
        r = np.random.default_rng(3 + hubby)
        gi = undirected_csr(96, 5, r, hub=7 if hubby else None,
                            hub_deg=40 if hubby else 0)
        nd, rt = node_sets(r, 96, 8, 12)
        if hubby:
            nd[0, 0] = 7                           # the hub in a scope
            nd[0] = np.sort(nd[0])
            rt[0, 0] = 7
        cap = 8 if hubby else int(np.diff(gi[0]).max())
        ind[hubby] = dict(graph=gi, nodes=nd, roots=rt, cap=cap, cfg=dict(
            method="ppr", n_pad=12, add_self_edge=True, aug_feats=("hops",),
            induction="hub", deg_cap=cap, hub_slots=4 if hubby else 0,
            cand_cap=12 * cap))
    rk = np.random.default_rng(5)
    gk = undirected_csr(80, 4, rk)
    khop_roots = rk.integers(0, 80, (8, 1))
    rs = np.random.default_rng(7)
    spmm = (rs.integers(0, 203, 1200), rs.integers(0, 203, 1200),
            rs.normal(size=1200).astype(np.float32),
            rs.normal(size=(203, 5)).astype(np.float32))
    rsm = np.random.default_rng(8)
    g_sm = undirected_csr(150, 6, rsm)
    sig = rsm.normal(size=(150, 4)).astype(np.float32)
    rc = np.random.default_rng(9)
    g_cs = undirected_csr(120, 5, rc)
    y0 = rc.uniform(size=(120, 6)).astype(np.float32)
    return dict(g=g, nodes=nodes, offsets=offsets, uq=uq, vq=vq, induce=ind,
                gk=gk, khop_roots=khop_roots, spmm=spmm, g_sm=g_sm, sig=sig,
                g_cs=g_cs, y0=y0)


# ---------------------------------------------------------------------------
# the ranks (torch only)
# ---------------------------------------------------------------------------

def rank_structures(picks, out_dir):
    from shadow_gnn_torch.postproc.cns import general_outcome_correlation
    from shadow_gnn_torch.train.preproc import smooth_signal_full
    inp, r = inputs(), mh.rank()
    rows = mh.process_slice(8)

    def mine(a):
        return torch.as_tensor(np.asarray(a)[rows])

    out = {}
    indptr, indices = inp["g"]
    csr = ep.shard_csr(indptr, indices, WORLD)
    ptr, idx = ep.local_csr(csr, "cpu")
    n = indptr.size - 1
    out["deg"] = ep.fetch_degrees(ptr, mine(inp["nodes"]), csr.n_local, n).numpy()
    nb, deg = ep.fetch_adj_rows(ptr, idx, mine(inp["nodes"]), FETCH_CAP, csr.n_local, n)
    out["nbrs"], out["deg2"] = nb.numpy(), deg.numpy()
    out["at"] = ep.fetch_at_offsets(ptr, idx, mine(inp["nodes"]), mine(inp["offsets"]),
                                    csr.n_local, n).numpy()
    out["edges"] = ep.fetch_edge_queries(ptr, idx, mine(inp["uq"]), mine(inp["vq"]),
                                         csr.n_local, n, csr.search_steps).numpy()
    for hubby, case in inp["induce"].items():
        gi = case["graph"]
        c = ep.shard_csr(gi[0], gi[1], WORLD)
        nodes = mine(case["nodes"])
        b = ep.induce_edgepart(ep.local_csr(c, "cpu"), nodes,
                               torch.zeros(nodes.shape), mine(case["roots"]),
                               SamplerConfig(**case["cfg"]), c.n_local,
                               gi[0].size - 1, c.search_steps, case["cap"])
        for k in ("adj", "hop", "targets", "size"):
            out[f"ind{int(hubby)}_{k}"] = getattr(b, k).numpy()
        out[f"ind{int(hubby)}_ovf"] = np.asarray(b.overflow)
    ck = ep.shard_csr(inp["gk"][0], inp["gk"][1], WORLD)
    got, _ = ep.sample_nodes_khop_edgepart(
        SamplerConfig(**KHOP), ep.local_csr(ck, "cpu"), mine(inp["khop_roots"]),
        ck.n_local, inp["gk"][0].size - 1, picks=[torch.as_tensor(p) for p in picks])
    out["khop"] = got.numpy()
    src, dst, val, x = inp["spmm"]
    out["ring"] = ep.make_ring_spmm(src, dst, val, 203, WORLD, "cpu")(x).numpy()
    for norm in ("sym", "ppr"):
        out[f"smooth_{norm}"] = smooth_signal_full(
            *inp["g_sm"], inp["sig"], norm, 2, "concat", SMOOTH_ARGS, "cpu",
            n_shards=WORLD)[0]
    out["cns"] = general_outcome_correlation(*inp["g_cs"], inp["y0"], n_prop=10,
                                             alpha=0.8, use_norm=True, n_shards=WORLD)
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:WORLD]), (AXIS,))


def _smap(fn, n_in, out_specs):
    import jax
    from jax.sharding import PartitionSpec as P
    return jax.jit(jax.shard_map(fn, mesh=_mesh(), in_specs=(P(AXIS),) * n_in,
                                 out_specs=out_specs, check_vma=False))


def khop_picks():
    """The integers JAX's khop edgepart draws on each device from
    PRNGKey(0) (the same on every device: the key is not folded)."""
    import jax
    rng, picks = jax.random.PRNGKey(0), []
    for lvl in range(KHOP["depth"]):
        rng, sub = jax.random.split(rng)
        picks.append(np.asarray(jax.random.randint(
            sub, (8 // WORLD, KHOP["budget"] ** lvl, KHOP["budget"]), 0, 1 << 30)))
    return picks


def jax_structures():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from shadow_gnn_tpu.parallel import edgepart as jep
    from shadow_gnn_tpu.postproc.cns import general_outcome_correlation
    from shadow_gnn_tpu.sampling.batch import SamplerConfig as JCfg
    from shadow_gnn_tpu.train.preproc import smooth_signal_full
    inp, want = inputs(), {}
    indptr, indices = inp["g"]
    csr = jep.shard_csr(indptr, indices, WORLD)
    n = indptr.size - 1
    i32 = lambda a: jnp.asarray(np.asarray(a), jnp.int32)   # noqa: E731
    sq = lambda p, i: (p[0], i[0])                           # noqa: E731
    want["deg"] = _smap(lambda p, nd: jep.fetch_degrees(p[0], nd, csr.n_local, n, AXIS),
                        2, P(AXIS))(csr.indptr, i32(inp["nodes"]))
    want["nbrs"], want["deg2"] = _smap(
        lambda p, i, nd: jep.fetch_adj_rows(p[0], i[0], nd, FETCH_CAP, csr.n_local, n,
                                            AXIS), 3, (P(AXIS), P(AXIS)))(
        csr.indptr, csr.indices, i32(inp["nodes"]))
    want["at"] = _smap(
        lambda p, i, nd, off: jep.fetch_at_offsets(p[0], i[0], nd, off, csr.n_local, n,
                                                   AXIS), 4, P(AXIS))(
        csr.indptr, csr.indices, i32(inp["nodes"]), i32(inp["offsets"]))
    want["edges"] = _smap(
        lambda p, i, u, v: jep.fetch_edge_queries(p[0], i[0], u, v, csr.n_local, n,
                                                  csr.search_steps, AXIS), 4, P(AXIS))(
        csr.indptr, csr.indices, i32(inp["uq"]), i32(inp["vq"]))
    for hubby, case in inp["induce"].items():
        gi = case["graph"]
        c = jep.shard_csr(gi[0], gi[1], WORLD)
        cfg = JCfg(**case["cfg"])

        def run(p, i, nds, rts, c=c, cfg=cfg, case=case, ng=gi[0].size - 1):
            b = jep.induce_edgepart(sq(p, i), nds, jnp.zeros_like(nds, jnp.float32),
                                    rts, cfg, c.n_local, ng, c.search_steps,
                                    case["cap"], AXIS)
            return (b.adj, b.hop, b.targets, b.size, jax.lax.psum(b.overflow, AXIS))
        res = _smap(run, 4, (P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()))(
            c.indptr, c.indices, i32(case["nodes"]), i32(case["roots"]))
        for k, v in zip(("adj", "hop", "targets", "size", "ovf"), res):
            want[f"ind{int(hubby)}_{k}"] = v
    ck = jep.shard_csr(inp["gk"][0], inp["gk"][1], WORLD)
    want["khop"] = _smap(
        lambda p, i, rts: jep.sample_nodes_khop_edgepart(
            JCfg(**KHOP), sq(p, i), rts, jax.random.PRNGKey(0), ck.n_local,
            inp["gk"][0].size - 1, AXIS)[0], 3, P(AXIS))(
        ck.indptr, ck.indices, i32(inp["khop_roots"]))
    src, dst, val, x = inp["spmm"]
    want["ring"] = jep.make_ring_spmm(src, dst, val, 203, WORLD)(x)
    for norm in ("sym", "ppr"):
        want[f"smooth_{norm}"] = smooth_signal_full(
            *inp["g_sm"], inp["sig"], norm, 2, "concat", SMOOTH_ARGS, n_shards=WORLD)
    want["cns"] = general_outcome_correlation(*inp["g_cs"], inp["y0"], n_prop=10,
                                              alpha=0.8, use_norm=True,
                                              n_shards=WORLD)
    return {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module")
def structures(tmp_path_factory):
    """(JAX's outputs, the 4 ranks' outputs)."""
    tmp = tmp_path_factory.mktemp("edgepart")
    launch.spawn(rank_structures, WORLD, "cpu", (khop_picks(), str(tmp)), threads=1)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return jax_structures(), ranks


def _rows(ranks, key):
    """The per-rank rows of ``key`` in rank order."""
    return np.concatenate([r[key] for r in ranks])


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, shards", [(101, 8), (101, 4), (96, 3)])
def test_shard_csr_matches_jax(n, shards):
    from shadow_gnn_tpu.parallel.edgepart import shard_csr as j_shard
    indptr, indices = undirected_csr(n, 6, np.random.default_rng(n))
    got, want = ep.shard_csr(indptr, indices, shards), j_shard(indptr, indices, shards)
    assert got.indptr.tobytes() == np.asarray(want.indptr).tobytes()
    assert got.indices.tobytes() == np.asarray(want.indices).tobytes()
    assert got.indptr.shape == want.indptr.shape
    assert (got.n_local, got.search_steps) == (want.n_local, want.search_steps)


@pytest.mark.parametrize("shards", [4, 3])
def test_bucket_edges_matches_jax(shards):
    from shadow_gnn_tpu.parallel.edgepart import bucket_edges as j_bucket
    rng = np.random.default_rng(shards)
    src, dst = rng.integers(0, 203, 1200), rng.integers(0, 203, 1200)
    val = rng.normal(size=1200).astype(np.float32)
    got, want = ep.bucket_edges(src, dst, val, 203, shards), j_bucket(src, dst, val,
                                                                      203, shards)
    for g, w in zip(got[:3], want[:3]):
        assert g.tobytes() == w.tobytes() and g.shape == w.shape and g.dtype == w.dtype
    assert got[3] == want[3]


def test_fetches_match_jax(structures):
    want, ranks = structures
    for key in ("deg", "nbrs", "deg2", "at", "edges"):
        np.testing.assert_array_equal(_rows(ranks, key), want[key], err_msg=key)
    assert want["edges"].any() and not want["edges"].all()


@pytest.mark.parametrize("hubby", [0, 1])
def test_induce_edgepart_matches_jax(structures, hubby):
    want, ranks = structures
    for k in ("adj", "hop", "targets", "size"):
        np.testing.assert_array_equal(_rows(ranks, f"ind{hubby}_{k}"),
                                      want[f"ind{hubby}_{k}"], err_msg=k)
    assert sum(int(r[f"ind{hubby}_ovf"]) for r in ranks) == int(want[f"ind{hubby}_ovf"])


def test_khop_edgepart_matches_jax(structures):
    """budget 3 below the max degree: the picks matter, and JAX's own
    integers (``khop_picks``) give JAX's scope."""
    want, ranks = structures
    np.testing.assert_array_equal(_rows(ranks, "khop"), want["khop"])


@pytest.mark.parametrize("key, rtol, atol", [
    ("ring", 1e-5, 1e-5), ("smooth_sym", 2e-4, 1e-5), ("smooth_ppr", 2e-4, 1e-5),
    ("cns", 2e-4, 1e-5)])
def test_ring_spmm_and_its_users_match_jax(structures, key, rtol, atol):
    """Every rank gets the whole result: the ring SpMM, the smoothening
    with ``n_shards`` (sym-2-concat, ppr) and the C&S propagation."""
    want, ranks = structures
    for r in ranks:
        np.testing.assert_allclose(r[key], want[key], rtol=rtol, atol=atol)


def test_outside_a_group_raises_by_name():
    from shadow_gnn_torch.postproc.cns import general_outcome_correlation
    indptr, indices = undirected_csr(20, 4, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="n_shards=4 runs inside a process group"):
        ep.make_ring_spmm(np.zeros(1, np.int64), np.zeros(1, np.int64),
                          np.ones(1, np.float32), 20, 4, "cpu")
    with pytest.raises(RuntimeError, match="distributed Correct & Smooth"):
        general_outcome_correlation(indptr, indices, np.zeros((20, 2), np.float32),
                                    n_shards=2, device="cpu")


def test_edge_epoch_matches_jax(tmp_path):
    """``--partition edge``: CSR, features and PPR tables row-sharded;
    the first TRAIN epoch and the VALID stats against JAX's edge Trainer
    and the port's single-card epoch."""
    from test_torch_parallel import check_epoch, jax_epoch, single_epoch, spawn_epoch
    want = jax_epoch("edge", packed=False)
    ranks = spawn_epoch(tmp_path, "edge", want["init"], packed=False)
    check_epoch(ranks, want, single_epoch(want["init"], packed=False))


def test_edge_refuses_a_directed_graph():
    """On a one-rank group: a directed graph is refused by name."""
    from shadow_gnn_torch.data import make_synthetic_dataset
    from shadow_gnn_torch.train.config import parse_config
    from shadow_gnn_torch.train.pipeline import Trainer
    from test_torch_parallel import CFG
    g = make_synthetic_dataset(num_nodes=200, avg_deg=6, num_feat=8, num_classes=4,
                               seed=0)
    keep = np.ones(g.indices_full.size, bool)
    keep[0] = False                                  # drop one direction of an edge
    deg = np.diff(g.indptr_full)
    deg[np.searchsorted(g.indptr_full, 0, side="right") - 1] -= 1
    import dataclasses
    g = dataclasses.replace(g, indices_full=g.indices_full[keep],
                            indptr_full=np.concatenate([[0], np.cumsum(deg)]))
    mh.initialize(f"127.0.0.1:{mh.free_port()}", 1, 0, device="cpu")
    try:
        tr = Trainer("toy", "", g, parse_config(CFG), seed=0, device="cpu",
                     use_device_ppr=False, partition="edge")
        assert not tr.undirected
        with pytest.raises(ValueError, match="requires an undirected graph"):
            ep.make_edgepart_train_step(tr, 0)
    finally:
        mh.shutdown()
