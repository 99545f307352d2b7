"""PyTorch port, the link task's data and sampling, held EXACTLY against
the JAX package on the same inputs: the synthetic link dataset and its
on-disk round trip (with and without ``valedges_as_input``), the
stochastic PPR sampler ``ppr_st`` given JAX's own uniforms (and, on the
port's own generator, its sample size and a chi-square test of its
first pick), the multi-source BFS and the DRNL labels and one-hots
(against tests/oracle.py too), two-target induction with ``drnls`` on a
uniform graph and under a hub plan on a power-law graph, and
``plan_ppr_induction(num_targets=2)``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import oracle
from shadow_gnn_tpu.data import format as jfmt
from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
from shadow_gnn_tpu.data.graph import DeviceGraph as JGraph
from shadow_gnn_tpu.data.loader import load_data as j_load
from shadow_gnn_tpu.data.synthetic import make_random_graph
from shadow_gnn_tpu.sampling import batch as jbatch
from shadow_gnn_tpu.sampling import induction as jind
from shadow_gnn_tpu.sampling import ppr as jppr
from shadow_gnn_tpu.sampling.batch import SamplerConfig as JConfig
from shadow_gnn_tpu.sampling.samplers import PPRTables as JTables
from shadow_gnn_tpu.sampling.samplers import sample_nodes_ppr_st as j_ppr_st
from shadow_gnn_torch import TEST, TRAIN, VALID
from shadow_gnn_torch.data import format as tfmt
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.data.graph import DeviceGraph as TGraph
from shadow_gnn_torch.data.loader import load_data as t_load
from shadow_gnn_torch.sampling import batch as tbatch
from shadow_gnn_torch.sampling import induction as tind
from shadow_gnn_torch.sampling.batch import SamplerConfig as TConfig
from shadow_gnn_torch.sampling.samplers import PPRTables as TTables
from shadow_gnn_torch.sampling.samplers import sample_nodes_ppr_st as t_ppr_st
from shadow_gnn_torch.sampling.samplers import sample_subgraphs

torch.set_num_threads(2)
LINK_GRAPH = dict(num_nodes=300, avg_deg=8.0, num_feat=8, seed=2, task="link")


def test_synthetic_link_dataset_identical():
    a, b = j_make(**LINK_GRAPH), t_make(**LINK_GRAPH)
    assert b.prediction_task == "link" and b.node_set is None and b.label_full is None
    for f in ("indptr_full", "indices_full", "feat_full"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    for m in (TRAIN, VALID, TEST):
        assert set(b.edge_set[m]) == set(a.edge_set[m])
        for k in a.edge_set[m]:
            np.testing.assert_array_equal(b.edge_set[m][k], a.edge_set[m][k])
    # the held-out positives left the message graph
    src = np.repeat(np.arange(300), np.diff(b.indptr_full))
    keys = set((src * 300 + b.indices_full).tolist())
    for m in (VALID, TEST):
        u, v = b.edge_set[m]["pos"].T
        assert not keys & set((u * 300 + v).tolist())


@pytest.mark.parametrize("with_val", [False, True])
def test_link_save_load_round_trip_matches_jax(tmp_path, with_val):
    """save_shadow_format with the ``_with_val`` adjacency, then
    load_data (forced transductive; ``valedges_as_input`` reads the
    ``_with_val`` graph): the port's RawGraph equals JAX's."""
    g = t_make(**LINK_GRAPH)
    # the message graph plus the VALID positives, both directions
    pos = g.edge_set[VALID]["pos"]
    src = np.repeat(np.arange(300), np.diff(g.indptr_full))
    ip_v, ix_v = tfmt.to_undirected_csr(*_csr(np.r_[src, pos[:, 0]],
                                              np.r_[g.indices_full, pos[:, 1]], 300))
    kw = dict(indptr=g.indptr_full, indices=g.indices_full, feat=g.feat_full,
              label=None, edge_set=g.edge_set, indptr_with_val=ip_v,
              indices_with_val=ix_v)
    tfmt.save_shadow_format(str(tmp_path / "t"), "toy", **kw)
    jfmt.save_shadow_format(str(tmp_path / "j"), "toy", **kw)
    for f in ("adj_full_raw.npy", "adj_full_raw_with_val.npy", "split.npy",
              "feat_full.npy"):
        assert (tmp_path / "t" / "toy" / f).read_bytes() == \
            (tmp_path / "j" / "toy" / f).read_bytes(), f
    cfg = {"to_undirected": True, "transductive": False,
           "valedges_as_input": with_val}
    a = j_load(str(tmp_path / "j"), "toy", cfg, printf=lambda *_: None)
    b = t_load(str(tmp_path / "t"), "toy", cfg, printf=lambda *_: None)
    assert b.is_transductive and b.prediction_task == "link" and b.indptr_train is None
    for f in ("indptr_full", "indices_full", "feat_full"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    for m in (TRAIN, VALID, TEST):
        for k in a.edge_set[m]:
            np.testing.assert_array_equal(b.edge_set[m][k], a.edge_set[m][k])
    assert b.indices_full.size == (ix_v.size if with_val else g.indices_full.size)


def _csr(src, dst, n):
    order = np.lexsort((dst, src))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=n))])
    return indptr.astype(np.int64), dst[order].astype(np.int64)


@pytest.fixture(scope="module")
def link_case():
    """The link graph, both packages' device graphs and node-indexed PPR
    tables of every node at k_tab 24 (the 2k pool of k 12)."""
    g = t_make(**LINK_GRAPH)
    n = g.num_nodes
    neighs, scores = jppr.ppr_push_host(g.indptr_full, g.indices_full,
                                        np.arange(n), 24, 0.85, 1e-6)
    tab_n, tab_s = jppr.ppr_topk_tables(neighs, scores, 24)
    return dict(g=g, jg=JGraph.from_csr(g.indptr_full, g.indices_full),
                tg=TGraph.from_csr(g.indptr_full, g.indices_full),
                jt=JTables(jnp.asarray(tab_n), jnp.asarray(tab_s)),
                tt=TTables(torch.as_tensor(tab_n.astype(np.int64)),
                           torch.as_tensor(tab_s)),
                tab_n=tab_n, tab_s=tab_s)


def _edges(g, m=24, seed=0):
    """m edges [m, 2]: TRAIN positives and random pairs."""
    rng = np.random.default_rng(seed)
    return np.r_[g.edge_set[TRAIN]["pos"][: m // 2],
                 rng.integers(0, g.num_nodes, (m - m // 2, 2))].astype(np.int64)


@pytest.mark.parametrize("k", [8, 12])
@pytest.mark.parametrize("threshold", [0.0, 0.01])
def test_ppr_st_matches_jax_given_its_uniforms(link_case, k, threshold):
    """ppr_st on 2k-wide tables with JAX's own draw of u: the node
    tables and scores equal JAX's exactly (T = 2, rows = node ids)."""
    c = link_case
    roots = _edges(c["g"])
    cfg = dict(method="ppr_st", n_pad=-(-2 * (k + 1) // 8) * 8, num_targets=2,
               k=k, threshold=threshold)
    tab_w = 2 * k
    jt = JTables(c["jt"].neighs[:, :tab_w], c["jt"].scores[:, :tab_w])
    tt = TTables(c["tt"].neighs[:, :tab_w], c["tt"].scores[:, :tab_w])
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        u = jax.random.uniform(key, (roots.size, tab_w), minval=1e-12, maxval=1.0)
        jn, js = j_ppr_st(JConfig(**cfg), c["jg"], jnp.asarray(roots, jnp.int32),
                          jnp.asarray(roots, jnp.int32), jt, key)
        tn, ts = t_ppr_st(TConfig(**cfg), c["tg"], torch.as_tensor(roots),
                          torch.as_tensor(roots), tt, u=torch.as_tensor(np.array(u)))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        # both targets are in every scope; the race drew more than top-k
        assert all(set(r) <= set(row) for r, row in zip(roots, tn.numpy()))


def test_ppr_st_sample_size_counting(link_case):
    """tests/test_sampling.py's sample-size case on the port's own
    generator: n_keep = min(n_pass + 1, min(avail, k)) entries of the
    2k pool, plus the force-included target."""
    c = link_case
    k, threshold = 8, 0.3
    targets = np.array([3, 50, 200, 250])
    tt = TTables(c["tt"].neighs[:, :2 * k], c["tt"].scores[:, :2 * k])
    cfg = TConfig(method="ppr_st", n_pad=k + 2, k=k, threshold=threshold)
    gen = torch.Generator().manual_seed(0)
    roots = torch.as_tensor(targets[:, None])
    for _ in range(3):
        nodes, _ = t_ppr_st(cfg, c["tg"], roots, roots, tt, gen)
        for i, t in enumerate(targets):
            ss = oracle.ppr_st_sample_size(c["tab_n"][t], c["tab_s"][t], k, threshold)
            got = set(nodes[i][nodes[i] < 300].tolist())
            assert len(got) in (ss, ss + 1), (i, len(got), ss)
            assert int(t) in got


def test_ppr_st_first_pick_distribution(link_case):
    """With n_keep = 1 (nothing passes the threshold), the one pick of
    the race is entry i with probability s_i / sum(s), over 20,000 draws
    from the port's generator: chi-square p > 1e-3."""
    c = link_case
    t = int(np.argmax((c["tab_n"] >= 0).sum(1)))
    row_n, row_s = c["tab_n"][t], c["tab_s"][t]
    width = int((row_n >= 0).sum())
    assert width >= 12
    cfg = TConfig(method="ppr_st", n_pad=8, k=24, threshold=1e9)
    reps = 20_000
    roots = torch.full((reps, 1), t, dtype=torch.int64)
    nodes, _ = t_ppr_st(cfg, c["tg"], roots, roots, c["tt"],
                        torch.Generator().manual_seed(1))
    nodes = nodes.numpy()
    assert ((nodes < 300).sum(1) <= 2).all()
    # the pick: the member other than the target, or the target itself
    pick = np.where((nodes[:, 1] < 300) & (nodes[:, 0] == t), nodes[:, 1],
                    np.where(nodes[:, 0] != t, nodes[:, 0], t))
    counts = np.array([(pick == v).sum() for v in row_n[:width]])
    assert counts.sum() == reps
    s = row_s[:width].astype(np.float64)
    p = s / s.sum()
    assert scipy.stats.chisquare(counts, reps * p).pvalue > 1e-3


def _blocks(seed=0, b=10, n=24):
    """Random symmetric 0/1 blocks [b, n, n] with padding rows, some
    isolated nodes and disconnected halves; targets [b, 2]."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((b, n, n), np.float32)
    mask = np.zeros((b, n), bool)
    targets = np.zeros((b, 2), np.int64)
    for i in range(b):
        size = rng.integers(6, n + 1)
        mask[i, :size] = True
        a = (rng.random((size, size)) < 0.15).astype(np.float32)
        if i % 3 == 0:                      # two components
            a[: size // 2, size // 2:] = 0
            a[size // 2:, : size // 2] = 0
        a = np.triu(a, 1)
        adj[i, :size, :size] = a + a.T
        targets[i] = rng.choice(size, 2, replace=False)
        if i % 3 == 0:
            targets[i] = [0, size - 1]
    return adj, mask, targets


def test_bfs_multi_and_drnl_match_jax_and_oracle():
    adj, mask, targets = _blocks()
    jd = jind.bfs_hops_multi(jnp.asarray(adj), jnp.asarray(targets, jnp.int32),
                             jnp.asarray(mask))
    td = tind.bfs_hops_multi(torch.as_tensor(adj), torch.as_tensor(targets),
                             torch.as_tensor(mask))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jl = jind.drnl_labels(jnp.asarray(adj), jnp.asarray(targets, jnp.int32),
                          jnp.asarray(mask))
    tl = tind.drnl_labels(torch.as_tensor(adj), torch.as_tensor(targets),
                          torch.as_tensor(mask))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for i in range(adj.shape[0]):
        size = int(mask[i].sum())
        want = oracle.drnl_dense(adj[i, :size, :size], *targets[i])
        np.testing.assert_array_equal(tl[i, :size].numpy(), want)
        assert (tl[i, size:] == 255).all()
    # unreachable nodes and disconnected targets were exercised
    assert (tl.numpy() == 255).any() and (tl.numpy()[mask] == 255).any()
    assert (tl.numpy()[::3][mask[::3]] == 255).all()
    oh_j = jbatch.drnl2onehot(jl)
    oh_t = tbatch.drnl2onehot(tl)
    np.testing.assert_array_equal(oh_t.numpy(), np.asarray(oh_j))
    assert oh_t.shape[-1] == tbatch.DIM_1HOT_DRNL == jbatch.DIM_1HOT_DRNL == 26
    edge = torch.tensor([-3, 0, 1, 25, 26, 254, 255])
    np.testing.assert_array_equal(tbatch.drnl2onehot(edge).numpy(),
                                  np.asarray(jbatch.drnl2onehot(jnp.asarray(edge.numpy()))))


def _compare_induce(jg, tg, nodes, roots, cfg):
    ppr = np.random.default_rng(1).random(nodes.shape).astype(np.float32)
    jb = jind.induce(jg, jnp.asarray(nodes, jnp.int32), jnp.asarray(ppr),
                     jnp.asarray(roots, jnp.int32), JConfig(**cfg))
    tb = tind.induce(tg, torch.as_tensor(nodes), torch.as_tensor(ppr),
                     torch.as_tensor(roots), TConfig(**cfg))
    for f in ("adj", "targets", "drnl", "hop", "node_mask", "size"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert tb.overflow == int(jb.overflow)
    return tb


def test_induce_two_targets_uniform(link_case):
    """induce with drnls at T = 2 from the ppr scopes of edges and
    random pairs (one a self pair, whose indicator is 2 in JAX): block,
    targets and drnl equal JAX's; target-target edges are gone."""
    c = link_case
    roots = _edges(c["g"])
    roots[-1] = [7, 7]
    cfg = dict(method="ppr", n_pad=32, num_targets=2, k=12, aug_feats=("drnls",),
               induction="rows", deg_cap=64)
    rows = torch.as_tensor(roots)
    tb = sample_subgraphs(TConfig(**cfg), c["tg"], rows, rows,
                          TTables(c["tt"].neighs[:, :12], c["tt"].scores[:, :12]))
    tb2 = _compare_induce(c["jg"], c["tg"], tb.nodes.numpy(), roots, cfg)
    t = tb2.targets
    assert (tb2.adj[torch.arange(t.shape[0]), t[:, 0], t[:, 1]] == 0).all()
    drnl = tb2.drnl.numpy()[tb2.node_mask.numpy()]
    assert (drnl == 255).any() and (drnl == 1).any()


@pytest.fixture(scope="module")
def power_case():
    """A 20,000-node power-law graph; the PPR scopes (k 100, n_pad 208)
    of 24 edges at its hubs' neighbourhoods; JAX's plan for T = 2."""
    n = 20_000
    indptr, indices = make_random_graph(n, 10.0, seed=0, power_law=True)
    deg = np.diff(indptr)
    src = np.repeat(np.arange(n), deg)
    rng = np.random.default_rng(0)
    pick = rng.choice(np.flatnonzero((src < 200) & (indices > src)), 24, replace=False)
    roots = np.stack([src[pick], indices[pick]], 1).astype(np.int64)
    targets = np.unique(roots)
    neighs, scores = jppr.ppr_push_host(indptr, indices, targets, 100, 0.85, 1e-5)
    tab_n, tab_s = jppr.ppr_topk_tables(neighs, scores, 100)
    scope_deg = deg[np.clip(tab_n, 0, n - 1)] * (tab_n >= 0)
    kw = dict(n_pad=208, num_targets=2, batch_size=16, undirected=True,
              row_block=32)
    jplan = jind.plan_ppr_induction(scope_deg, deg[targets], **kw)
    tplan = tind.plan_ppr_induction(scope_deg, deg[targets], **kw)
    rows = np.searchsorted(targets, roots)
    return dict(jg=JGraph.from_csr(indptr, indices), tg=TGraph.from_csr(indptr, indices),
                roots=roots, rows=rows, tab=(tab_n, tab_s), plans=(jplan, tplan),
                deg=deg, scope_deg=scope_deg, root_deg=deg[targets])


def test_plan_two_targets_matches_jax(power_case):
    jplan, tplan = power_case["plans"]
    assert tplan == jplan and tplan["hub_slots"] > 0
    for nt, bs, und in ((1, 16, True), (2, 256, True), (2, 16, False)):
        kw = dict(n_pad=208, num_targets=nt, batch_size=bs, undirected=und,
                  row_block=32)
        args = (power_case["scope_deg"], power_case["root_deg"])
        assert tind.plan_ppr_induction(*args, **kw) == jind.plan_ppr_induction(*args, **kw)


def test_induce_two_targets_hub_plan(power_case, monkeypatch):
    """induce with drnls at T = 2 under JAX's hub plan on the power-law
    graph: block, targets, drnl and overflow equal JAX's, and scopes
    hold members above deg_cap."""
    from shadow_gnn_torch.sampling.samplers import sample_nodes_ppr
    c = power_case
    monkeypatch.setattr(tind, "ROWS_GATHER_BUDGET", 64 * 2**20)
    cfg = dict(method="ppr", n_pad=208, num_targets=2, k=100, aug_feats=("drnls",),
               **c["plans"][0])
    tab = TTables(torch.as_tensor(c["tab"][0].astype(np.int64)),
                  torch.as_tensor(c["tab"][1]))
    nodes, _ = sample_nodes_ppr(TConfig(**cfg), c["tg"], torch.as_tensor(c["roots"]),
                                torch.as_tensor(c["rows"]), tab)
    tb = _compare_induce(c["jg"], c["tg"], nodes.numpy(), c["roots"], cfg)
    nd = nodes.numpy()
    member_deg = c["deg"][np.minimum(nd, 19_999)] * (nd < 20_000)
    assert (member_deg > cfg["deg_cap"]).any()
    assert tb.overflow == 0 and (tb.drnl.numpy()[tb.node_mask.numpy()] > 1).any()
