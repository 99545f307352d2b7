"""PyTorch port: the induction strategies (``rows`` with and without hub
slots, ``hub``, ``cand``, ``search``) and the hub table, held EXACTLY
against the JAX package's functions on the same power-law graphs and
node tables (blocks and overflow, including overflowing sizes); the
``cand`` strategy also on a directed graph; ``induce`` under each
strategy; and the flagship's bit-packed cache on a power-law synthetic
dataset under the Trainer's own hub plan, byte-equal to JAX's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu import TEST
from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
from shadow_gnn_tpu.data.graph import DeviceGraph as JGraph
from shadow_gnn_tpu.data.synthetic import make_random_graph
from shadow_gnn_tpu.sampling import induction as jind
from shadow_gnn_tpu.sampling.batch import SamplerConfig as JConfig
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_tpu.train.logger import Logger
from shadow_gnn_tpu.train.metrics import Metrics
from shadow_gnn_tpu.train.pipeline import Trainer as JTrainer
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.data.graph import DeviceGraph as TGraph
from shadow_gnn_torch.sampling import induction as tind
from shadow_gnn_torch.sampling.batch import SamplerConfig as TConfig
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.pipeline import Trainer as TTrainer

torch.set_num_threads(2)
NUM_NODES, B, N = 800, 12, 48


def _graphs(directed=False, seed=5):
    """The same CSR in both packages: the power-law graph of
    tests/test_sampling.py, or (``directed``) that graph with one
    direction of a third of its edges dropped."""
    indptr, indices = make_random_graph(NUM_NODES, 12.0, seed=seed, power_law=True)
    if directed:
        src = np.repeat(np.arange(NUM_NODES), np.diff(indptr))
        drop = (src < indices) & (np.random.default_rng(seed).random(src.size) < 0.33)
        src, indices = src[~drop], indices[~drop]
        indptr = np.concatenate([[0], np.cumsum(np.bincount(
            src, minlength=NUM_NODES))]).astype(np.int32)
    return (JGraph.from_csr(indptr, indices), TGraph.from_csr(indptr, indices),
            np.diff(indptr))


def _node_tables(seed=0):
    """[B, N] sorted node tables (padding = num_nodes) of 5..N members,
    drawn with a bias to the hubs (the power-law graph's low ids)."""
    rng = np.random.default_rng(seed)
    nodes = np.full((B, N), NUM_NODES, np.int32)
    for b in range(B):
        pool = np.r_[np.arange(20), rng.choice(NUM_NODES, 100, replace=False)]
        picks = np.unique(rng.choice(pool, rng.integers(5, N + 1)))
        nodes[b, :picks.size] = picks
    return jnp.asarray(nodes), torch.as_tensor(nodes.astype(np.int64))


@pytest.fixture(scope="module")
def case():
    jg, tg, deg = _graphs()
    return jg, tg, deg, _node_tables()


def _same(jout, tout):
    (ja, jo), (ta, to) = jout, tout
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert to == int(jo)
    return to


def test_graphs_have_hubs(case):
    _, tg, deg, (_, nt) = case
    assert tg.max_deg == deg.max() > 4 * 64 and (deg > 64).sum() > 5
    assert tg.search_steps == case[0].search_steps
    member_deg = deg[np.minimum(nt.numpy(), NUM_NODES - 1)] * (nt.numpy() < NUM_NODES)
    assert ((member_deg > 64).sum(1) > 4).any()


def test_search_matches_jax(case):
    jg, tg, _, (nj, nt) = case
    want = np.asarray(jind.membership_matrix(jg, nj))
    np.testing.assert_array_equal(tind.membership_matrix(tg, nt).numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("deg_cap,hub_slots", [(64, 1), (64, 4), (64, 48), (128, 3)])
def test_hub_pairs_match_jax(case, deg_cap, hub_slots):
    """The hub table's block and overflow; 1 slot overflows."""
    jg, tg, _, (nj, nt) = case
    n_id = NUM_NODES
    u = jnp.minimum(nj, n_id - 1)
    lo = jnp.where(nj < n_id, jg.indptr[u], 0)
    deg = jnp.where(nj < n_id, jg.indptr[u + 1] - lo, 0)
    ja, jo = jind._hub_pairs(jg, nj, lo, deg, deg_cap, hub_slots)
    _, tlo, tdeg = tind._members(tg, nt)
    ta, to = tind._hub_pairs(tg, nt, tlo, tdeg, deg_cap, hub_slots)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert to == int(jo)
    assert (to > 0) if hub_slots == 1 else ta.sum() > 0
    assert to == 0 if hub_slots == 48 else True


@pytest.mark.parametrize("deg_cap,hub_slots", [(64, 0), (64, 1), (64, 4), (64, 48),
                                               (128, 3), (512, 0)])
def test_rows_match_jax(case, deg_cap, hub_slots):
    """Row induction with and without hub slots, too few slots included;
    with enough slots (or a cap above every degree) the block is the
    exact one."""
    jg, tg, _, (nj, nt) = case
    got = _same(jind.membership_matrix_rows(jg, nj, deg_cap, hub_slots),
                tind.membership_matrix_rows(tg, nt, deg_cap, hub_slots))
    exact = np.asarray(jind.membership_matrix(jg, nj))
    block = tind.membership_matrix_rows(tg, nt, deg_cap, hub_slots)[0].numpy()
    assert (got == 0) == np.array_equal(block, exact)


@pytest.mark.parametrize("cand_cap,deg_cap,hub_slots", [(4096, 64, 4), (200, 64, 4),
                                                        (4096, 64, 1), (4096, 64, 0)])
def test_hub_strategy_matches_jax(case, cand_cap, deg_cap, hub_slots):
    jg, tg, _, (nj, nt) = case
    got = _same(jind.membership_matrix_hub(jg, nj, cand_cap, deg_cap, hub_slots),
                tind.membership_matrix_hub(tg, nt, cand_cap, deg_cap, hub_slots))
    assert got > 0 if cand_cap == 200 or hub_slots == 1 else True


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("cand_cap", [20_000, 300])
def test_cand_matches_jax(directed, cand_cap):
    """Candidate induction on the power-law graph and on its directed
    cut; a cap under the total overflows by Σ_b max(total_b − cap, 0)."""
    jg, tg, deg = _graphs(directed)
    nj, nt = _node_tables(1)
    got = _same(jind.membership_matrix_cand(jg, nj, cand_cap),
                tind.membership_matrix_cand(tg, nt, cand_cap))
    totals = (deg[np.minimum(nt.numpy(), NUM_NODES - 1)]
              * (nt.numpy() < NUM_NODES)).sum(1)
    assert got == np.maximum(totals - cand_cap, 0).sum()
    assert (got > 0) == (cand_cap == 300)
    if cand_cap > totals.max():
        np.testing.assert_array_equal(
            tind.membership_matrix_cand(tg, nt, cand_cap)[0].numpy(),
            tind.membership_matrix(tg, nt).numpy())
    if directed:
        block = tind.membership_matrix(tg, nt).numpy()
        assert not np.array_equal(block, block.transpose(0, 2, 1))


@pytest.mark.parametrize("fields", [
    dict(induction="rows", deg_cap=64, hub_slots=0),
    dict(induction="rows", deg_cap=64, hub_slots=6),
    dict(induction="rows", deg_cap=320, hub_slots=0),
    dict(induction="hub", cand_cap=1024, deg_cap=64, hub_slots=6),
    dict(induction="cand", cand_cap=4096),
    dict(induction="cand", cand_cap=256),
    dict(induction="search"),
])
def test_induce_matches_jax(case, fields):
    """induce under each strategy (self edges, hops): block, targets,
    hops, sizes and overflow exactly."""
    jg, tg, _, (nj, nt) = case
    roots = nt[:, :1].clone()
    kw = dict(method="ppr", n_pad=N, add_self_edge=True, aug_feats=("hops",),
              **fields)
    ppr = np.random.default_rng(2).random((B, N)).astype(np.float32)
    jb = jind.induce(jg, nj, jnp.asarray(ppr), jnp.asarray(roots.numpy(), jnp.int32),
                     JConfig(**kw))
    tb = tind.induce(tg, nt, torch.as_tensor(ppr), roots, TConfig(**kw))
    for f in ("adj", "targets", "hop", "node_mask", "size", "ppr"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert tb.overflow == int(jb.overflow)
    assert tb.overflow > 0 or (tb.hop.numpy() > 1).any()


def test_induction_chunks_agree(case, monkeypatch):
    """Under a budget that splits the batch every strategy gives the same
    block and overflow as in one piece."""
    _, tg, _, (_, nt) = case
    calls = [lambda: tind.membership_matrix_rows(tg, nt, 64, 4),
             lambda: tind.membership_matrix_hub(tg, nt, 300, 64, 2),
             lambda: tind.membership_matrix_cand(tg, nt, 300),
             lambda: (tind.membership_matrix(tg, nt), 0)]
    whole = [fn() for fn in calls]
    monkeypatch.setattr(tind, "ROWS_GATHER_BUDGET", tind.search_bytes(3, N))
    for fn, (a, o) in zip(calls, whole):
        a2, o2 = fn()
        assert torch.equal(a2, a) and o2 == o


# a power-law dataset whose TEST scopes (k=56, n_pad 64, the first 200
# TEST nodes) reach a member of degree ~3000: the plan gives hub slots
POWER_GRAPH = dict(num_nodes=20_000, avg_deg=10.0, num_feat=8, num_classes=4,
                   seed=0, power_law=True)
POWER_CFG = {
    "data": {"to_undirected": True, "transductive": True},
    "architecture": {"dim": 16, "aggr": "sage", "loss": "softmax",
                     "num_layers": 2, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 1, "lr": 1e-3, "dropout": 0.0, "dropedge": 0.0,
                       "batch_size": 16},
    "sampler": [{"method": "ppr", "phase": "train", "k": [56], "epsilon": [1e-5]}],
}


@pytest.fixture(scope="module")
def power_trainers():
    m = Metrics("toy", False, "accuracy", 1)
    jtr = JTrainer("toy", "", j_make(**POWER_GRAPH), j_parse(POWER_CFG), m,
                   Logger(m, "", no_log=True), seed=0, use_device_ppr=False,
                   packed_adj=True)
    ttr = TTrainer("toy", "", t_make(**POWER_GRAPH), t_parse(POWER_CFG), seed=0,
                   device="cpu", packed_adj=True)
    for tr in (jtr, ttr):
        tr.entity_set[TEST] = tr.entity_set[TEST][:200]
        tr._ensure_tables(TEST)
    # the port's [B, N, deg_cap] gather at deg_cap ~2000 in chunks of ~20
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tind, "ROWS_GATHER_BUDGET", 64 * 2**20)
        for tr in (jtr, ttr):
            tr._ensure_caches(TEST)
    return jtr, ttr


def test_power_law_plan_uses_hub_slots(power_trainers):
    jtr, ttr = power_trainers
    jc, tc = jtr.branches[0]["cfg"][TEST], ttr.branches[0]["cfg"][TEST]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.induction == "rows" and tc.hub_slots > 0 and tc.n_pad == 64


def test_power_law_induce_and_cache_exact(power_trainers, monkeypatch):
    """The hub-planned induction of TEST scopes, and the bit-packed cache
    of all 200 TEST roots, byte-equal to JAX (overflow 0)."""
    from shadow_gnn_tpu.sampling.samplers import sample_nodes_ppr as j_sample
    from shadow_gnn_torch.sampling.samplers import sample_nodes_ppr as t_sample
    jtr, ttr = power_trainers
    monkeypatch.setattr(tind, "ROWS_GATHER_BUDGET", 64 * 2**20)
    rows = np.arange(0, 200, 9)[:, None]
    roots = np.asarray(ttr.entity_set[TEST])[rows]
    jc, tc = jtr.branches[0]["cfg"][TEST], ttr.branches[0]["cfg"][TEST]
    jn, js = j_sample(jc, jtr.graph[TEST], jnp.asarray(roots, jnp.int32),
                      jnp.asarray(rows, jnp.int32), jtr.tables[TEST][0])
    tn, ts = t_sample(tc, ttr.graph[TEST], torch.as_tensor(roots),
                      torch.as_tensor(rows), ttr.tables[TEST][0])
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    jb = jind.induce(jtr.graph[TEST], jn, js, jnp.asarray(roots, jnp.int32), jc)
    tb = tind.induce(ttr.graph[TEST], tn, ts, torch.as_tensor(roots), tc)
    for f in ("adj", "targets", "hop"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert tb.overflow == int(jb.overflow) == 0
    deg = ttr.graph[TEST].indptr.diff()[torch.clamp(tn, max=ttr.num_nodes - 1)]
    assert ((deg > tc.deg_cap) & (tn < ttr.num_nodes)).any()
    jcache, tcache = jtr.caches[TEST][0], ttr.caches[TEST][0]
    for f in dataclasses.fields(tcache):
        got, want = getattr(tcache, f.name).numpy(), np.asarray(getattr(jcache, f.name))
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
