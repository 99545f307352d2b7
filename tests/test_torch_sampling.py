"""PyTorch port: PPR tables, the PPR sampler, row induction (with and
without the self edges GAT forces), the induction plan and the
bit-packed cache, held EXACTLY against the JAX package on the same graph
and the same inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_gnn_tpu import TEST, TRAIN
from shadow_gnn_tpu.data import make_synthetic_dataset as j_make
from shadow_gnn_tpu.sampling import cache as jcache
from shadow_gnn_tpu.sampling.induction import induce as j_induce
from shadow_gnn_tpu.sampling.samplers import sample_nodes_ppr as j_sample
from shadow_gnn_tpu.train.config import parse_config as j_parse
from shadow_gnn_tpu.train.logger import Logger
from shadow_gnn_tpu.train.metrics import Metrics
from shadow_gnn_tpu.train.pipeline import Trainer as JTrainer
from shadow_gnn_torch.data import make_synthetic_dataset as t_make
from shadow_gnn_torch.sampling import cache as tcache
from shadow_gnn_torch.sampling import ppr as tppr
from shadow_gnn_torch.sampling.induction import induce as t_induce
from shadow_gnn_torch.sampling.samplers import sample_nodes_ppr as t_sample
from shadow_gnn_torch.train.config import parse_config as t_parse
from shadow_gnn_torch.train.pipeline import Trainer as TTrainer

torch.set_num_threads(2)

# the flagship SAGE-3 PPR config at test size: 600 nodes, k=16 (n_pad 24)
CFG = {
    "data": {"to_undirected": False, "transductive": True},
    "architecture": {"dim": 32, "aggr": "sage", "loss": "softmax",
                     "num_layers": 3, "act": "relu", "feature_augment": "hops",
                     "residue": "none", "pooling": "center"},
    "hyperparameter": {"end": 1, "lr": 5e-4, "dropout": 0.45,
                       "dropedge": 0.05, "batch_size": 32},
    "sampler": [{"method": "ppr", "phase": "train", "k": [16],
                 "epsilon": [1e-5]}],
}
GRAPH = dict(num_nodes=600, avg_deg=8, num_feat=16, num_classes=5, seed=3)


def _trainers(cfg):
    m = Metrics("toy", False, "accuracy", 1)
    jtr = JTrainer("toy", "", j_make(**GRAPH), j_parse(cfg), m,
                   Logger(m, "", no_log=True), seed=0,
                   use_device_ppr=False, packed_adj=True)
    ttr = TTrainer("toy", "", t_make(**GRAPH), t_parse(cfg), seed=0,
                   device="cpu", packed_adj=True)
    for tr in (jtr, ttr):
        tr._ensure_tables(TEST)
        tr._ensure_caches(TEST)
    return jtr, ttr


@pytest.fixture(scope="module")
def trainers():
    return _trainers(CFG)


@pytest.fixture(scope="module")
def self_edge_trainers():
    """The same sampler with self edges added at induction, as parse_config
    forces for gcn / gat / gatscat (hop augment on, so hops are induced)."""
    cfg = {**CFG, "sampler": [{**CFG["sampler"][0], "add_self_edge": [True]}]}
    return _trainers(cfg)


def test_synthetic_graph_identical():
    a, b = j_make(**GRAPH), t_make(**GRAPH)
    for f in ("indptr_full", "indices_full", "feat_full", "label_full"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for m in a.node_set:
        np.testing.assert_array_equal(a.node_set[m], b.node_set[m])


def test_ppr_tables_exact(trainers):
    jtr, ttr = trainers
    jt, tt = jtr.tables[TEST][0], ttr.tables[TEST][0]
    np.testing.assert_array_equal(tt.neighs.numpy(), np.asarray(jt.neighs))
    np.testing.assert_array_equal(tt.scores.numpy(), np.asarray(jt.scores))


def test_ppr_push_python_matches_jax():
    """The pure-Python push (use_native=False) of both packages."""
    from shadow_gnn_tpu.sampling.ppr import ppr_push_host as j_push
    g = t_make(**GRAPH)
    tgt = g.node_set[TEST][:6]
    jn, js = j_push(g.indptr_full, g.indices_full, tgt, 16, 0.85, 1e-4,
                    use_native=False)
    tn, ts = tppr.ppr_push_host(g.indptr_full, g.indices_full, tgt, 16, 0.85,
                                1e-4, use_native=False)
    for a, b in zip(jn + js, tn + ts):
        np.testing.assert_array_equal(a, b)


def test_plan_ppr_induction_fields(trainers):
    jtr, ttr = trainers
    jc, tc = jtr.branches[0]["cfg"][TEST], ttr.branches[0]["cfg"][TEST]
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.induction == "rows" and tc.hub_slots == 0 and tc.n_pad == 24


def _roots(jtr, n=40):
    ent = np.asarray(jtr.entity_set[TEST])
    rows = np.r_[np.arange(n), [0, 3]]           # repeated roots too
    return ent[rows][:, None], rows[:, None]


def test_sample_nodes_ppr_and_induce_exact(trainers):
    jtr, ttr = trainers
    roots, rows = _roots(jtr)
    jc = jtr.branches[0]["cfg"][TEST]
    tc = ttr.branches[0]["cfg"][TEST]
    jn, js = j_sample(jc, jtr.graph[TEST], jnp.asarray(roots, jnp.int32),
                      jnp.asarray(rows, jnp.int32), jtr.tables[TEST][0])
    tr_, trw = torch.as_tensor(roots), torch.as_tensor(rows)
    tn, ts = t_sample(tc, ttr.graph[TEST], tr_, trw, ttr.tables[TEST][0])
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jb = j_induce(jtr.graph[TEST], jn, js, jnp.asarray(roots, jnp.int32), jc)
    tb = t_induce(ttr.graph[TEST], tn, ts, tr_, tc)
    for f in ("adj", "targets", "hop", "node_mask", "size", "ppr"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert tb.overflow == int(jb.overflow) == 0
    assert tb.adj.sum() > 0 and (tb.hop.numpy() > 0).any()


def test_self_edge_induction_and_cache_exact(self_edge_trainers):
    """add_self_edge=True: adjacency (a 1 on every valid diagonal entry),
    hops and the packed cache byte-equal to JAX."""
    jtr, ttr = self_edge_trainers
    assert ttr.branches[0]["cfg"][TEST].add_self_edge
    roots, rows = _roots(jtr)
    jc, tc = jtr.branches[0]["cfg"][TEST], ttr.branches[0]["cfg"][TEST]
    jn, js = j_sample(jc, jtr.graph[TEST], jnp.asarray(roots, jnp.int32),
                      jnp.asarray(rows, jnp.int32), jtr.tables[TEST][0])
    tr_ = torch.as_tensor(roots)
    tn, ts = t_sample(tc, ttr.graph[TEST], tr_, torch.as_tensor(rows),
                      ttr.tables[TEST][0])
    jb = j_induce(jtr.graph[TEST], jn, js, jnp.asarray(roots, jnp.int32), jc)
    tb = t_induce(ttr.graph[TEST], tn, ts, tr_, tc)
    for f in ("adj", "targets", "hop", "node_mask", "size"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    diag = torch.diagonal(tb.adj, dim1=1, dim2=2)
    assert torch.equal(diag, tb.node_mask.float())
    jcache, tcache_ = jtr.caches[TEST][0], ttr.caches[TEST][0]
    for f in dataclasses.fields(tcache_):
        np.testing.assert_array_equal(getattr(tcache_, f.name).numpy(),
                                      np.asarray(getattr(jcache, f.name)),
                                      err_msg=f.name)


def test_cache_arrays_exact(trainers):
    jtr, ttr = trainers
    jc, tc = jtr.caches[TEST][0], ttr.caches[TEST][0]
    for f in dataclasses.fields(tc):
        got = getattr(tc, f.name).numpy()
        want = np.asarray(getattr(jc, f.name))
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


@pytest.mark.parametrize("unpack", [True, False])
def test_gather_batch_exact(trainers, unpack):
    jtr, ttr = trainers
    rows = np.array([5, 0, 17, 5, 63, 1])
    n_pad = ttr.branches[0]["cfg"][TEST].n_pad
    jb = jcache.gather_batch(jtr.caches[TEST][0], jnp.asarray(rows), n_pad,
                             jtr.num_nodes, unpack=unpack)
    tb = tcache.gather_batch(ttr.caches[TEST][0], torch.as_tensor(rows), n_pad,
                             ttr.num_nodes, unpack=unpack)
    fields = ["nodes", "node_mask", "targets", "size", "hop", "ppr", "drnl",
              "adj_bits"] + (["adj"] if unpack else [])
    for f in fields:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert unpack or tb.adj is None


def test_trainer_reuses_its_ppr_cache(trainers, tmp_path, monkeypatch):
    """A Trainer with a data directory writes the PPR bin cache; the next
    one reads it back instead of pushing, and gets the same tables."""
    _, ttr = trainers
    first = TTrainer("toy", str(tmp_path), t_make(**GRAPH), t_parse(CFG),
                     seed=0, device="cpu")
    first._ensure_tables(TEST)
    assert len(list((tmp_path / "toy" / "ppr_float").iterdir())) == 2

    def no_push(*args, **kwargs):
        raise AssertionError("the cached PPR lists were not reused")
    monkeypatch.setattr(tppr, "ppr_push_host", no_push)
    second = TTrainer("toy", str(tmp_path), t_make(**GRAPH), t_parse(CFG),
                      seed=0, device="cpu")
    second._ensure_tables(TEST)
    for tr in (first, second):
        np.testing.assert_array_equal(tr.tables[TEST][0].neighs.numpy(),
                                      ttr.tables[TEST][0].neighs.numpy())
        np.testing.assert_array_equal(tr.tables[TEST][0].scores.numpy(),
                                      ttr.tables[TEST][0].scores.numpy())


def test_ppr_bin_cache_roundtrip(tmp_path):
    """Tables written by the JAX package are read back by the port."""
    from shadow_gnn_tpu.sampling import ppr as jppr
    g = t_make(**GRAPH)
    tgt = g.node_set[TRAIN][:20]
    n, s = tppr.ppr_push_host(g.indptr_full, g.indices_full, tgt, 16, 0.85, 1e-5)
    fn, fs = jppr.ppr_cache_paths(str(tmp_path), "toy", True, "train", 0.85,
                                  1e-5, 16)
    jppr.write_ppr_cache(fn, fs, 600, tgt, n, s, 16, 0.85, 1e-5)
    assert tppr.find_ppr_cache(str(tmp_path), "toy", True, "train", 0.85,
                               1e-5, 8) == (fn, fs)
    nv, sv = tppr.read_ppr_cache(fn, fs, 16, 0.85, 1e-5)
    for i, t in enumerate(tgt):
        np.testing.assert_array_equal(nv[t], n[i])
        np.testing.assert_array_equal(sv[t], s[i])
